"""The port's aggregation heads, RMAC geometry, NetVLAD's k-means init and
the k-means solver held against the JAX package on the CPU.

Every ``GlobalHead`` aggregation runs on [2, 7, 9, C] maps (odd sides:
CRN's ceil-mode pool and its bilinear upsample meet their edge cases) with
the same random weights in both packages.  Tolerance: fp32, max |diff| <=
1e-4 of max |JAX| (measured <= 4.9e-7 on these maps).  k-means runs from the
same initial rows (JAX's ``jax.random.choice`` draw, passed to the port):
centroids within 1e-5 of their scale, assignments equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agplace_tpu.models import pooling as jp
from agplace_tpu.retrieval.kmeans import kmeans as jax_kmeans
from agplace_tpu_torch.models import pooling as tp
from agplace_tpu_torch.retrieval.kmeans import kmeans
from agplace_tpu_torch.utils.convert import load_jax_variables
from test_torch_port_mm_options import random_variables

torch.set_num_threads(1)

TOL = 1e-4
AGGS = ("gem", "spoc", "mac", "rmac", "convap", "cosplace", "mixvpr", "rrm",
        "netvlad", "crn")


def close(got, want, frac=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (what, err, np.abs(want).max())
    return err / np.abs(want).max()


@pytest.mark.parametrize("agg", AGGS)
@pytest.mark.parametrize("hw", [(7, 9), (8, 8)])
def test_global_head_matches_jax(agg, hw):
    rng = np.random.default_rng(AGGS.index(agg))
    c, k = 16, 4
    x = rng.standard_normal((2, *hw, c)).astype(np.float32)
    if agg == "gem":
        x = np.abs(x)  # GeM's power of a clamped map
    head = jp.GlobalHead(agg, c, k)
    v = random_variables(head, rng, x)
    want = head.apply(v, x)
    port = load_jax_variables(tp.GlobalHead(agg, c, k, hw=hw[0] * hw[1]),
                              v)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    close(got.numpy(), want, what=agg)


@pytest.mark.parametrize("h,w", [(7, 9), (9, 7), (8, 8), (16, 60), (3, 5),
                                 (1, 1)])
def test_rmac_regions_equal(h, w):
    assert tp.rmac_regions(h, w) == jp.rmac_regions(h, w)


def test_netvlad_init_from_kmeans_matches_jax():
    rng = np.random.default_rng(3)
    cent = rng.standard_normal((6, 12)).astype(np.float32)
    descs = rng.standard_normal((50, 12)).astype(np.float32)
    descs /= np.linalg.norm(descs, axis=1, keepdims=True)
    want = jp.NetVLAD.init_from_kmeans({}, cent, descriptors=descs)
    got = tp.NetVLAD.init_from_kmeans({}, cent, descriptors=descs)
    for key in ("centroids", "assign_w"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, atol=1e-6)
    pinned = tp.NetVLAD.init_from_kmeans({}, cent, alpha=2.0)
    np.testing.assert_allclose(
        pinned["assign_w"].numpy(),
        np.asarray(jp.NetVLAD.init_from_kmeans({}, cent, alpha=2.0)[
            "assign_w"]), rtol=1e-6)
    with pytest.raises(ValueError):
        tp.NetVLAD.init_from_kmeans({}, cent)


@pytest.mark.parametrize("n,d,k", [(300, 8, 5), (64, 32, 16)])
def test_kmeans_matches_jax_from_the_same_start(n, d, k):
    rng = np.random.default_rng(n)
    # clustered points, plus exact duplicates so argmin meets ties
    centres = rng.standard_normal((k, d)) * 3.0
    pts = (centres[rng.integers(0, k, n)]
           + rng.standard_normal((n, d))).astype(np.float32)
    pts[-4:] = pts[:4]
    key = jax.random.PRNGKey(7)
    init_idx = np.asarray(jax.random.choice(key, n, shape=(k,),
                                            replace=False))
    want_c, want_a = jax_kmeans(key, jnp.asarray(pts), k)
    got_c, got_a = kmeans(torch.from_numpy(pts), k,
                          init_idx=torch.from_numpy(init_idx.copy()))
    close(got_c.numpy(), want_c, frac=1e-5)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_kmeans_keeps_an_empty_cluster_in_place():
    pts = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0],
                        [0.0, 0.1], [5.0, 5.0]])
    # rows 2 and 5 are equal: in the first iteration every point ties
    # between their clusters, argmin takes the first, and the second
    # keeps its centroid
    init = torch.tensor([0, 2, 5])
    c, _ = kmeans(pts, 3, n_iter=1, init_idx=init)
    assert torch.equal(c[2], pts[5])
    torch.testing.assert_close(c[1], pts[[2, 3, 5]].mean(dim=0))
    # a seeded draw is reproducible
    g = [kmeans(pts, 3, generator=torch.Generator().manual_seed(1))[0]
         for _ in range(2)]
    assert torch.equal(g[0], g[1])
