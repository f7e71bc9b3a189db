"""AnyLoc in the port held against the JAX package on the CPU
(``agplace_tpu_torch/models/anyloc.py``): each extractor's facets at two
blocks of width 64 (JAX's tree from ``jax.eval_shape`` of its init, filled
from a numpy seed, through the weight bridge), the MAE helpers and the
positional-embedding resizes, VLAD in its four modes from a shared k-means
start, and the recall utility.

Tolerances, fractions of max |JAX|: extractor outputs 1e-5 (fp32 in both,
different summation orders; measured <= 6.2e-7); resized embeddings
2e-6 (JAX's weight matrices exactly, contracted in another order;
measured <= 4.2e-7); k-means centres 1e-6 (measured 1.2e-7); VLAD
vectors 1e-6 absolute on unit vectors (measured <= 2.7e-7); search
indices exactly, distances 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agplace_tpu.models import anyloc as ja
from agplace_tpu_torch.models import anyloc as pa
from agplace_tpu_torch.utils.convert import load_jax_variables
from test_torch_port_mm_options import random_variables

torch.set_num_threads(2)

FEAT_TOL, POS_TOL, VLAD_TOL = 1e-5, 2e-6, 1e-6


def close(got, want, tol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, err)


def images(seed, b=2, size=32):
    return np.random.default_rng(seed).standard_normal(
        (b, size, size, 3)).astype(np.float32)


def run_both(jmod, pmod, x, seed=0):
    v = random_variables(jmod, np.random.default_rng(seed), x)
    want = jax.jit(jmod.apply)(v, x)
    load_jax_variables(pmod, v)
    with torch.no_grad():
        got = pmod.eval()(torch.from_numpy(x))
    return got.numpy(), np.asarray(want)


VIT = dict(hidden=64, depth=2, heads=4, patch=8)


@pytest.mark.parametrize("facet", ["query", "key", "value", "token",
                                   "attn"])
@pytest.mark.parametrize("layer,stride", [(0, 8), (1, 4), (5, 8)],
                         ids=["layer0", "layer1-stride4", "past-depth"])
def test_vit_extractor_facets_match_jax(facet, layer, stride):
    kw = dict(VIT, stride=stride, layer=layer, facet=facet)
    got, want = run_both(ja.ViTExtractor(**kw), pa.ViTExtractor(**kw),
                         images(1))
    close(got, want, FEAT_TOL, facet)


@pytest.mark.parametrize("facet", ["value", "token"])
def test_dinov2_extractor_matches_jax(facet):
    kw = dict(hidden=64, depth=2, heads=4, patch=14, layer=1, facet=facet)
    got, want = run_both(ja.DinoV2ExtractFeatures(**kw),
                         pa.DinoV2ExtractFeatures(**kw), images(2, 2, 28))
    close(got, want, FEAT_TOL, facet)


@pytest.mark.parametrize("facet,use_cls,norm", [
    ("token", False, True), ("query", False, True), ("key", True, True),
    ("value", False, False)])
def test_cosplace_extractor_matches_jax(facet, use_cls, norm):
    kw = dict(hidden=64, heads=4, patch=8, layer=1, facet=facet,
              use_cls=use_cls, norm_descs=norm)
    got, want = run_both(ja.CosPlaceViTExtractFeatures(**kw),
                         pa.CosPlaceViTExtractFeatures((32, 32), **kw),
                         images(3))
    close(got, want, FEAT_TOL, facet)


def test_mae_sincos_helpers_equal_jax():
    pos = np.array([0.0, 1.0, 3.5])
    np.testing.assert_array_equal(
        pa.get_1d_sincos_pos_embed_from_grid(8, pos),
        ja.get_1d_sincos_pos_embed_from_grid(8, pos))
    for cls in (False, True):
        np.testing.assert_array_equal(pa.get_2d_sincos_pos_embed(16, 5, cls),
                                      ja.get_2d_sincos_pos_embed(16, 5, cls))


@pytest.mark.parametrize("n_old,n_new", [(16, 16), (16, 64), (196, 256),
                                         (256, 49), (64, 4)],
                         ids=["same", "grow-4to8", "grow-14to16",
                              "shrink-16to7", "shrink-8to2"])
def test_interpolate_pos_embed_matches_jax(n_old, n_new):
    pos = np.random.default_rng(n_old + n_new).standard_normal(
        (1, n_old + 1, 32)).astype(np.float32)
    got = pa.interpolate_pos_embed(pos, n_new)
    want = ja.interpolate_pos_embed(pos, n_new)
    close(got, want, POS_TOL)
    np.testing.assert_array_equal(got[:, :1], pos[:, :1])


@pytest.mark.parametrize("hw", [(16, 16), (5, 7), (40, 40)],
                         ids=["same", "shrink", "grow"])
def test_vit_pos_resize_matches_jax(hw):
    """The extractor's bilinear resize of its 28 x 28 table."""
    grid = np.random.default_rng(0).standard_normal(
        (1, 28, 28, 16)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(grid), (1, *hw, 16),
                            method="bilinear")
    from agplace_tpu_torch.utils.image_resize import resize_hw

    close(resize_hw(torch.from_numpy(grid), hw, "bilinear"), want, POS_TOL)


# -------------------------------------------------------------------- VLAD
def _descs(seed, n_items=6, n=40, d=24):
    """Items of descriptors around 5 shared centres.  (With more clusters
    than centres k-means may give a cluster all of whose members lie in
    one item; that item's residual sum for it is zero in exact arithmetic
    and its intra-normalised direction is rounding noise in both
    packages, so the fits below take 5 or fewer clusters.)"""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((5, d)) * 3
    return [(centers[rng.integers(0, 5, n)] + rng.standard_normal((n, d))
             ).astype(np.float32) for _ in range(n_items)]


def _jax_init_idx(n, k, seed=0):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n,
                                        shape=(k,), replace=False))


@pytest.mark.parametrize("vlad_mode", ["hard", "soft"])
@pytest.mark.parametrize("dist_mode", ["cosine", "euclidean"])
def test_vlad_matches_jax(vlad_mode, dist_mode, tmp_path):
    items = _descs(1)
    stacked = np.concatenate(items)
    kw = dict(num_clusters=5, dist_mode=dist_mode, vlad_mode=vlad_mode,
              soft_temp=2.0)
    ref = ja.VLAD(**kw).fit(stacked, seed=0)
    ours = pa.VLAD(**kw, cache_dir=str(tmp_path), device="cpu").fit(
        stacked, init_idx=_jax_init_idx(len(stacked), 5))
    close(ours.c_centers, ref.c_centers, VLAD_TOL, "centers")
    np.testing.assert_allclose(ours.generate_multi(items).numpy(),
                               ref.generate_multi(items), atol=VLAD_TOL)
    # the cache gives the same centres back
    again = pa.VLAD(**kw, cache_dir=str(tmp_path), device="cpu").fit(None)
    assert torch.equal(again.c_centers, ours.c_centers)


def test_vlad_quirks_and_options():
    """Hard labels from the raw descriptors, the soft branch's (q c) d
    sum, and intra_norm / norm_descs off, each against JAX on JAX's
    centres."""
    items = _descs(2)
    for kw in (dict(norm_descs=False, dist_mode="euclidean"),
               dict(intra_norm=False), dict(vlad_mode="soft",
                                            norm_descs=False)):
        ref = ja.VLAD(num_clusters=4, **kw).fit(np.concatenate(items))
        ours = pa.VLAD(num_clusters=4, device="cpu", **kw)
        ours.c_centers = torch.from_numpy(np.asarray(ref.c_centers))
        np.testing.assert_allclose(ours.generate_multi(items).numpy(),
                                   ref.generate_multi(items),
                                   atol=VLAD_TOL, err_msg=str(kw))
    with pytest.raises(ValueError, match="no cache"):
        pa.VLAD(4, device="cpu").fit(None)


@pytest.mark.parametrize("method", ["cosine", "l2"])
def test_get_top_k_recall_matches_jax(method):
    rng = np.random.default_rng(4)
    db = rng.standard_normal((30, 16)).astype(np.float32)
    db[7] = db[3]  # a tie: lowest index first in both
    qu = (db[[3, 10, 20, 25]] + 0.01 * rng.standard_normal((4, 16))
          ).astype(np.float32)
    gt = [np.array([3]), np.array([10]), np.array([5]), np.array([25, 1])]
    d0, i0, r0 = pa.get_top_k_recall([1, 2, 5], torch.from_numpy(db),
                                     torch.from_numpy(qu), gt, method)
    d1, i1, r1 = ja.get_top_k_recall([1, 2, 5], db, qu, gt, method)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-5, atol=1e-5)
    assert r0 == r1 and r0[1] == 0.75
