"""The port's evaluation path held against the JAX package on the CPU:
exact L2 / inner-product top-k (tie order included), Recall@N and the crop
merges, the radius ground truth, PCA, the dataset interface and the
synthetic dataset, DBVanilla2D's 6-D entry, the batched embed passes, the
serving additions, and ``evaluate`` end to end for every test method.

Inputs are made with numpy from a seed and fed to both packages; the
weights are the JAX package's flax variables carried across with
``utils.convert.load_jax_variables``.  Sizes are small:
``synthetic_config()`` (64 px images, a 32 x 32 x 16 grid, batch 4).
"""

import dataclasses
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agplace_tpu import config as jax_config
from agplace_tpu import embed as jax_embed
from agplace_tpu import evaluate as jax_evaluate
from agplace_tpu.data import base as jax_base
from agplace_tpu.data.synthetic import SyntheticDataset as JaxSynthetic
from agplace_tpu.retrieval import knn as jax_knn
from agplace_tpu.retrieval import recall as jax_recall
from agplace_tpu.serving import PlaceIndex as JaxIndex
from agplace_tpu.train.step import build_models, make_infer_fns as jax_fns
from agplace_tpu.utils import pca as jax_pca
from agplace_tpu_torch import config, embed, evaluate
from agplace_tpu_torch.data import base
from agplace_tpu_torch.data.synthetic import SyntheticDataset
from agplace_tpu_torch.infer import build_towers, make_infer_fns
from agplace_tpu_torch.retrieval import knn, recall
from agplace_tpu_torch.serving import PlaceIndex
from agplace_tpu_torch.utils import pca
from agplace_tpu_torch.utils.convert import load_jax_variables

torch.set_num_threads(1)

# Descriptor tolerances, as fractions of the largest magnitude (the slice
# tests' bounds, tests/test_torch_port_slice.py): fp32 query descriptors
# carry the BEV convs' bf16 rounding flips (<= 3e-3 measured there); the
# aerial tower is fp32 throughout; bf16 flips run through ~30 layers.
TOL_Q_FP32, TOL_DB_FP32, TOL_BF16 = 1e-2, 1e-4, 2e-2
# distances of the same top-k from two fp32 matmuls (summation order)
D_RTOL, D_ATOL = 1e-5, 1e-4


def _close(got, want, frac, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (what, err, np.abs(want).max())


# ---------------------------------------------------------------- top-k

def _tied_gallery(seed=0):
    """A gallery holding each of 40 rows three times (the third copy in
    reverse order), and queries: 8 noisy copies of gallery rows, then 4
    exact copies."""
    rng = np.random.default_rng(seed)
    base_rows = rng.standard_normal((40, 64)).astype(np.float32)
    gallery = np.concatenate([base_rows, base_rows, base_rows[::-1]])
    noisy = base_rows[rng.integers(0, 40, 8)] + 0.01 * rng.standard_normal(
        (8, 64)).astype(np.float32)
    return np.concatenate([noisy, base_rows[:4]]), gallery


@pytest.mark.parametrize("k", [1, 2, 20, 119, 120, 130])
@pytest.mark.parametrize("fn", ["l2_topk", "ip_topk"])
def test_topk_orders_ties_as_jax(fn, k):
    """Duplicate gallery rows tie exactly: lowest index first, as
    ``lax.top_k`` gives them, also where a tie straddles the k-th place
    (k = 1, 2, 20, 119) and with k > N padding (130)."""
    q, g = _tied_gallery()
    d, i = getattr(knn, fn)(torch.from_numpy(q), torch.from_numpy(g), k)
    d_ref, i_ref = getattr(jax_knn, fn)(jnp.asarray(q), jnp.asarray(g), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=D_RTOL,
                               atol=D_ATOL)
    assert i.dtype == torch.int64 and d.dtype == torch.float32


def _integer_world(seed=1):
    """Small-integer rows: every distance and product is an exact integer
    in fp32 whatever the summation order, so ties are exact by
    construction.  Returns (queries, gallery, exact sq distances, exact
    inner products)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-2, 3, (60, 8)).astype(np.float32)
    q = np.concatenate([rng.integers(-2, 3, (6, 8)), g[[3, 3, 17]]]).astype(
        np.float32)
    qi, gi = q.astype(np.int64), g.astype(np.int64)
    d2 = ((qi[:, None] - gi[None]) ** 2).sum(-1)
    return q, g, d2, qi @ gi.T


@pytest.mark.parametrize("k", [5, 60, 64])
def test_topk_ties_lowest_index_first_against_exact_order(k):
    q, g, d2, ip = _integer_world()
    cols = np.arange(g.shape[0])
    want_l2 = np.stack([np.lexsort((cols, r)) for r in d2])[:, :k]
    want_ip = np.stack([np.lexsort((cols, -r)) for r in ip])[:, :k]
    d, i = knn.l2_topk(torch.from_numpy(q), torch.from_numpy(g), k)
    s, j = knn.ip_topk(torch.from_numpy(q), torch.from_numpy(g), k)
    kk = min(k, g.shape[0])
    np.testing.assert_array_equal(i.numpy()[:, :kk], want_l2[:, :kk])
    np.testing.assert_array_equal(j.numpy()[:, :kk], want_ip[:, :kk])
    np.testing.assert_array_equal(
        d.numpy()[:, :kk], np.take_along_axis(d2, want_l2, 1)[:, :kk])
    np.testing.assert_array_equal(
        s.numpy()[:, :kk], np.take_along_axis(ip, want_ip, 1)[:, :kk])
    assert (i.numpy()[:, kk:] == -1).all()
    assert np.isinf(d.numpy()[:, kk:]).all()
    assert (j.numpy()[:, kk:] == -1).all()
    assert (s.numpy()[:, kk:] == -np.inf).all()


def test_topk_counts_negative_zero_as_zero():
    """-0.0 and +0.0 tie: the lower index first."""
    vals = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0]])
    _, idx = knn._ascending_topk(vals, 5)
    assert idx.tolist() == [[0, 1, 3, 4, 2]]
    _, idx = knn._ascending_topk(torch.tensor([[-1.0, -2.0, 3.0, -2.0]]), 4)
    assert idx.tolist() == [[1, 3, 0, 2]]


@pytest.mark.parametrize("k", [1, 5, 12, 49, 50])
@pytest.mark.parametrize("scale", [1e-40, 1.0, 1e30])
def test_ascending_topk_orders_and_returns_values_bit_for_bit(scale, k):
    """Against numpy's stable argsort, the values bit for bit: both signs,
    denormals (scale 1e-40), +-inf, -0.0 (as +0.0), ties inside the k,
    ties straddling the k-th place in some rows (row 1 is one value
    throughout; rows 3 and 4 hold 8 and up to 25 distinct values) and not
    in others, and k = N."""
    rng = np.random.default_rng(7)
    v = (rng.standard_normal((6, 50)) * scale).astype(np.float32)
    v[:, :4] = [np.inf, -np.inf, -0.0, 0.0]
    v[:, 10:14] = v[:, 20:24]
    v[1] = np.float32(scale)
    v[3] = v[3, rng.integers(0, 8, 50)]
    v[4] = v[4, rng.integers(0, 25, 50)]
    v = v + np.float32(0.0)  # -0.0 -> +0.0, as the port counts it
    want_idx = np.argsort(v, axis=1, kind="stable")[:, :k]
    vals, idx = knn._ascending_topk(torch.from_numpy(v.copy()), k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    want = np.take_along_axis(v, want_idx, 1)
    np.testing.assert_array_equal(vals.numpy().view(np.int32),
                                  want.view(np.int32))


def test_pairwise_l2_matches_jax():
    q, g = _tied_gallery(2)
    got = knn.pairwise_l2(torch.from_numpy(q), torch.from_numpy(g)).numpy()
    want = np.asarray(jax_knn.pairwise_l2(jnp.asarray(q), jnp.asarray(g)))
    # compared squared: the expanded form cancels near zero, where the
    # root magnifies a summation-order difference of the squares
    np.testing.assert_allclose(got ** 2, want ** 2, rtol=D_RTOL, atol=D_ATOL)
    # exact integers: bit-equal, and zero at the exact copies (rows 6-8)
    q, g, d2, _ = _integer_world()
    got = knn.pairwise_l2(torch.from_numpy(q), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(d2).astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(jax_knn.pairwise_l2(
        jnp.asarray(q), jnp.asarray(g))))
    assert got[6, 3] == got[7, 3] == got[8, 17] == 0.0


@pytest.mark.parametrize("radius,block", [(25.0, 4096), (10.0, 7),
                                          (0.0, 3)])
def test_radius_neighbors_equal_jax(radius, block):
    rng = np.random.default_rng(3)
    a = 500000.0 + rng.uniform(0, 200, (23, 2))
    b = 500000.0 + rng.uniform(0, 200, (40, 2))
    b[5] = a[2]  # a point exactly on a query: radius 0 still finds it
    got = knn.radius_neighbors(a, b, radius, block=block)
    want = jax_knn.radius_neighbors(a, b, radius, block=block)
    assert len(got) == len(want) == 23
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    assert 5 in got[2]


# ---------------------------------------------------------- recall and merges

def _ragged_predictions(rng, nq, k, n_db=12):
    """Predictions over a small gallery (repeats across crops), -1 padding
    in some rows, and distances on a coarse grid (ties)."""
    preds = rng.integers(0, n_db, (nq, k)).astype(np.int64)
    preds[rng.random((nq, k)) < 0.1] = -1
    dists = (rng.integers(0, 6, (nq, k)) / 4.0).astype(np.float32)
    return dists, preds


@pytest.mark.parametrize("seed", [0, 1])
def test_compute_recalls_equals_jax(seed):
    rng = np.random.default_rng(seed)
    _, preds = _ragged_predictions(rng, 30, 20)
    positives = [rng.choice(12, rng.integers(0, 4), replace=False)
                 for _ in range(30)]
    positives[0] = np.array([-1])  # a -1 positive matches -1 padding
    for values in ((1, 5, 10, 20), (2, 3), (20,)):
        got = recall.compute_recalls(preds, positives, values)
        want = jax_recall.compute_recalls(preds, positives, values)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert recall.compute_recalls(preds[:0], [], (1,))[0].tolist() == [0.0]


@pytest.mark.parametrize("keep", [20, 7])
def test_dedup_nearest_crop_equals_jax(keep):
    rng = np.random.default_rng(4)
    d, p = _ragged_predictions(rng, 9, 5 * keep, n_db=3 * keep)
    np.testing.assert_array_equal(recall.dedup_nearest_crop(d, p, keep),
                                  jax_recall.dedup_nearest_crop(d, p, keep))


@pytest.mark.parametrize("topn", ["top1", "top5", "top10"])
def test_top_n_voting_edits_distances_in_place_as_jax(topn):
    rng = np.random.default_rng(5)
    d, p = _ragged_predictions(rng, 5, 20, n_db=6)
    got_d, want_d = d.copy(), d.copy()
    assert recall.top_n_voting(topn, p, got_d, 0.01) is None
    jax_recall.top_n_voting(topn, p, want_d, 0.01)
    np.testing.assert_array_equal(got_d, want_d)
    assert (got_d != d).any()  # the boost wrote through the view
    with pytest.raises(ValueError):
        recall.top_n_voting("top3", p, got_d, 0.01)


def test_maj_voting_merge_equals_jax():
    rng = np.random.default_rng(6)
    d, p = _ragged_predictions(rng, 8, 100, n_db=30)
    d, p = d.reshape(8, 5, 20), p.reshape(8, 5, 20)
    got_d, want_d = d.copy(), d.copy()
    got = recall.maj_voting_merge(got_d, p.copy(), 0.05)
    want = jax_recall.maj_voting_merge(want_d, p.copy(), 0.05)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_d, want_d)  # the in-place boosts


# ------------------------------------------------------------------- PCA

@pytest.mark.parametrize("whiten", [False, True])
def test_pca_equals_jax(whiten):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    y = rng.standard_normal((9, 16)).astype(np.float32)
    got = pca.PCA(6, whiten=whiten).fit(x)
    want = jax_pca.PCA(6, whiten=whiten).fit(x)
    np.testing.assert_allclose(got.transform(y), want.transform(y),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.fit_transform(x), want.fit_transform(x),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        pca.PCA(17).fit(x)


def test_compute_pca_and_reduce_pca_equal_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((80, 12)).astype(np.float32)
    for n in (50, 2 ** 14):  # a sample of 50 rows, then every row
        got = pca.compute_pca(x, 5, num_samples=n, seed=3)
        want = jax_pca.compute_pca(x, 5, num_samples=n, seed=3)
        np.testing.assert_allclose(got.mean_, want.mean_, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got.transform(x), want.transform(x),
                                   rtol=1e-6, atol=1e-6)
    for a, b in zip(pca.reduce_pca(x[:60], x[60:], 4),
                    jax_pca.reduce_pca(x[:60], x[60:], 4)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- datasets, collates

@pytest.mark.parametrize("kw", [
    dict(),
    dict(n_db=30, n_q=11, image_size=40, nmap=2, n_points=100, seed=3),
    dict(n_db=5, n_q=7, grid_step=12.0, val_thresh=30.0, train_thresh=4.0,
         seed=9),
])
def test_synthetic_dataset_equals_jax_bit_for_bit(kw):
    ours, ref = SyntheticDataset(**kw), JaxSynthetic(**kw)
    for f in ("db_eastnorth", "q_eastnorth"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    assert (ours.database_num, ours.queries_num) == (ref.database_num,
                                                     ref.queries_num)
    for f in ("soft_positives_per_query", "hard_positives_per_query"):
        for x, y in zip(getattr(ours, f), getattr(ref, f), strict=True):
            np.testing.assert_array_equal(x, y)
    for i in (0, ours.queries_num - 1):
        np.testing.assert_array_equal(ours.load_query_image(i),
                                      ref.load_query_image(i))
        np.testing.assert_array_equal(ours.load_query_points(i),
                                      ref.load_query_points(i))
    for i in (0, ours.database_num - 1):
        np.testing.assert_array_equal(ours.load_db_maps(i),
                                      ref.load_db_maps(i))


def _port_cfg(**eval_kw):
    cfg = config.synthetic_config()
    return cfg.replace(eval=dataclasses.replace(cfg.eval, **eval_kw))


def _jax_cfg(cfg):
    """The JAX package's Config with the same fields as the port's."""
    ref = jax_config.synthetic_config()
    return ref.replace(
        model=dataclasses.replace(
            ref.model, compute_dtype=cfg.model.compute_dtype),
        eval=dataclasses.replace(ref.eval, **dataclasses.asdict(cfg.eval)))


def test_collates_equal_jax():
    cfg = _port_cfg()
    ds = SyntheticDataset(n_db=6, n_q=5, n_points=300, nmap=2)
    idx = [4, 0, 0, 2]
    np.testing.assert_array_equal(base.collate_cache_db(ds, idx),
                                  jax_base.collate_cache_db(ds, idx))
    images, vox = base.collate_cache_q(ds, idx, cfg, "cpu")
    images_j, vox_j = jax_base.collate_cache_q(ds, idx, _jax_cfg(cfg))
    np.testing.assert_array_equal(images, images_j)
    np.testing.assert_array_equal(vox.mask.numpy(), np.asarray(vox_j.mask))
    np.testing.assert_array_equal(vox.feats.numpy(), np.asarray(vox_j.feats))
    assert vox.mask.any()


@pytest.mark.parametrize("pad_to", [None, 2, 9])
def test_pad_positives_equals_jax(pad_to):
    pos = [np.array([3, 1, 4]), np.array([], np.int64), np.array([7]),
           np.arange(5)]
    got, want = base.pad_positives(pos, pad_to), jax_base.pad_positives(
        pos, pad_to)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    for x, y in zip(base.pad_positives([]), jax_base.pad_positives([])):
        np.testing.assert_array_equal(x, y)


# -------------------------------------------------------- the two towers

class CropDataset(SyntheticDataset):
    """The synthetic world with five crops per query: the query image and
    four shifts of it (wrapped), each with the query's point cloud."""

    SHIFTS = ((0, 0), (3, 0), (0, 3), (-3, 0), (0, -3))

    def load_query_crops(self, idx, crop):
        img = self.load_query_image(idx)
        assert img.shape[:2] == (crop, crop)
        return np.stack([np.roll(img, s, axis=(0, 1)) for s in self.SHIFTS])


class RaggedDataset(SyntheticDataset):
    """Query images of several shapes (single_query past its cap)."""

    SHAPES = ((64, 64), (72, 56), (48, 80), (64, 64), (90, 100), (60, 64),
              (40, 40), (64, 64))

    def load_query_image(self, idx):
        h, w = self.SHAPES[idx % len(self.SHAPES)]
        rng = np.random.default_rng(100 + idx)
        return rng.standard_normal((h, w, 3)).astype(np.float32)


def _randomize(variables, rng):
    """Non-trivial BN affines and running statistics, numpy leaves."""
    def rec(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = rec(v)
                continue
            a = np.asarray(v, np.float32)
            if k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, a.shape)
            elif k in ("bias", "mean"):
                a = rng.normal(0.0, 0.1, a.shape)
            out[k] = a.astype(np.float32)
        return out
    return {c: rec(variables[c]) for c in variables}


def _world(dtype):
    """Both packages' towers with one set of random weights, on
    ``synthetic_config()`` in ``dtype``: (port cfg, JAX cfg, (params,
    batch_stats), JAX closures, port towers)."""
    cfg = config.synthetic_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype=dtype))
    cfg_j = _jax_cfg(cfg)
    ds = SyntheticDataset(n_db=2, n_q=2, n_points=300)
    rng = np.random.default_rng(0)
    images, vox = jax_base.collate_cache_q(ds, [0, 1], cfg_j)
    mm_j, db_j = build_models(cfg_j, train=False)
    v_mm = _randomize(jax.jit(mm_j.init)(jax.random.PRNGKey(0), images, vox),
                      rng)
    v_db = _randomize(jax.jit(db_j.init)(
        jax.random.PRNGKey(1), jax_base.collate_cache_db(ds, [0, 1])), rng)
    params = {"mm": v_mm["params"], "db": v_db["params"]}
    stats = {"mm": v_mm["batch_stats"], "db": v_db["batch_stats"]}
    mm, db = build_towers(cfg, "cpu")
    load_jax_variables(mm, v_mm)
    load_jax_variables(db, v_db)
    return cfg, cfg_j, (params, stats), jax_fns(cfg_j), (mm, db)


@pytest.fixture(scope="module")
def fp32():
    return _world("float32")


def test_dbvanilla2d_train_entry_matches_jax(fp32):
    """[B, NDB, NMAP, H, W, 3] -> [B, NDB, dim], B*NDB folded into the
    batch; each row equals the 5-D entry's."""
    cfg, cfg_j, (params, stats), _, (_, db) = fp32
    _, db_j = build_models(cfg_j, train=False)
    rng = np.random.default_rng(9)
    maps = rng.standard_normal((2, 3, 1, 64, 64, 3)).astype(np.float32)
    with torch.inference_mode():
        got = db(torch.from_numpy(maps)).numpy()
        flat = db(torch.from_numpy(maps.reshape(6, 1, 64, 64, 3))).numpy()
    want = np.asarray(db_j.apply({"params": params["db"],
                                  "batch_stats": stats["db"]}, maps))
    assert got.shape == (2, 3, cfg.model.features_dim)
    _close(got, want, TOL_DB_FP32, "6-D entry")
    np.testing.assert_allclose(got.reshape(6, -1), flat, rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        db(torch.zeros(2, 64, 64, 3))
    with pytest.raises(ValueError):
        db(torch.zeros(2, 1, 2, 64, 64, 3))  # two map types, one expected


def test_batched_embeds_match_jax_on_a_ragged_last_batch(fp32):
    """7 indices at batch 4: the last batch is padded with copies of index
    6 and trimmed; crops come out as 5 rows per query."""
    cfg, cfg_j, (params, stats), (eq_j, edb_j), towers = fp32
    eq, edb = make_infer_fns(*towers)
    ds = CropDataset(n_db=9, n_q=9, n_points=300)
    idx = [8, 1, 2, 3, 0, 5, 6]
    got = embed.batched_embed_db(ds, idx, edb, 4, "cpu")
    want = jax_embed.batched_embed_db(ds, idx, edb_j, params, stats, 4)
    assert got.shape == (7, 256) and got.dtype == np.float32
    _close(got, want, TOL_DB_FP32, "db")
    got = embed.batched_embed_q(ds, idx, eq, 4, cfg, "cpu")
    want = jax_embed.batched_embed_q(ds, idx, eq_j, params, stats, 4, cfg_j)
    assert got.shape == (7, 256)
    _close(got, want, TOL_Q_FP32, "queries")
    got = embed.batched_embed_q_crops(ds, idx[:3], eq, 2, cfg, "cpu")
    want = jax_embed.batched_embed_q_crops(ds, idx[:3], eq_j, params, stats,
                                           2, cfg_j)
    assert got.shape == (15, 256)
    _close(got, want, TOL_Q_FP32, "crops")
    # row 5q + c is crop c of query q: crop 0 is the plain query image
    plain = embed.batched_embed_q(ds, idx[:3], eq, 4, cfg, "cpu")
    np.testing.assert_allclose(got[::5], plain, rtol=1e-5, atol=1e-6)
    assert embed.batched_embed_db(ds, [], edb, 4, "cpu").shape == (0, 0)


METHODS = ["hard_resize", "central_crop", "single_query", "five_crops",
           "nearest_crop", "maj_voting"]


@pytest.mark.parametrize("method", METHODS)
def test_evaluate_recalls_equal_jax(fp32, method):
    """Recall@N of ``evaluate`` equals JAX's in fp32 with the same weights,
    for every test method (the crop methods on a dataset with
    ``load_query_crops``)."""
    cfg, _, (params, stats), (eq_j, edb_j), towers = fp32
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, test_method=method))
    ds = CropDataset(n_db=24, n_q=10, n_points=300, seed=1)
    got = evaluate.evaluate(cfg, ds, *make_infer_fns(*towers),
                            device="cpu")
    want = jax_evaluate.evaluate(_jax_cfg(cfg), ds, params, stats, eq_j,
                                 edb_j)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert got[0].shape == (4,) and (np.diff(got[0]) >= 0).all()


def test_evaluate_with_pca_dim_equals_jax(fp32):
    """``pca_dim`` with no fitted PCA: fitted on the database descriptors,
    both sides reduced to 8 dimensions."""
    cfg, _, (params, stats), (eq_j, edb_j), towers = fp32
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, pca_dim=8))
    ds = SyntheticDataset(n_db=24, n_q=10, n_points=300, seed=2)
    got = evaluate.evaluate(cfg, ds, *make_infer_fns(*towers),
                            device="cpu")
    want = jax_evaluate.evaluate(_jax_cfg(cfg), ds, params, stats, eq_j,
                                 edb_j)
    np.testing.assert_array_equal(got[0], want[0])


def test_evaluate_single_query_past_its_cap_equals_jax(fp32, caplog):
    """Cap 1: every query shape other than the first (64 x 64) is resized
    to it (shrunk, enlarged, or both), in both packages."""
    cfg, _, (params, stats), (eq_j, edb_j), towers = fp32
    cfg = cfg.replace(eval=dataclasses.replace(
        cfg.eval, test_method="single_query", max_query_shapes=1))
    cfg_j = _jax_cfg(cfg)
    ds = RaggedDataset(n_db=24, n_q=8, n_points=300, seed=3)
    with caplog.at_level(logging.WARNING):
        q, _ = evaluate.extract_features(cfg, ds, *make_infer_fns(*towers),
                                         "cpu")
    assert sum("single_query" in r.message for r in caplog.records) == 1
    q_j, _ = jax_evaluate.extract_features(cfg_j, ds, params, stats, eq_j,
                                           edb_j)
    _close(q, q_j, TOL_Q_FP32, "queries")
    got = evaluate.evaluate(cfg, ds, *make_infer_fns(*towers),
                            device="cpu")
    want = jax_evaluate.evaluate(cfg_j, ds, params, stats, eq_j, edb_j)
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("src,dst", [((300, 420), (256, 256)),
                                     ((300, 420), (512, 600)),
                                     ((300, 420), (200, 500)),
                                     ((72, 56), (64, 64))])
def test_resize_matches_jax_image_resize(src, dst):
    """Bilinear with half-pixel centres and, when shrinking, JAX's
    antialiasing filter: within 1e-4 of ``jax.image.resize``."""
    img = np.random.default_rng(10).standard_normal((*src, 3)).astype(
        np.float32)
    got = evaluate.resize_bilinear(img, dst)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (*dst, 3),
                                       method="bilinear"))
    assert got.shape == (*dst, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_single_query_embeds_only_the_kept_shapes():
    """Past ``max_query_shapes`` the tower sees only the first shapes."""
    cfg = _port_cfg(test_method="single_query", max_query_shapes=3)
    ds = RaggedDataset(n_db=2, n_q=8, n_points=300)
    seen = set()

    def embed_q(images, vox):
        seen.add(tuple(images.shape))
        return torch.zeros(images.shape[0], 8)

    q, db = evaluate.extract_features(
        cfg, ds, embed_q, lambda m: torch.zeros(m.shape[0], 8), "cpu")
    assert q.shape == (8, 8) and db.shape == (2, 8)
    assert seen == {(1, 64, 64, 3), (1, 72, 56, 3), (1, 48, 80, 3)}


def test_crop_methods_refuse_what_the_merge_cannot_do():
    cfg = _port_cfg(test_method="nearest_crop")
    ds = SyntheticDataset(n_db=4, n_q=2, n_points=300)
    fake = (lambda i, v: torch.zeros(i.shape[0], 8),
            lambda m: torch.zeros(m.shape[0], 8))
    with pytest.raises(ValueError, match="load_query_crops"):
        evaluate.extract_features(cfg, ds, *fake, "cpu")
    deep = _port_cfg(test_method="maj_voting", recall_values=(1, 25))
    with pytest.raises(ValueError, match="up to 20"):
        evaluate.evaluate_features(deep, ds, np.zeros((10, 8), np.float32),
                                   np.zeros((20, 8), np.float32),
                                   device="cpu")
    # the merge keeps 20 distinct tiles: a smaller gallery cannot fill it
    # (the JAX package fails there too, on the merge's row assignment)
    for method in ("nearest_crop", "maj_voting"):
        with pytest.raises(ValueError, match="at least 20"):
            evaluate.evaluate_features(
                cfg, ds, np.zeros((10, 8), np.float32),
                np.zeros((19, 8), np.float32), method, device="cpu")


def test_bf16_descriptors_within_tolerance_of_jax():
    cfg, cfg_j, (params, stats), (eq_j, edb_j), towers = _world("bfloat16")
    ds = SyntheticDataset(n_db=6, n_q=5, n_points=300, seed=4)
    q, db = evaluate.extract_features(cfg, ds, *make_infer_fns(*towers),
                                      "cpu")
    q_j, db_j = jax_evaluate.extract_features(cfg_j, ds, params, stats,
                                              eq_j, edb_j)
    _close(q, q_j, TOL_BF16, "queries")
    _close(db, db_j, TOL_BF16, "db")


# ------------------------------------------------------ serving additions

def _gallery(seed=11, n=30, c=16):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, c)).astype(np.float32)
    pos = 500000.0 + rng.uniform(0, 300, (n, 2))
    return g, pos, rng


def test_remove_rows_and_locate_descriptors_match_jax(tmp_path):
    g, pos, rng = _gallery()
    q = g[[4, 20, 7]] + 1e-3 * rng.standard_normal((3, 16)).astype(
        np.float32)
    ours, ref = PlaceIndex(None, device="cpu"), JaxIndex(None, None, None)
    for idx in (ours, ref):
        idx.add_descriptors(g[:10], positions=pos[:10])
        idx.add_descriptors(g[10:], positions=pos[10:])
    assert ours.remove_rows([3, 0, 3]) == ref.remove_rows([3, 0, 3]) == 28
    assert ours.remove_rows([]) == 28
    np.testing.assert_array_equal(ours._host_gallery(), ref._host_gallery())
    np.testing.assert_array_equal(ours.positions, ref.positions)
    for k in (3, 40):  # 40: -1 padding, NaN positions
        got, want = ours.locate_descriptors(q, k), ref.locate_descriptors(
            q, k)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=D_RTOL,
                                   atol=D_ATOL)
        np.testing.assert_array_equal(got[2], want[2])
    assert np.isnan(ours.locate_descriptors(q, 40)[2][:, 28:]).all()
    with pytest.raises(IndexError):
        ours.remove_rows([28])
    path = str(tmp_path / "g.npz")
    ours.save_gallery(path)
    back, back_j = PlaceIndex.from_gallery(path, device="cpu"), \
        JaxIndex.from_gallery(path)
    assert len(back) == len(back_j) == 28
    np.testing.assert_array_equal(back.locate_descriptors(q, 5)[1],
                                  back_j.locate_descriptors(q, 5)[1])
    bare = PlaceIndex(None, device="cpu")
    bare.add_descriptors(g)
    with pytest.raises(RuntimeError, match="positions"):
        bare.locate_descriptors(q, 2)


def test_add_tiles_and_locate_match_jax(fp32):
    """``add_tiles`` embeds through ``batched_embed_db``; ``locate`` on the
    same gallery returns JAX's indices and positions."""
    cfg, cfg_j, (params, stats), _, towers = fp32
    ds = SyntheticDataset(n_db=11, n_q=6, n_points=300, seed=5)
    ours, ref = PlaceIndex(cfg, towers, device="cpu"), JaxIndex(
        cfg_j, params, stats)
    assert ours.add_tiles(ds) == ref.add_tiles(ds) == 11
    _close(ours._host_gallery(), ref._host_gallery(), TOL_DB_FP32, "tiles")
    ref.remove_rows(np.arange(11))
    ref.add_descriptors(ours._host_gallery(), positions=ours.positions)
    images = np.stack([ds.load_query_image(i) for i in range(6)])
    points = np.stack([ds.load_query_points(i) for i in range(6)])
    got, want = ours.locate(images, points, 4), ref.locate(images, points, 4)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    _close(got[0], want[0], TOL_Q_FP32, "distances")
