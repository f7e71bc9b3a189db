"""The port's int8 gallery (``retrieval/knn.quantize_rows`` /
``l2_candidates_int8`` and ``PlaceIndex(quant="int8")``) held against the
JAX package's on the CPU, on seeded L2-normalised descriptors with planted
near-duplicates: the quantized rows bit-equal, the int32 cross term equal,
the candidate sets equal wherever the approximate distances leave a gap,
the searches' indices and distances bit-equal (the exact re-rank is the
same host numpy in both), the audit's counts and warning equal, and the
argument checks and lazy uploads alike."""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agplace_tpu.retrieval import knn as jax_knn
from agplace_tpu.serving import PlaceIndex as JaxIndex
from agplace_tpu_torch.retrieval import knn
from agplace_tpu_torch.serving import PlaceIndex

torch.set_num_threads(1)

N, C = 300, 256


def _gallery(seed=0, n=N, c=C, dups=40):
    """Unit rows, ``dups`` of them near-copies (1e-3 apart) of others."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, c)).astype(np.float32)
    src = rng.choice(n - dups, dups, replace=False)
    g[n - dups:] = g[src] + 1e-3 * rng.standard_normal((dups, c)).astype(
        np.float32)
    return g / np.linalg.norm(g, axis=1, keepdims=True), rng


def _queries(g, rng, nq):
    rows = rng.choice(len(g), nq)
    q = g[rows] + 0.02 * rng.standard_normal((nq, g.shape[1])).astype(
        np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def gallery_file(tmp_path_factory):
    g, _ = _gallery()
    path = str(tmp_path_factory.mktemp("int8") / "g.npz")
    np.savez_compressed(path, feats=g, version=np.int64(1))
    return path, g


def test_quantize_rows_bit_equal():
    g, rng = _gallery(1)
    g[3] = 0.0  # the 1e-12 floor of an all-zero row
    g[4] *= 1e3
    for got, want in zip(knn.quantize_rows(g), jax_knn.quantize_rows(g)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _jax_cross(q, db_i8):
    """JAX's ``l2_candidates_int8`` query quantization and int32 cross
    term, step for step."""
    q = jnp.asarray(q, jnp.float32)
    qs = jnp.maximum(jnp.max(jnp.abs(q), axis=1, keepdims=True),
                     1e-12) / 127.0
    q_i8 = jnp.clip(jnp.round(q / qs), -127, 127).astype(jnp.int8)
    return np.asarray(jax.lax.dot_general(
        q_i8, jnp.asarray(db_i8), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("nq", [1, 8, 32])
def test_cross_term_and_candidates_equal_jax(nq):
    g, rng = _gallery(2)
    q = _queries(g, rng, nq)
    q[0, :5] = 0.5 / 127 * np.arange(5)  # halfway values: round to even
    db_i8, scale, sq = knn.quantize_rows(g)

    # the int32 cross term of the port's quantized queries, exactly JAX's
    qt = torch.from_numpy(q)
    q_i8, _ = knn.quantize_queries(qt)
    cross = knn.int8_cross(q_i8, torch.from_numpy(db_i8))
    assert cross.dtype == torch.int32
    np.testing.assert_array_equal(cross.numpy(), _jax_cross(q, db_i8))

    nc = 16
    d_t, i_t = knn.l2_candidates_int8(
        qt, torch.from_numpy(db_i8), torch.from_numpy(scale[:, 0]),
        torch.from_numpy(sq), nc)
    d_j, i_j = jax_knn.l2_candidates_int8(
        jnp.asarray(q), jnp.asarray(db_i8), jnp.asarray(scale[:, 0]),
        jnp.asarray(sq), nc + 1)
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    np.testing.assert_allclose(d_t.numpy(), d_j[:, :nc], rtol=0, atol=1e-6)
    gap = d_j[:, nc] - d_j[:, nc - 1] > 1e-6
    assert gap.sum() >= nq // 2
    for r in np.flatnonzero(gap):
        assert set(i_t[r].tolist()) == set(i_j[r, :nc].tolist()), r


@pytest.mark.parametrize("k", [1, 5, 64, N + 5])
@pytest.mark.parametrize("nq", [1, 7, 32])
def test_search_only_index_bit_equal_jax(gallery_file, nq, k):
    path, g = gallery_file
    rng = np.random.default_rng(10 * nq + k)
    q = _queries(g, rng, nq)
    dj, ij = JaxIndex.from_gallery(path, quant="int8").search_descriptors(
        q, k)
    ours = PlaceIndex.from_gallery(path, quant="int8", device="cpu")
    dt, it = ours.search_descriptors(q, k)
    assert dt.dtype == np.float32 and it.dtype == np.int64
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)
    if k > N:  # faiss's padding
        assert (it[:, N:] == -1).all() and np.isinf(dt[:, N:]).all()
    # the fp32 path's neighbours (the true top-k survives the candidates),
    # except where two rows are at exactly the same distance: the fp32
    # path puts the lower index first, the re-rank keeps candidate order
    kk = min(k, N)
    d32, i32 = PlaceIndex.from_gallery(path, device="cpu") \
        .search_descriptors(q, kk)
    np.testing.assert_allclose(dt[:, :kk], d32, rtol=1e-5, atol=1e-5)
    d = dt[:, :kk]
    tied = np.zeros(d.shape, bool)
    tied[:, 1:] |= d[:, 1:] == d[:, :-1]
    tied[:, :-1] |= d[:, 1:] == d[:, :-1]
    np.testing.assert_array_equal(it[:, :kk][~tied], i32[~tied])


@pytest.mark.parametrize("c", [60, 100])
def test_width_not_a_multiple_of_8_equals_jax(tmp_path, c):
    """The device gallery's columns are zero-padded to a multiple of 8
    (for the card's int8 GEMM) and the queries with them."""
    g, rng = _gallery(5, c=c)
    path = str(tmp_path / "g.npz")
    np.savez_compressed(path, feats=g, version=np.int64(1))
    q = _queries(g, rng, 9)
    ours = PlaceIndex.from_gallery(path, quant="int8", device="cpu")
    dj, ij = JaxIndex.from_gallery(path, quant="int8").search_descriptors(
        q, 7)
    dt, it = ours.search_descriptors(q, 7)
    assert ours._quant_gallery[0].shape == (N + 4, -(-c // 8) * 8)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt, dj)


def _worst_rows(idx, qq, k):
    """A corrupted candidate scan: the k farthest rows."""
    host = idx._host_gallery()
    d2 = (np.einsum("qc,qc->q", qq, qq)[:, None]
          + np.einsum("nc,nc->n", host, host)[None] - 2.0 * qq @ host.T)
    worst = np.argsort(-d2, axis=1)[:, :k]
    return (np.take_along_axis(d2, worst, axis=1).astype(np.float32),
            worst.astype(np.int64))


def test_audit_stats_and_warning_equal_jax(gallery_file, caplog,
                                           monkeypatch):
    path, g = gallery_file
    ours = PlaceIndex.from_gallery(path, quant="int8", audit_rate=0.5,
                                   device="cpu")
    ref = JaxIndex.from_gallery(path, quant="int8", audit_rate=0.5)
    q = _queries(g, np.random.default_rng(7), 5)
    for k in (3, 3, 8, 3):  # stride 2: searches 1 and 3 are audited
        ours.search_descriptors(q, k)
        ref.search_descriptors(q, k)
    assert ours.audit_stats == ref.audit_stats
    assert ours.audit_stats["audited"] == 2
    assert ours.audit_stats["missed_rows"] == 0

    messages = []
    for idx in (ours, ref):
        monkeypatch.setattr(idx, "_search_impl",
                            lambda qq, k, idx=idx: _worst_rows(idx, qq, k))
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            idx.search_descriptors(q, 3)  # search 5: audited
        messages.append([r.getMessage() for r in caplog.records])
    assert ours.audit_stats == ref.audit_stats
    assert ours.audit_stats["miss_queries"] == 5
    assert messages[0] == messages[1] and "int8 audit" in messages[0][0]


@pytest.mark.parametrize("kw", [{"quant": "int4"}, {"quant": "fp8"},
                                {"audit_rate": 1.5}, {"audit_rate": -0.1}])
def test_bad_quant_or_audit_rate_raises_as_jax(kw):
    with pytest.raises(ValueError) as ours:
        PlaceIndex(None, device="cpu", **kw)
    with pytest.raises(ValueError) as ref:
        JaxIndex(None, None, None, **kw)
    assert str(ours.value) == str(ref.value)


def test_uploads_and_lazy_rebuild_equal_jax(gallery_file):
    path, g = gallery_file
    ours = PlaceIndex.from_gallery(path, quant="int8", device="cpu")
    ref = JaxIndex.from_gallery(path, quant="int8")
    q = _queries(g, np.random.default_rng(3), 4)
    extra = _gallery(4, n=5, dups=0)[0]
    steps = [lambda i: i.search_descriptors(q, 5),
             lambda i: i.search_descriptors(q, 5),
             lambda i: i.add_descriptors(extra),
             lambda i: i.search_descriptors(q, 5),
             lambda i: i.remove_rows([0, 17, N + 2]),
             lambda i: i.search_descriptors(q, 5)]
    for step in steps:
        got, want = step(ours), step(ref)
        assert ours.upload_count == ref.upload_count
        if isinstance(want, tuple):
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0], want[0])
    assert ours.upload_count == 3 and len(ours) == N + 2
    # the device copy: int8 rows padded to a multiple of 8, the fp32 copy
    # dropped; the fp32 path then rebuilds its own
    rows, scale, sq = ours._quant_gallery
    assert rows.dtype == torch.int8 and rows.shape == (N + 4, C)
    assert (scale[N + 2:] == 0).all() and torch.isinf(sq[N + 2:]).all()
    assert ours._gallery is None
    ours.quant = None
    ours.search_descriptors(q, 5)
    assert ours.upload_count == 4 and ours._quant_gallery is None
