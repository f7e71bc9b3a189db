"""The port's ``PlaceIndex`` against ``agplace_tpu.serving.PlaceIndex``:
exact top-k on random descriptors (incl. faiss k > N padding and planted
neighbours), the gallery file round trip in both directions, the end-to-end
embed + search path on a tiny configuration, and the package's no-JAX
import rule.  The port's entry points run on the card by default, so these
CPU tests pass ``device="cpu"``."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

import torch

from agplace_tpu.config import synthetic_config
from agplace_tpu.serving import PlaceIndex as JaxIndex
from agplace_tpu_torch.infer import build_towers
from agplace_tpu_torch.retrieval.knn import l2_topk
from agplace_tpu_torch.serving import PlaceIndex

torch.set_num_threads(1)


def _gallery(seed, n=300, c=64):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, c)).astype(np.float32)
    return g / np.linalg.norm(g, axis=1, keepdims=True), rng


@pytest.mark.parametrize("nq,k", [(5, 5), (13, 8), (1, 1)])
def test_search_descriptors_matches_jax(nq, k):
    g, rng = _gallery(0)
    q = rng.standard_normal((nq, g.shape[1])).astype(np.float32)
    ours, ref = PlaceIndex(None, device="cpu"), JaxIndex(None, None, None)
    ours.add_descriptors(g)
    ref.add_descriptors(g)
    d, i = ours.search_descriptors(q, k)
    d_ref, i_ref = ref.search_descriptors(q, k)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
    assert d.shape == (nq, k) and i.dtype == np.int64


def test_k_larger_than_gallery_pads_like_faiss():
    g, rng = _gallery(1, n=3)
    q = rng.standard_normal((4, g.shape[1])).astype(np.float32)
    ours, ref = PlaceIndex(None, device="cpu"), JaxIndex(None, None, None)
    ours.add_descriptors(g)
    ref.add_descriptors(g)
    d, i = ours.search_descriptors(q, 6)
    d_ref, i_ref = ref.search_descriptors(q, 6)
    np.testing.assert_array_equal(i, i_ref)
    assert np.all(i[:, 3:] == -1) and np.all(np.isinf(d[:, 3:]))
    np.testing.assert_allclose(d[:, :3], d_ref[:, :3], rtol=1e-5)


def test_planted_neighbours_come_back_first():
    g, rng = _gallery(2)
    rows = rng.choice(len(g), 16, replace=False)
    q = g[rows] + 1e-3 * rng.standard_normal(
        (16, g.shape[1])).astype(np.float32)
    idx = PlaceIndex(None, device="cpu")
    idx.add_descriptors(g[:100])
    idx.add_descriptors(g[100:])  # two parts: concatenated in order
    d, i = idx.search_descriptors(q, 3)
    np.testing.assert_array_equal(i[:, 0], rows)
    ref = JaxIndex(None, None, None)
    ref.add_descriptors(g)
    np.testing.assert_array_equal(i, ref.search_descriptors(q, 3)[1])


def test_l2_topk_is_exact_against_numpy():
    g, rng = _gallery(3, n=50, c=16)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    d, i = l2_topk(torch.from_numpy(q), torch.from_numpy(g), 4)
    d2 = ((q[:, None, :].astype(np.float64) - g[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(i.numpy(), np.argsort(d2, 1)[:, :4])
    np.testing.assert_allclose(d.numpy(), np.sort(d2, 1)[:, :4], rtol=1e-4,
                               atol=1e-5)


def test_gallery_round_trip_both_packages(tmp_path):
    g, _ = _gallery(4, n=20, c=8)
    pos = np.arange(40, dtype=np.float64).reshape(20, 2)
    ours = PlaceIndex(None, device="cpu")
    ours.add_descriptors(g, positions=pos)
    path = str(tmp_path / "gallery.npz")
    ours.save_gallery(path)
    back = PlaceIndex(None, device="cpu")
    assert back.load_gallery(path) == 20
    np.testing.assert_array_equal(back._host_gallery(), g)
    np.testing.assert_array_equal(back.positions, pos)
    ref = JaxIndex(None, None, None)  # the JAX index reads the same file
    assert ref.load_gallery(path) == 20
    np.testing.assert_array_equal(ref._host_gallery(), g)


def test_device_gallery_uploads_lazily():
    g, rng = _gallery(5, n=40, c=16)
    idx = PlaceIndex(None, device="cpu")
    idx.add_descriptors(g[:20])
    idx.add_descriptors(g[20:])
    assert idx.upload_count == 0  # no upload at add time
    q = rng.standard_normal((3, 16)).astype(np.float32)
    first = idx.search_descriptors(q, 4)
    idx.search_descriptors(q, 2)
    assert idx.upload_count == 1  # reused across searches
    idx.add_descriptors(q[:1])
    d, i = idx.search_descriptors(q, 4)
    assert idx.upload_count == 2 and len(idx) == 41
    assert i[0, 0] == 40 and d[0, 0] < 1e-5  # the new row is searched
    np.testing.assert_array_equal(i[1:], first[1][1:])


class _Tiles:
    """Minimal aerial-tile source: ``database_num`` + ``load_db_maps``."""

    def __init__(self, n, size, seed=0):
        rng = np.random.default_rng(seed)
        self.maps = rng.standard_normal((n, 1, size, size, 3)).astype(
            np.float32)
        self.database_num = n
        self.db_eastnorth = rng.uniform(0, 100, (n, 2))

    def load_db_maps(self, i):
        return self.maps[i]


def test_end_to_end_embed_and_search():
    cfg = synthetic_config(batch_size=2, image_size=32)
    mm = dataclasses.replace(cfg.model.mm, vox_grid_extent=(16, 16, 4))
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, mm=mm))
    towers = build_towers(cfg, "cpu", torch.Generator().manual_seed(0))
    idx = PlaceIndex(cfg, towers)
    assert idx.add_tiles(_Tiles(5, 32)) == 5  # 3 padded tower batches
    rng = np.random.default_rng(1)
    images = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    points = rng.uniform(-20, 20, (3, 200, 3)).astype(np.float32)
    q = idx.embed(images, points)
    assert q.shape == (3, cfg.model.features_dim) and np.isfinite(q).all()
    # batch padding does not change a query's descriptor
    np.testing.assert_allclose(idx.embed(images[:1], points[:1]), q[:1],
                               rtol=1e-5, atol=1e-6)
    idx.add_descriptors(q[1:2])  # plant query 1 as gallery row 5
    d, i = idx.search(images, points, k=2)
    assert i.shape == (3, 2) and i[1, 0] == 5 and d[1, 0] < 1e-5
    assert np.all((i >= 0) & (i < 6))


def test_port_imports_no_jax():
    code = ("import sys, agplace_tpu_torch, agplace_tpu_torch.serving, "
            "agplace_tpu_torch.infer, agplace_tpu_torch.utils.convert, "
            "agplace_tpu_torch.ops._build; "
            # every kernel wrapper, the smoke and the probe entry points
            "from agplace_tpu_torch import ops; ops.kernels(); "
            "sys.path.insert(0, 'scripts'); import chip_smoke, "
            "probe_torch_down_v2, probe_torch_block_sm_v2; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax')]; "
            "assert not bad, bad; "
            # nothing of the JAX package, not even after the port's own
            # voxelizer has run
            "import numpy as np; from agplace_tpu_torch import native; "
            "native.voxelize_batch(np.zeros((1, 4, 3), np.float32), 2.0, 8, "
            "64); "
            "old = {m for m in sys.modules if m == 'agplace_tpu' or "
            "m.startswith('agplace_tpu.')}; "
            "assert not old, old; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
