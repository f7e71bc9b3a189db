"""The port stands alone: no module of ``agplace_tpu_torch/``, nor
``chip_smoke.py``, the port's scripts or the multi-process tests' worker,
imports JAX or the JAX package;
its presets equal the JAX package's; its entry points run on the card
unless the caller asks for the CPU; and its host voxelizer is its own,
built into ``agplace_tpu_torch/_build/``, and equal to the JAX package's.
"""

import ast
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

import agplace_tpu.config as jax_config
from agplace_tpu import native as jax_native
from agplace_tpu_torch import config, native
from agplace_tpu_torch.data import voxels
from agplace_tpu_torch.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "agplace_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(ROOT, "chip_smoke.py")]
    # the port's entry points; scripts/baseline_torch.py is the JAX
    # package's own torchvision baseline, which compares against JAX
    + glob.glob(os.path.join(ROOT, "scripts", "*torch_*.py"))
    # the multi-process tests' worker runs the port alone too
    + [os.path.join(ROOT, "tests", "_torch_parallel_worker.py")])
FORBIDDEN = ("jax", "jaxlib", "flax", "agplace_tpu")


def _imported_roots(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_scan_sees_the_port():
    assert "agplace_tpu_torch/ops/bev_block_sm.py" in PORT_FILES
    assert "chip_smoke.py" in PORT_FILES
    assert "scripts/profile_torch_mm.py" in PORT_FILES
    assert "scripts/probe_torch_block_sm_v2.py" in PORT_FILES
    for path in ("serving_http.py", "serve.py", "test.py", "data/geo.py",
                 "data/transforms.py", "data/kitti360.py",
                 "data/nuscenes.py", "data/validate.py"):
        assert f"agplace_tpu_torch/{path}" in PORT_FILES
    for path in ("ode/integrators.py", "ode/sde.py", "sparse/voxels.py",
                 "sparse/modules.py", "sparse/minkfpn.py",
                 "sparse/dense_grid.py"):
        assert f"agplace_tpu_torch/{path}" in PORT_FILES
    for path in ("models/factory.py", "models/geoloc.py", "models/cct.py",
                 "models/minkloc.py", "models/pooling.py",
                 "models/image_fe.py", "retrieval/kmeans.py",
                 "train/netvlad_init.py"):
        assert f"agplace_tpu_torch/{path}" in PORT_FILES
    assert "scripts/write_torch_trees.py" in PORT_FILES
    for path in ("models/anyloc.py", "utils/torch_convert.py",
                 "utils/image_resize.py", "train/metric_losses.py",
                 "data/folder_dataset.py", "data/pc_augment.py",
                 "data/projections.py", "utils/flops.py", "utils/viz.py"):
        assert f"agplace_tpu_torch/{path}" in PORT_FILES
    assert "scripts/write_torch_weights.py" in PORT_FILES
    for path in ("parallel/__init__.py", "parallel/mesh.py",
                 "parallel/bootstrap.py", "retrieval/sharded.py"):
        assert f"agplace_tpu_torch/{path}" in PORT_FILES
    assert "tests/_torch_parallel_worker.py" in PORT_FILES
    assert not any(p.startswith("agplace_tpu/") for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("preset", ["kitti360_config", "nuscenes_config",
                                    "synthetic_config"])
def test_presets_equal_the_jax_packages(preset):
    ours, ref = getattr(config, preset)(), getattr(jax_config, preset)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert type(ours).__module__ == "agplace_tpu_torch.config"
    # replace() and the derived properties behave alike
    ours = ours.replace(exp_name="x")
    assert ours.exp_name == "x" and ours.data.nmap == ref.data.nmap


def _tiny_cfg():
    cfg = config.kitti360_config()
    mm = dataclasses.replace(cfg.model.mm, vox_grid_extent=(16, 16, 4))
    return cfg.replace(model=dataclasses.replace(cfg.model, mm=mm))


def _points():
    rng = np.random.default_rng(0)
    return rng.uniform(-20, 20, (2, 300, 3)).astype(np.float32)


def _build_towers(device=None):
    from agplace_tpu_torch.infer import build_towers

    args = () if device is None else (device,)
    return build_towers(_tiny_cfg(), *args)


def _place_index(device=None):
    from agplace_tpu_torch.serving import PlaceIndex

    if device is None:
        return PlaceIndex(None)
    return PlaceIndex(None, device=device)


def _prepare_query_vox(device=None):
    args = () if device is None else (device,)
    return voxels.prepare_query_vox(_tiny_cfg(), _points(), *args)


def _init_state(device=None):
    from agplace_tpu_torch.train.step import init_state

    cfg = _tiny_cfg()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, pretrained=False))
    return init_state(cfg, *(() if device is None else (device,)))


def _miner(device=None):
    from agplace_tpu_torch.data.synthetic import SyntheticDataset
    from agplace_tpu_torch.train.mining import TripletMiner

    ds = SyntheticDataset(n_db=8, n_q=4, image_size=16, seed=0)
    return TripletMiner(_tiny_cfg(), ds,
                        *(() if device is None else (device,)))


ENTRY_POINTS = {"build_towers": _build_towers, "PlaceIndex": _place_index,
                "prepare_query_vox": _prepare_query_vox,
                "init_state": _init_state, "TripletMiner": _miner}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch,
                                                          entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]("cuda")
    assert ENTRY_POINTS[entry]("cpu") is not None


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert _place_index().device == torch.device("cuda")  # search-only
    assert resolve_device("cpu") == torch.device("cpu")


def test_voxelizer_builds_into_the_ports_build_dir():
    jax_dir = os.path.dirname(jax_native.__file__)

    def listing():  # the JAX package's own loader may be rebuilding there
        return {f for f in os.listdir(jax_dir)
                if f != "__pycache__" and not f.endswith(".tmp")}

    before = listing()
    path = native.build()
    assert path == native.LIB_PATH and os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(ROOT, "agplace_tpu_torch",
                                                 "_build")
    assert native.SRC == os.path.join(ROOT, "agplace_tpu_torch", "native",
                                      "voxelizer.cpp")
    native.lib()
    assert listing() == before  # nothing of the port lands there


def test_voxelizer_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="not found"):
        native.build(str(tmp_path / "a.so"))
    monkeypatch.setattr(native, "CXX", "g++")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="voxelizer build failed"):
        native.build(str(tmp_path / "b.so"))
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


@pytest.mark.parametrize("seed,capacity", [(1, 64), (2, 2000), (3, 500)])
def test_voxelizer_equals_the_jax_packages(seed, capacity):
    """Native and plain versions against the JAX package's native
    voxelizer and its numpy fallback, with NaN padding, clamped outliers
    and an empty cloud."""
    import agplace_tpu.sparse.voxels as jax_vox

    rng = np.random.default_rng(seed)
    pts = rng.uniform(-90, 90, (3, 2500, 3)).astype(np.float32)
    pts[0, 2000:] = np.nan
    pts[1, :40] *= 5.0
    pts[2] = np.nan
    radius = voxels.GRID_RADIUS
    got = native.voxelize_batch(pts, 2.0, capacity, radius)
    plain = voxels.voxelize_plain(pts, 2.0, capacity)
    want = jax_native.voxelize_batch_native(pts, 2.0, capacity, radius)
    assert want is not None
    for a, b, c in zip(got, plain, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert radius == jax_vox.GRID_RADIUS
    assert not got[1][2].any()
