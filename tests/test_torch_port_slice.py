"""The PyTorch port's serving slice held against the JAX package on the CPU:
host input prep (exact), the ResNet / BEV-FPN / stage-1 fusion stages, the
full MM tower on all 7 output keys (fp32 and bf16), the DBVanilla2D aerial
tower, and the weight bridge.  Inputs and weights are made with numpy from
a seed and fed to both packages; the JAX side runs its CPU path (the
XLA path for the BEV kernels, interpret mode for the ODE kernel)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agplace_tpu.config import (kitti360_config, nuscenes_config,
                                synthetic_config)
from agplace_tpu.data.base import prepare_query_vox as jax_prepare_query_vox
from agplace_tpu.models.dbvanilla2d import DBVanilla2D as JaxDB
from agplace_tpu.models.fusion import FuseBlockToShallow as JaxFuse
from agplace_tpu.models.mm import MM as JaxMM
from agplace_tpu.sparse import bev_grid as jax_bev
from agplace_tpu.sparse.bev_grid import BEVGrid as JaxGrid
from agplace_tpu_torch.data.voxels import prepare_query_vox
from agplace_tpu_torch.models.dbvanilla2d import DBVanilla2D
from agplace_tpu_torch.models.fusion import FuseBlockToShallow
from agplace_tpu_torch.models.mm import MM
from agplace_tpu_torch.sparse.bev_grid import BEVGrid
from agplace_tpu_torch.utils.convert import (jax_to_state_dict,
                                             load_jax_variables)
from agplace_tpu_torch import ops

torch.set_num_threads(1)

B, IMG, GRID = 2, 64, (32, 32, 4)
KEYS = ("imagevec_org", "voxvec_org", "shallowvec_org", "stg2fusevec",
        "stg2imagevec", "stg2voxvec", "embedding")
# Tolerances are fractions of each output's max magnitude (max abs error
# <= tol * max|want|).  fp32: the BEV convs take bf16 operands and round
# their outputs to bf16 in both packages (BEVConv's compute dtype), so a
# last-ulp fp32 difference upstream (rsqrt, summation order) can flip one
# bf16 rounding (0.4 %) and every voxel-dependent output carries such flips
# (measured <= 3e-3); the pure image vector stays at fp32 level.
TOL_FP32 = {"imagevec_org": 1e-4}
TOL_FP32_VOX = 1e-2
# bf16 activations: rounding points agree, conv accumulation order does not,
# and 1-ulp bf16 flips propagate through ~30 layers (measured <= 4e-3).
TOL_BF16 = 2e-2


def _close(got, want, frac, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (what, err, np.abs(want).max())


def _cfg():
    cfg = kitti360_config()
    mm = dataclasses.replace(cfg.model.mm, vox_grid_extent=GRID)
    return cfg.replace(model=dataclasses.replace(cfg.model, mm=mm))


def _randomize(variables, rng):
    """Non-trivial BN affines and running statistics (BN is not the
    identity), flax-initialised kernels; numpy leaves for both packages."""
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


def _points(rng, b, n=4000):
    az = rng.uniform(0, 2 * np.pi, (b, n))
    elev = np.deg2rad(rng.uniform(-24.9, 2.0, (b, n)))
    r = np.exp(rng.uniform(np.log(2.0), np.log(40.0), (b, n)))
    return np.stack([r * np.cos(elev) * np.cos(az),
                     r * np.cos(elev) * np.sin(az),
                     np.maximum(r * np.sin(elev), -1.73)],
                    axis=-1).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    cfg = _cfg()
    rng = np.random.default_rng(0)
    img = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    pts = _points(rng, B)
    vox = jax_prepare_query_vox(cfg, pts)
    mm_j = JaxMM(config=cfg.model.mm, train=False)
    v = _randomize(jax.jit(mm_j.init)(jax.random.PRNGKey(0), img, vox), rng)
    return cfg, img, pts, vox, v


def _torch_mm(cfg, v, dtype):
    mm = MM(cfg.model.mm, dtype=dtype)
    load_jax_variables(mm, v)
    return mm.eval()


def _tgrid(vox):
    m = torch.from_numpy(np.asarray(vox.mask))
    return BEVGrid(feats=m.float(), mask=m, z=m.shape[-1])


def test_host_prep_exactly_equal(world):
    cfg, _, pts, vox, _ = world
    got = prepare_query_vox(cfg, pts, "cpu")
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(vox.mask))
    np.testing.assert_array_equal(got.feats.numpy(), np.asarray(vox.feats))
    assert (got.z, got.stride) == (vox.z, vox.stride)
    assert got.mask.any()
    # any other backend gets the padded voxel set
    sparse = cfg.replace(model=dataclasses.replace(
        cfg.model, mm=dataclasses.replace(cfg.model.mm,
                                          voxfe_backend="sparse")))
    want = jax_prepare_query_vox(sparse, pts)
    got = prepare_query_vox(sparse, pts, "cpu")
    for f in ("coords", "feats", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_host_voxelizer_and_raster_exactly_equal(monkeypatch, path):
    from agplace_tpu import native as jax_native
    from agplace_tpu.sparse import bev_grid as jax_bev
    from agplace_tpu.sparse import voxels as jax_vox
    from agplace_tpu_torch import native
    from agplace_tpu_torch.data import voxels as tv

    if path == "numpy":  # JAX's numpy fallback, the port's plain version
        monkeypatch.setattr(jax_native, "voxelize_batch_native",
                            lambda *a, **k: None)
        monkeypatch.setattr(native, "voxelize_batch",
                            lambda pts, q, cap, radius:
                            tv.voxelize_plain(pts, q, cap))
    rng = np.random.default_rng(5)
    pts = _points(rng, 3, n=3000)
    pts[0, 2500:] = np.nan  # NaN padding
    pts[1, :50] *= 400.0  # beyond GRID_RADIUS: clamped
    pts[2] = np.nan  # an empty cloud
    want = jax_vox.batched_from_pointclouds(pts, 2.0, 200)
    got = tv.batched_from_pointclouds(pts, 2.0, 200)
    for f in ("coords", "feats", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # item 0 fills the capacity (truncated), item 2 is empty
    assert got.mask[0].all() and not got.mask[2].any()
    for extent in ((32, 32, 4), (24, 40, 3)):
        g_want = jax_bev.rasterize_from_voxels_host(want, extent)
        g_got = tv.rasterize_from_voxels_host(got, extent)
        np.testing.assert_array_equal(g_got.mask.numpy(), g_want.mask)
        np.testing.assert_array_equal(g_got.feats.numpy(), g_want.feats)
    assert tv.GRID_RADIUS == jax_vox.GRID_RADIUS
    for cells in range(1, 17):
        assert tv.me_down_align(cells) == jax_vox.me_down_align(cells)


def test_resnet_stage_maps_match(world):
    cfg, img, _, _, v = world
    from agplace_tpu.models.image_fe import ImageFE as JaxFE

    fe = JaxFE(fe_type="resnet18", layers=cfg.model.mm.imgfe_layers)
    _, want = fe.apply({"params": v["params"]["image_fe"],
                        "batch_stats": v["batch_stats"]["image_fe"]}, img)
    mm = _torch_mm(cfg, v, torch.float32)
    with torch.no_grad():
        _, got = mm.image_fe(torch.from_numpy(img))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_bev_fpn_stage_maps_match(world):
    cfg, _, _, vox, v = world
    from agplace_tpu.sparse.bev_grid import BEVMinkFPN as JaxFPN

    c = cfg.model.mm
    fpn = JaxFPN(out_channels=c.voxfe_planes[-1], planes=c.voxfe_planes,
                 layers=c.voxfe_layers, conv0_kernel_size=5,
                 use_pallas=c.bev_pallas, use_fused_down=c.bev_fused_down)
    _, want = jax.jit(fpn.apply)({"params": v["params"]["vox_fe"],
                         "batch_stats": v["batch_stats"]["vox_fe"]},
                        JaxGrid(feats=jnp.asarray(vox.feats),
                                mask=jnp.asarray(vox.mask), z=vox.z))
    mm = _torch_mm(cfg, v, torch.float32)
    with torch.no_grad():
        _, got = mm.vox_fe(_tgrid(vox))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        assert g.z == w.z
        _close(g.feats.numpy(), w.feats, TOL_FP32_VOX)


def test_stage1_fusion_matches(world):
    cfg, _, _, _, v = world
    c = cfg.model.mm
    rng = np.random.default_rng(7)
    imgs = [rng.standard_normal((B, d)).astype(np.float32)
            for d in c.imgfe_planes]
    voxs = [rng.standard_normal((B, d)).astype(np.float32)
            for d in c.voxfe_planes]
    fb = JaxFuse(dims=(c.stg2fuse_dim,) * 3, img_dims=c.imgfe_planes,
                 vox_dims=c.voxfe_planes, ode=c.ode)
    want = fb.apply({"params": v["params"]["fuseblocktoshallow"]}, imgs,
                    voxs)
    tb = FuseBlockToShallow((c.stg2fuse_dim,) * 3, c.imgfe_planes,
                            c.voxfe_planes, c.ode)
    load_jax_variables(tb, {"params": v["params"]["fuseblocktoshallow"]})
    with torch.no_grad():
        got = tb([torch.from_numpy(a) for a in imgs],
                 [torch.from_numpy(a) for a in voxs])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# The presets the MM is held to JAX at, each with its BEV grid cut to 32 x
# 32 cells at its own z: KITTI-360 (z = 4, the ``world`` above), nuScenes
# and the default config (z = 8), the synthetic config (z = 16), and
# nuScenes with ``bev_pallas_head`` set (K4 at z = 8; JAX's Pallas path with
# ``_pallas_backend_ok`` patched to True, as the JAX package's tests do).
# The other presets take PRESET_IMG px images: the image branch is the
# same module at every preset, and the BEV branch is what differs.
PRESETS = {"nuscenes": (nuscenes_config, False),
           "synthetic": (synthetic_config, False),
           "nuscenes_head": (nuscenes_config, True)}
PRESET_IMG = 32


@pytest.fixture(scope="module")
def preset_world(request):
    if request.param == "kitti360":
        cfg, img, _, vox, v = request.getfixturevalue("world")
        return False, cfg, img, vox, v
    make, head = PRESETS[request.param]
    cfg = make()
    z = cfg.model.mm.vox_grid_extent[2]
    mm = dataclasses.replace(cfg.model.mm, vox_grid_extent=GRID[:2] + (z,),
                             bev_pallas_head=head)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, mm=mm))
    rng = np.random.default_rng(0)
    img = rng.standard_normal((B, PRESET_IMG, PRESET_IMG, 3)).astype(
        np.float32)
    vox = jax_prepare_query_vox(cfg, _points(rng, B))
    mm_j = JaxMM(config=cfg.model.mm, train=False)
    v = _randomize(jax.jit(mm_j.init)(jax.random.PRNGKey(0), img, vox), rng)
    return head, cfg, img, vox, v


@pytest.mark.parametrize("preset_world,dtype", [
    ("kitti360", "float32"), ("kitti360", "bfloat16"),
    ("nuscenes", "float32"), ("nuscenes", "bfloat16"),
    ("synthetic", "float32"), ("synthetic", "bfloat16"),
    ("nuscenes_head", "bfloat16")], indirect=["preset_world"],
    scope="module")
def test_mm_all_keys_match(preset_world, dtype, monkeypatch):
    head, cfg, img, vox, v = preset_world
    if head:
        monkeypatch.setattr(jax_bev, "_pallas_backend_ok", lambda: True)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    mm_j = JaxMM(config=cfg.model.mm, train=False, dtype=jdt)
    want = jax.jit(mm_j.apply)(v, img, vox)
    mm = _torch_mm(cfg, v, tdt)
    ops.reset_launches()
    with torch.inference_mode():
        got = mm(torch.from_numpy(img), _tgrid(vox))
    assert np.asarray(vox.mask).shape[-1] == cfg.model.mm.vox_grid_extent[2]
    assert sorted(got) == sorted(KEYS) == sorted(want)
    for k in KEYS:
        assert got[k].dtype == torch.float32, k
        tol = (TOL_FP32.get(k, TOL_FP32_VOX) if dtype == "float32"
               else TOL_BF16)
        _close(got[k].numpy(), want[k], tol, k)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert ops.launches() == {"fused_euler_ode": 0,
                              "fused_conv0_down0": 0,
                              "fused_eca_block_sm": 0, "fused_head": 0,
                              "fused_affine_relu_maxpool": 0,
                              "fused_eca_block": 0,
                              "fused_eca_block_concat": 0,
                              "fused_down_concat": 0}


def test_dbvanilla2d_matches(world):
    cfg, img, _, _, _ = world
    rng = np.random.default_rng(3)
    maps = rng.standard_normal((B, 1, IMG, IMG, 3)).astype(np.float32)
    db_j = JaxDB(config=cfg.model.db, dim=cfg.model.features_dim)
    v = _randomize(jax.jit(db_j.init)(jax.random.PRNGKey(1), maps), rng)
    want = jax.jit(db_j.apply)(v, maps)
    db = DBVanilla2D(cfg.model.db, dim=cfg.model.features_dim)
    load_jax_variables(db, v)
    with torch.no_grad():
        got = db.eval()(torch.from_numpy(maps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_converter_consumes_every_leaf_exactly_once(world):
    cfg, _, _, _, v = world
    mm = MM(cfg.model.mm)
    sd = jax_to_state_dict(v, mm)
    n_leaves = sum(len(jax.tree_util.tree_leaves(v[c])) for c in v)
    assert len(sd) == n_leaves == len(mm.state_dict())
    # conv HWIO -> OIHW and Dense [in, out] -> [out, in]
    k = v["params"]["image_fe"]["fe"]["conv1"]["kernel"]
    np.testing.assert_array_equal(sd["image_fe.fe.conv1.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    d = v["params"]["stg2fusefc"]["kernel"]
    np.testing.assert_array_equal(sd["stg2fusefc.weight"].numpy(), d.T)
    # BEV 3-D kernels and ECA weights keep their shapes
    assert sd["vox_fe.conv0.kernel"].shape == (5, 5, 5, 1, 64)
    assert sd["vox_fe.block0_0.eca.conv_w"].shape == (3, 1, 1)

    extra = {c: dict(v[c]) for c in v}
    extra["params"]["bogus"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="no counterpart"):
        jax_to_state_dict(extra, mm)
    short = {c: dict(v[c]) for c in v}
    del short["params"]["stg2fusefc"]
    with pytest.raises(KeyError, match="no flax leaf"):
        jax_to_state_dict(short, mm)
