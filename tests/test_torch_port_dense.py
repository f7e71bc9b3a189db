"""The port's dense-grid voxel backend (``sparse/dense_grid.py``) held
against the JAX package on the CPU: ``densify``, every route of
``GridConv`` (the z-folded 2-D conv, the 3-D conv, the ME-aligned k2s2
down), the transposed conv of the top-down pass, the masked BN, the FPN
with each block, and the MM on ``voxfe_backend='dense'`` in eval and
training mode (helpers and tolerances of ``test_torch_port_mm_options.py``).
Then the port's three backends against each other, as JAX's
``test_bev_grid.py`` and ``test_dense_grid.py`` hold JAX's: the same
weights (reshaped [k^3, cin, cout] for the sparse backend) on a cloud
inside the grid extent give the same embeddings.

Layer tolerances, fractions of the output's largest magnitude: fp32
compute 1e-5 (1e-4 through a stack of convs), summation order only; a
conv whose output rounds to bf16 1e-2 (one bf16 ulp is 3.9e-3 of the
value, and the two packages' fp32 sums may round apart).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from agplace_tpu.sparse import dense_grid as jax_dense
from agplace_tpu.sparse import voxels as jax_vox
from agplace_tpu_torch.data.voxels import SparseVoxels
from agplace_tpu_torch.models.mm import MM
from agplace_tpu_torch.sparse import dense_grid
from agplace_tpu_torch.utils.convert import load_jax_variables

from test_torch_port_mm_options import (KEYS, check_eval, check_train,
                                        close, make_world, port_mm,
                                        port_vox, random_variables)

torch.set_num_threads(1)

FP32_TOL, BF16_OUT_TOL = 1e-5, 1e-2


def _voxels(rng, b=2, n=300, extent=(12, 14, 6), c=1, spill=False):
    """Host-voxelized clouds (JAX's collate); ``spill`` puts points beyond
    the extent, where densify clamps several voxels into one cell."""
    pts = rng.uniform(-extent[0], extent[0], (b, n, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(-extent[2], extent[2], (b, n))
    if spill:
        pts[:, :40] *= 3.0
    sv_j = jax_vox.batched_from_pointclouds(pts, 2.0, 256)
    feats = np.asarray(sv_j.feats)
    if c > 1:
        feats = rng.standard_normal(feats.shape[:2] + (c,)).astype(
            np.float32) * np.asarray(sv_j.mask)[..., None]
        sv_j = sv_j.replace(feats=jnp.asarray(feats))
    sv = SparseVoxels(coords=torch.from_numpy(np.asarray(sv_j.coords)),
                      feats=torch.from_numpy(feats),
                      mask=torch.from_numpy(np.asarray(sv_j.mask)))
    return sv_j, sv


def _grids(rng, extent, c=1):
    sv_j, sv = _voxels(rng, extent=extent, c=c)
    return (jax_dense.densify(sv_j, extent=extent),
            dense_grid.densify(sv, extent=extent))


@pytest.mark.parametrize("ones,spill", [(True, False), (False, True)])
def test_densify_exactly_equal(ones, spill):
    rng = np.random.default_rng(0)
    ext = (12, 14, 6)
    sv_j, sv = _voxels(rng, extent=ext, c=1 if ones else 3, spill=spill)
    want = jax_dense.densify(sv_j, extent=ext, ones_feats=ones)
    got = dense_grid.densify(sv, extent=ext, ones_feats=ones)
    np.testing.assert_array_equal(got.mask.numpy(), want.mask)
    np.testing.assert_array_equal(got.feats.numpy(), want.feats)
    if spill:  # clamped voxels summed in their boundary cell
        assert int(got.mask.sum()) < int(sv.mask.sum())
    close(dense_grid.grid_global_avg(got).numpy(),
          jax_dense.grid_global_avg(want), 1e-6)
    np.testing.assert_array_equal(dense_grid.grid_global_max(got).numpy(),
                                  jax_dense.grid_global_max(want))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,s,z,cin,cout", [
    (3, 1, 2, 4, 8),  # z-folded 2-D route (z <= k//2 + 1)
    (5, 1, 3, 1, 8),  # z-folded at k = 5
    (3, 1, 6, 4, 8),  # 3-D conv
    (5, 1, 4, 1, 8),  # conv0's 3-D conv at KITTI-360's z = 4
    (1, 1, 6, 4, 8),
    (2, 2, 6, 4, 4),
    (2, 2, 5, 4, 4),  # odd z: ME alignment padding
])
def test_grid_conv_matches(k, s, z, cin, cout, compute):
    rng = np.random.default_rng(k * 10 + s + z)
    g_j, g = _grids(rng, (12, 14, z), c=cin)
    jdt, tdt = ((jnp.float32, torch.float32) if compute == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    conv_j = jax_dense.GridConv(cout, kernel_size=k, stride=s,
                                compute_dtype=jdt)
    v = random_variables(conv_j, rng, g_j)
    want = conv_j.apply(v, g_j)
    conv = dense_grid.GridConv(cin, cout, k, s, compute_dtype=tdt)
    load_jax_variables(conv, v)
    with torch.no_grad():
        got = conv(g)
    np.testing.assert_array_equal(got.mask.numpy(), want.mask)
    assert got.stride == want.stride
    close(got.feats.numpy(), want.feats,
          FP32_TOL if compute == "float32" else BF16_OUT_TOL)


@pytest.mark.parametrize("fine", [(12, 14, 4), (10, 12, 6)])
def test_grid_conv_transpose_matches(fine):
    """k2s2 transposed conv: JAX's kernel is not flipped, the ME alignment
    cells are cropped, the fine mask applied."""
    rng = np.random.default_rng(1)
    g_j, g = _grids(rng, fine, c=3)
    down_j = jax_dense.GridConv(6, kernel_size=2, stride=2,
                                compute_dtype=jnp.float32)
    coarse_j = down_j.apply(random_variables(down_j, rng, g_j), g_j)
    tc_j = jax_dense.GridConvTranspose(5, compute_dtype=jnp.float32)
    v = random_variables(tc_j, rng, coarse_j, g_j.mask)
    want = tc_j.apply(v, coarse_j, g_j.mask)
    coarse = dense_grid.DenseVoxelGrid(
        feats=torch.from_numpy(np.asarray(coarse_j.feats)),
        mask=torch.from_numpy(np.asarray(coarse_j.mask)), stride=2)
    tc = dense_grid.GridConvTranspose(6, 5, torch.float32)
    load_jax_variables(tc, v)
    with torch.no_grad():
        got = tc(coarse, g.mask)
    assert got.stride == want.stride == 1
    close(got.feats.numpy(), want.feats, FP32_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_grid_batchnorm_matches(train):
    rng = np.random.default_rng(2)
    g_j, g = _grids(rng, (12, 14, 4), c=6)
    bn_j = jax_dense.GridBatchNorm(use_running_average=not train)
    v = random_variables(bn_j, rng, g_j)
    bn = dense_grid.GridBatchNorm(6)
    load_jax_variables(bn, v)
    bn.train(train)
    with torch.no_grad():
        got = bn(g)
    if train:
        want, upd = bn_j.apply(v, g_j, mutable=["batch_stats"])
        close(bn.running_mean.numpy(), upd["batch_stats"]["mean"], 1e-6)
        close(bn.running_var.numpy(), upd["batch_stats"]["var"], 1e-6)
    else:
        want = bn_j.apply(v, g_j)
    close(got.feats.numpy(), want.feats, FP32_TOL)


@pytest.mark.parametrize("block", ["eca", "basic", "aspp", "convnext"])
def test_dense_fpn_blocks_match(block):
    """DenseMinkFPN with each block and a top-down level, eval mode, the
    convs in fp32 (the structure, not bf16's rounding noise)."""
    rng = np.random.default_rng(3)
    g_j, g = _grids(rng, (16, 16, 4))
    kw = dict(out_channels=16, planes=(8, 16, 16), layers=(1, 1, 1),
              num_top_down=1, conv0_kernel_size=5, block=block)
    fpn_j = jax_dense.DenseMinkFPN(**kw, compute_dtype=jnp.float32)
    v = random_variables(fpn_j, rng, g_j)
    want, wmaps = jax.jit(fpn_j.apply)(v, g_j)
    fpn = dense_grid.DenseMinkFPN(**kw, compute_dtype=torch.float32)
    load_jax_variables(fpn, v)
    with torch.no_grad():
        got, gmaps = fpn.eval()(g)
    for gm, wm in zip(gmaps, wmaps):
        np.testing.assert_array_equal(gm.mask.numpy(), wm.mask)
        close(gm.feats.numpy(), wm.feats, FP32_TOL * 10)
    close(got.feats.numpy(), want.feats, FP32_TOL * 10)


# ------------------------------------------------------- the MM, dense
DENSE_VARIANTS = {
    "eca": {},
    "ntd1-basic-noproj": dict(voxfe_ntd=1, voxfe_block="basic",
                              stg2_useproj=False),
    "ntd2-aspp-droppc": dict(voxfe_ntd=2, voxfe_block="aspp", drop="pc"),
    "convnext-dopri5": dict(voxfe_block="convnext",
                            ode={"method": "dopri5"}),
}


@pytest.fixture(scope="module")
def dense_world(request):
    return make_world(voxfe_backend="dense",
                      **DENSE_VARIANTS[request.param])


@pytest.mark.parametrize("dense_world", list(DENSE_VARIANTS), indirect=True)
def test_dense_mm_eval_match(dense_world):
    check_eval(dense_world)


@pytest.mark.parametrize("dense_world", list(DENSE_VARIANTS), indirect=True)
def test_dense_mm_train_match(dense_world, request):
    # the ntd1-basic-noproj variant's check also holds the gradients
    check_train(dense_world, grads=request.node.callspec.params[
        "dense_world"] == "ntd1-basic-noproj")


# ---------------------------------------- the port's backends, each other
def sparse_state(grid_state):
    """A bev / dense state dict in the sparse backend's layout: each 3-D
    kernel [k,k,k,cin,cout] as [k^3, cin, cout], a 1x1 as [cin, cout].
    The transposed convs' taps are flipped first: JAX's dense one
    (``lax.conv_transpose``, kernel not flipped) sends fine offset a
    through tap 1 - a, its sparse one (ME's kernel map) through tap a."""
    out = {}
    for k, t in grid_state.items():
        if k.endswith("kernel") and t.ndim == 5:
            if ".tconv" in k:
                t = t.flip(0, 1, 2)
            t = t.reshape(-1, *t.shape[3:])
            if t.shape[0] == 1:
                t = t[0]
        out[k] = t
    return out


BACKEND_TOL = 2e-2  # bf16 convs of three layouts: rounding order only


@pytest.mark.parametrize("block,ntd", [("eca", 0), ("basic", 1)])
def test_port_backends_agree(block, ntd):
    """bev (host raster and the device fold of the same voxels), dense and
    sparse: one set of weights, one cloud inside the extent, the same 7
    outputs in eval mode."""
    world = make_world(voxfe_block=block, voxfe_ntd=ntd)
    cfg = world["cfg"]
    bev = port_mm(world).eval()
    models = {}
    for backend in ("dense", "sparse"):
        sd = bev.state_dict()
        models[backend] = MM(dataclasses.replace(
            cfg.model.mm, voxfe_backend=backend)).eval()
        models[backend].load_state_dict(
            sparse_state(sd) if backend == "sparse" else sd)
    img = torch.from_numpy(world["img"])
    sv = port_vox(dict(world, cfg=cfg.replace(model=dataclasses.replace(
        cfg.model, mm=dataclasses.replace(cfg.model.mm,
                                          voxfe_backend="sparse")))))
    outs = {}
    with torch.inference_mode():
        outs["bev"] = bev(img, port_vox(world))
        outs["bev-sparse-input"] = bev(img, sv)
        for backend, mm in models.items():
            outs[backend] = mm(img, sv)
    for name in ("bev-sparse-input", "dense", "sparse"):
        for k in KEYS:
            close(outs[name][k].numpy(), outs["bev"][k].numpy(),
                  BACKEND_TOL, f"{name} {k}")
