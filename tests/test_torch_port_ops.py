"""The port's three kernel modules against the JAX Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here those are held
against the JAX Pallas functions run as the JAX tests run them on the CPU
(interpret mode), at small shapes, from the same numpy inputs.  CPU calls
must leave the launch counters at 0.  The kernels themselves are compared
with their plain versions on the card in ``test_torch_port_cuda.py``; K3's
conv phases' launch geometry is replayed here on the CPU, and every kernel
source is scanned for build switches: each compiles one design.
"""

import glob
import os
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from agplace_tpu.ops.pallas import bev_block_sm as jax_block
from agplace_tpu.ops.pallas import bev_down as jax_down
from agplace_tpu.ops.pallas import ode_step as jax_ode
from agplace_tpu.sparse import bev_grid as jax_bev
from agplace_tpu_torch import ops
from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build, bev_block_sm, bev_down, ode_step
from agplace_tpu_torch.sparse import bev_grid as bg

torch.set_num_threads(1)

TOL_FP32 = dict(rtol=1e-5, atol=1e-5)  # K1: fp32 throughout
# K2/K3: bf16 activations with fp32 accumulation; the existing Pallas
# parity tests hold the kernels to the XLA path at the same 2e-2
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _f32(a):
    return np.asarray(a, np.float32)


# --------------------------------------------------------------------- K1
@pytest.mark.parametrize("act", ["relu", "tanh", "sigmoid", "id"])
def test_k1_plain_matches_pallas(act):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 64)) / 8).astype(np.float32)
    b = (rng.standard_normal(64) * 0.1).astype(np.float32)
    want = jax_ode.fused_euler_ode(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), 10, 0.1, act)
    ops.reset_launches()
    got = ode_step.fused_euler_ode(_t(x), _t(w), _t(b), 10, 0.1, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_FP32)
    assert ode_step.fused_euler_ode.launches == 0


@pytest.mark.parametrize("act", ["relu", "tanh"])
@pytest.mark.parametrize("batch", [1, 33])
def test_k1_path_matches_pallas_at_ragged_batch(batch, act):
    """The port's K1 path at the model's width D = 256 and a batch that
    leaves a ragged row tile (``ode_tiling``: 8 rows a cluster) against
    JAX's ``fused_euler_ode``."""
    rng = np.random.default_rng(batch)
    x = rng.standard_normal((batch, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 256)) / 16).astype(np.float32)
    b = (rng.standard_normal(256) * 0.1).astype(np.float32)
    want = jax_ode.fused_euler_ode(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), 10, 0.1, act)
    assert ode_step.ode_tiling(batch, 256).tiles * ode_step.ROWS > batch
    ops.reset_launches()
    got = ode_step.fused_euler_ode(_t(x), _t(w), _t(b), 10, 0.1, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_FP32)
    assert ode_step.fused_euler_ode.launches == 0


@pytest.mark.parametrize("batch", [1, 2, 31, 32, 33, 128, 129])
def test_k1_tiling_covers_every_row_and_column_once(batch):
    """Each (row, column) of x is computed and written by exactly one block
    of ``ode_tiling``'s grid; a cluster's blocks share its rows and split
    W's columns; the kernel takes the geometry as is."""
    t = ode_step.ode_tiling(batch, ode_step.DIM)
    assert t.grid == t.tiles * t.cluster and t.tiles == -(-batch // t.rows)
    # 4 pointers, batch, n_steps, dt, act, the fields, the stream
    sig = _build._SIGNATURES["agp_ode_euler"]
    assert len(sig) == 4 + 4 + len(t.args()) + 1
    _replay_k1_blocks(t, batch, ode_step.DIM)


def _replay_k1_blocks(t, batch, dim):
    """Every (row, column < dim) of the padded state [B, t.dim] is computed
    and written by exactly one block; the padded columns only by blocks
    that also hold real ones or none.  Cluster instances: a cluster's
    blocks share its rows and split W's columns evenly; the grid instance:
    every block all rows."""
    assert t.dim % ode_step.DIM_STEP == 0 and dim <= t.dim < dim + 128
    seen = np.zeros((batch, t.dim), np.int64)
    grid = isinstance(t, ode_step.OdeGridTiling)
    for blk in range(t.grid):
        rows, cols = ode_step.ode_block(t, blk, batch)
        if grid:
            assert rows == range(batch) and len(cols) == t.band // 4
        else:
            assert len(cols) == t.dim // t.cluster
            same = ode_step.ode_block(t, blk - blk % t.cluster, batch)[0]
            assert rows == same  # the cluster's rows
        seen[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("batch,dim", [(32, 128), (32, 512), (33, 1),
                                       (33, 100), (5, 600), (33, 1024),
                                       (32, 1025), (32, 2048), (3, 2176),
                                       (3, 2177), (3, 7000), (3, 7100),
                                       (2, 27136)])
def test_k1_tiling_takes_every_width(batch, dim):
    """Any D, each on its instance (W resident in a cluster up to 512,
    across the grid up to GRID_MAX_DIM = 2176, the wide instance above, 4,
    2 or 1 rows a cluster as its shared memory allows), padded to a
    multiple of 128: ``ode_block``'s replay covers every row and column
    once at the padded width."""
    t = ode_step.ode_tiling(batch, dim)
    inst = ("resident" if dim <= 512 else
            "grid" if dim <= 2176 else "wide")
    assert ode_step.ode_instance(batch, dim) == inst
    if inst == "grid":
        assert t.args() == (t.dim, t.dim // 32, t.dim // 4, 128,
                            min(8, -(-batch // 4)))
    else:
        assert t.resident == (dim <= 512)
        rows = 4 if inst != "wide" else ode_step.wide_rows(t.dim)
        assert rows == (4 if dim <= 7040 else 2 if dim <= 13952 else 1)
        assert t.args() == (t.dim, int(t.resident), rows, 8,
                            -(-batch // rows), -(-batch // rows) * 8)
    _replay_k1_blocks(t, batch, dim)


@pytest.mark.parametrize("batch,dim", [(0, 256), (32, 0), (32, 27137)])
def test_k1_tiling_refuses_other_widths(batch, dim):
    """An empty x (JAX's kernel refuses it too) and D past the wide
    instance's one row of state in shared memory."""
    with pytest.raises(ValueError, match=r"fused_euler_ode: x \["):
        ode_step.ode_tiling(batch, dim)


# --------------------------------------------------------------------- K2
def _grid(rng, b, xy, z, c0, density=0.3):
    mask = rng.uniform(size=(b, xy, xy, z)) < density
    feats = rng.standard_normal((b, xy, xy, z, c0)).astype(np.float32)
    feats = np.where(mask[..., None], feats, 0.0).reshape(b, xy, xy, z * c0)
    return feats, mask


def _affine(rng, c, z):
    inv = 1.0 / np.sqrt(rng.uniform(0.5, 1.5, c) + 1e-5)
    scale = rng.uniform(0.5, 1.5, c)
    s = inv * scale
    b = rng.normal(0, 0.1, c) - rng.normal(0, 0.1, c) * s
    return np.tile(s, z).astype(np.float32), np.tile(b, z).astype(np.float32)


def _k2_inputs(xy, z, c0, c1, k0, b=2, seed=0):
    rng = np.random.default_rng(seed)
    feats, mask = _grid(rng, b, xy, z, c0)
    k0w = (rng.standard_normal((k0, k0, k0, c0, c1)) * 0.2).astype(np.float32)
    kdw = (rng.standard_normal((2, 2, 2, c1, c1)) * 0.2).astype(np.float32)
    zo = me_down_align(z)[2]
    s0, b0 = _affine(rng, c1, z)
    sd, bd = _affine(rng, c1, zo)
    return feats, mask, k0w, kdw, s0, b0, sd, bd


@pytest.mark.parametrize("xy,z,c0,c1,k0",
                         [(32, 4, 1, 16, 5), (16, 2, 3, 8, 3),
                          (32, 3, 1, 16, 5)])
def test_k2_plain_matches_pallas(xy, z, c0, c1, k0):
    feats, mask, k0w, kdw, s0, b0, sd, bd = _k2_inputs(xy, z, c0, c1, k0)
    w0_j = jax_bev.fold_w2_stride1(jnp.asarray(k0w), z)
    wd_j = jax_bev.fold_w2_k2s2(jnp.asarray(kdw), z)
    want, m_want = jax_down.fused_conv0_down0(
        jnp.asarray(feats, jnp.bfloat16), jnp.asarray(mask), w0_j,
        jnp.asarray(s0), jnp.asarray(b0), wd_j, jnp.asarray(sd),
        jnp.asarray(bd), z=z)

    w0 = bg.fold_w2_stride1(_t(k0w), z)
    wd = bg.fold_w2_k2s2(_t(kdw), z)
    np.testing.assert_array_equal(w0.numpy(), np.asarray(w0_j))
    np.testing.assert_array_equal(wd.numpy(), np.asarray(wd_j))
    ops.reset_launches()
    got, m_got = bev_down.fused_conv0_down0(
        _t(feats, torch.bfloat16), torch.from_numpy(mask), w0, _t(s0),
        _t(b0), wd, _t(sd), _t(bd), z=z)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(m_got.numpy(), np.asarray(m_want))
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **TOL_BF16)
    assert bev_down.fused_conv0_down0.launches == 0


# --------------------------------------------------------------------- K3
def _k3_inputs(z, cin, c, xy, b, seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.random((b, xy, xy, z)) < 0.3
    x = rng.standard_normal((b, xy, xy, z, cin)).astype(np.float32)
    x = np.where(mask[..., None], x, 0).reshape(b, xy, xy, z * cin)
    k1 = (rng.standard_normal((3, 3, 3, cin, c))
          * np.sqrt(2 / (27 * cin))).astype(np.float32)
    k2 = (rng.standard_normal((3, 3, 3, c, c))
          * np.sqrt(2 / (27 * c))).astype(np.float32)
    kd = (rng.standard_normal((1, 1, 1, cin, c))
          * np.sqrt(2 / cin)).astype(np.float32)
    k_eca = 3 if c < 128 else 5
    w_eca = rng.standard_normal(k_eca).astype(np.float32)
    aff = [_affine(rng, c, z) for _ in range(3)]
    return x, mask, k1, k2, kd, w_eca, aff


@pytest.mark.parametrize("z,cin,c,xy,b", [(2, 64, 64, 16, 2),
                                          (4, 32, 32, 8, 3),
                                          (2, 32, 64, 16, 2),
                                          (2, 64, 128, 8, 3)])
def test_k3_plain_matches_pallas(z, cin, c, xy, b):
    x, mask, k1, k2, kd, w_eca, aff = _k3_inputs(z, cin, c, xy, b)
    (s1, b1), (s2, b2), (sd, bd) = aff
    ds = cin != c
    jkw = {}
    tkw = {}
    if ds:
        jkw = dict(wd=jax_bev.fold_w2_stride1(jnp.asarray(kd), z),
                   scale_d=jnp.asarray(sd), bias_d=jnp.asarray(bd))
        tkw = dict(wd=bg.fold_w2_stride1(_t(kd), z), scale_d=_t(sd),
                   bias_d=_t(bd))
    want = jax_block.fused_eca_block_sm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask),
        jax_bev.fold_w2_stride1(jnp.asarray(k1), z),
        jax_bev.fold_w2_stride1(jnp.asarray(k2), z), jnp.asarray(s1),
        jnp.asarray(b1), jnp.asarray(s2), jnp.asarray(b2),
        jnp.asarray(w_eca), z=z, **jkw)
    ops.reset_launches()
    got = bev_block_sm.fused_eca_block_sm(
        _t(x, torch.bfloat16), torch.from_numpy(mask),
        bg.fold_w2_stride1(_t(k1), z), bg.fold_w2_stride1(_t(k2), z),
        _t(s1), _t(b1), _t(s2), _t(b2), _t(w_eca), z=z, **tkw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **TOL_BF16)
    # masked structure: exactly zero at unoccupied cells
    mf = np.repeat(mask, c, axis=-1)
    assert np.all(got.float().numpy()[~mf] == 0)
    assert bev_block_sm.fused_eca_block_sm.launches == 0


def _tma_box(src, start, box):
    """A TMA box of ``src`` as the hardware reads it: dims, ``start`` and
    ``box`` innermost first; cells outside ``src`` (negative or past the
    end) read zero.  Returns the box outermost first."""
    out = torch.zeros(box[::-1], dtype=src.dtype)
    s_src, s_out = [], []
    for dim, s0, n in zip(src.shape[::-1], start, box):
        lo, hi = max(s0, 0), max(min(s0 + n, dim), max(s0, 0))
        s_src.append(slice(lo, hi))
        s_out.append(slice(lo - s0, hi - s0))
    out[tuple(s_out[::-1])] = src[tuple(s_src[::-1])]
    return out


@pytest.mark.parametrize("b,xd,yd,zci,zco", [(2, 5, 20, 128, 256),
                                             (1, 4, 4, 256, 512),
                                             (2, 8, 8, 128, 128),
                                             (1, 12, 12, 64, 128)])
def test_k3_conv_tiling_covers_the_conv(b, xd, yd, zci, zco):
    """The conv phases' launch geometry (``conv3x3_tiling`` /
    ``conv3x3_coords``, what the kernel's TMA boxes read) replayed on the
    CPU: per block and K step one zero-filled x box times two w boxes,
    accumulated over the steps, gives the 'same' 3x3 conv exactly
    (small-integer inputs: every sum is exact)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-2, 3, (b, xd, yd, zci), generator=g).double()
    w = torch.randint(-2, 3, (3, 3, zci, zco), generator=g).double()
    t = bev_block_sm.conv3x3_tiling(b, xd, yd, zci, zco)
    assert (t.npx, t.npy) == (-(-xd // 8), -(-yd // 16))
    assert t.grid == b * t.npx * t.npy * zco // 128
    assert t.steps == 9 * zci // 64 and t.x_dims == (zci, yd, xd, b)
    assert t.x_box == (64, 16, 8, 1) and t.w_box == (64, 64)
    # the kernel takes the geometry as is: 7 pointers, epi, z, the fields
    assert t.args() == (zci, yd, xd, b, 64, 16, 8, 1, zco, 9 * zci, 64, 64,
                        t.npx, t.npy, t.ntn, t.steps, t.grid)
    sig = _build._SIGNATURES["agp_conv3x3"]
    assert len(sig) == 7 + 2 + len(t.args()) + 1
    wm = w.reshape(9 * zci, zco)
    got = torch.full((b, xd, yd, zco), float("nan"), dtype=torch.float64)
    for blk in range(t.grid):
        acc = torch.zeros(128, 128, dtype=torch.float64)
        for step in range(t.steps):
            xc, wcs = bev_block_sm.conv3x3_coords(t, blk, step)
            a = _tma_box(x, xc, t.x_box).reshape(128, 64)
            acc += a @ torch.cat([_tma_box(wm, wc, t.w_box) for wc in wcs],
                                 dim=1)
        (_, y0, x0, bb), ((n0, _), _) = bev_block_sm.conv3x3_coords(t, blk, 0)
        x0, y0 = x0 + 1, y0 + 1  # step 0 is tap (0, 0): offset (-1, -1)
        nx, ny = min(8, xd - x0), min(16, yd - y0)
        got[bb, x0:x0 + nx, y0:y0 + ny, n0:n0 + 128] = \
            acc.reshape(8, 16, 128)[:nx, :ny]
    want = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    assert torch.equal(got, want.permute(0, 2, 3, 1))


def test_k3_width_rule():
    """K3's conv phases run on the sm90 kernel where C is a multiple of 8,
    Zcin of the 64-channel TMA slab and Zcout of the 128-channel tile, on
    the z-banded GEMM at every other width (C = 50, Z*C = 8192 included),
    and raise on widths no z-fold gives; P1 keeps 32 and 32."""
    def args(zci, zco):
        return (torch.zeros(1, 4, 4, zci, dtype=torch.bfloat16),
                torch.zeros(3, 3, zci, zco), torch.zeros(3, 3, zco, zco))

    assert bev_block_sm.check_block_args("k3", *args(128, 128), 2) == \
        (1, 4, 4, 128, 128)
    for zci, zco, inst in ((128, 128, "sm90"), (96, 128, "zband+sm90"),
                           (128, 192, "zband"), (64, 64, "zband"),
                           (100, 100, "zband"), (8192, 8192, "sm90")):
        wd = None if zci == zco else torch.zeros(1, 1, zci, zco)
        assert bev_block_sm.check_block_args("k3", *args(zci, zco), 2,
                                             wd)[3:] == (zci, zco)
        assert bev_block_sm.block_instance(zci, zco, 2) == inst
    for zci, zco, z in ((96, 96, 33), (101, 101, 2), (64, 64, 0)):
        with pytest.raises(ValueError, match="no z-fold"):
            bev_block_sm.check_block_args("k3", *args(zci, zco), z)
    assert bev_block_sm.check_block_args("p1", *args(96, 96), 2, None, 32,
                                         32)[3:] == (96, 96)
    with pytest.raises(ValueError, match="multiples of the kernel's"):
        bev_block_sm.check_block_args("p1", *args(80, 80), 2, None, 32, 32)


def _phase_args(zci=128, zco=128, z=2, xy=6, b=2):
    g = torch.Generator().manual_seed(0)
    mask = torch.rand(b, xy, xy, z, generator=g) < 0.4
    x = torch.randn(b, xy, xy, zci, generator=g).to(torch.bfloat16)
    w = torch.randn(3, 3, zci, zco, generator=g) * 0.05
    return (x, mask, w, torch.rand(zco, generator=g) + 0.5,
            torch.randn(zco, generator=g) * 0.1)


@pytest.mark.parametrize("zc", [128, 100])
@pytest.mark.parametrize("pool", [False, True])
def test_k3_conv_phase_takes_plain_on_cpu(pool, zc):
    """On CPU tensors ``conv_phase`` is its plain version, even for a
    strided x, and launches nothing, at the sm90 widths and at C = 50 (the
    z-banded instance's on the card); phase 2's pool is the fp32 masked
    sum of g."""
    x, mask, w, s, b = _phase_args(zc, zc)
    z = 2
    strided = torch.stack([x, -x], dim=-1)[..., 0]  # non-contiguous, == x
    ops.reset_launches()
    got = bev_block_sm.conv_phase(strided, mask, w, s, b, z, pool)
    want = bev_block_sm.conv_phase_plain(x, mask, w, s, b, z, pool)
    if pool:
        g, sums = got
        assert torch.equal(g, want[0]) and torch.equal(sums, want[1])
        m = mask.repeat_interleave(g.shape[-1] // z, dim=-1)
        assert torch.allclose(sums, (g.float() * m).sum(dim=(1, 2)),
                              rtol=1e-5, atol=1e-4)
    else:
        assert torch.equal(got, want)
    assert sum(ops.launches().values()) == 0


@pytest.mark.parametrize("change,match", [
    (dict(x=torch.float32), "bf16 x and bool mask"),
    (dict(mask=torch.uint8), "bf16 x and bool mask"),
    (dict(mask_z=4), "conv_phase: x"),
    (dict(zco=64), "conv_phase: x"),  # phase 2 maps Zcout to Zcout
    (dict(zci=101, zco=101), "no z-fold"),  # C = 101/2
])
def test_k3_conv_phase_checks_its_arguments(change, match):
    """``conv_phase`` rejects, before any dispatch, what its kernel's
    tensor maps cannot read: a non-bf16 x, a non-bool or misshapen mask, a
    phase 2 that changes width, widths no z-fold gives."""
    x, mask, w, s, b = _phase_args(change.get("zci", 128),
                                   change.get("zco", 128))
    if "x" in change:
        x = x.to(change["x"])
    if "mask" in change:
        mask = mask.to(change["mask"])
    if "mask_z" in change:
        mask = mask.repeat(1, 1, 1, 2)
    with pytest.raises(ValueError, match=match):
        bev_block_sm.conv_phase(x, mask, w, s, b, 2, pool=True)


# ----------------------------------------------------------- dispatch rule
def test_dispatch_rule():
    cpu = torch.zeros(2)
    assert _build.on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError, match="mixed or unsupported"):
        _build.on_cuda(cpu, torch.zeros(2, device="meta"))
    with pytest.raises(ValueError, match="unsupported activation"):
        ode_step.fused_euler_ode(cpu[None], torch.zeros(2, 2), cpu, act="gelu")


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: False)  # no toolkit, no built library
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# --------------------------------------------------- one design per source
CSRC = sorted(os.path.basename(p)
              for p in glob.glob(os.path.join(_build.SRC_DIR, "*.cu*")))
CONDITIONAL = re.compile(r"^\s*#\s*(if|ifdef|ifndef|elif|else|endif)\b",
                         re.MULTILINE)


def test_the_scan_sees_every_kernel_source():
    assert set(CSRC) >= {"probe_block_sm_v2.cu", "down0_sm90.cuh",
                         "sm90.cuh", "ode_step.cu"}
    assert set(CSRC) == {os.path.basename(p) for p in _build._sources()}


@pytest.mark.parametrize("name", CSRC)
def test_kernel_source_compiles_one_design(name):
    """Every kernel source builds exactly the design that ships: no
    preprocessor conditional and no build switch a ``-D`` could set."""
    src = open(os.path.join(_build.SRC_DIR, name)).read()
    assert not CONDITIONAL.findall(src)
    assert "AGP_" not in src
