"""The z-banded implicit GEMM (``csrc/zband_sm90.cu``) replayed on the CPU,
the per-slab channel padding around it, and K1's wide instance.

The kernel takes every tensor-map box and K step from
``ops/zband.zband_tiling`` and runs only on the card
(``chip_smoke.py`` [widths]).  Here its schedule is replayed tile by tile:
per K step one zero-filled box of x's 5-D view (``_tma_box``: TMA's
out-of-range zeros) times the live weight block's box, over the 16-deep
steps the kernel issues (``mma_depth``), on integer-valued fp32 inputs so
that every sum is exact.  The replay visits only each output slab's live
input slabs; its result must equal the dense folded conv (the fold's zero
blocks multiplied too) exactly, for the 3x3x3 stride-1 fold and the k2s2
down at z in (1, 3, 5, 36, 72) and C in (8, 20, 60, 212).  Where the
dense fold would outgrow a CPU test (it grows as Z^2), the reference is
the 3-D conv of the unfolded map, which the fold is by construction, on
the z window of each replayed output slab; past z = 5 the replay covers
the first, the middle and the last output slab.

The wrappers run every slab at a multiple of 8 channels: padded with
zeros at the slab's end, the plain versions give the unpadded results
(K2, K4 and K3's convs exactly; K3's ECA mean to fp32 rounding).  K1 above D = 1024
runs the wide instance; its plain version matches JAX's interpreted
``fused_euler_ode`` there.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from agplace_tpu.ops.pallas import ode_step as jax_ode
from agplace_tpu_torch import ops
from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import (bev_block_sm, bev_down, bev_head,
                                   ode_step, zband)
from agplace_tpu_torch.ops.widths import (c_step, pad_fold, pad_slabs,
                                          unpad_slabs)
from agplace_tpu_torch.sparse import bev_grid as bg
from tests.test_torch_port_stage0 import _tma_box

C0_N = bev_head.C0_BLOCK_N

# two threads, as the train test files sorted before this one set them:
# every xdist worker imports every test file, the last setting wins, and
# the parallel train tests hold their two-thread worker processes
# bit-equal to the pytest process
torch.set_num_threads(2)

ZS, CS = (1, 3, 5, 36, 72), (8, 20, 60, 212)
# the folded weight's elements up to which the reference is the dense
# folded conv itself
DENSE_MAX = 20_000_000


def _ints(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2, 3, shape, generator=g).float()


def _replayed_slabs(zo):
    return range(zo) if zo <= 5 else (0, zo // 2, zo - 1)


def _conv3d_slab(fold, x, kern, z, o):
    """Output slab ``o`` of the 3-D conv of the unfolded map x [B, X, Y,
    Z*Ci] with ``kern`` [k, k, k, Ci, Co] (the 3x3x3 'same' conv, or the
    k2s2 down with ME's z pairing) on its z window: [B, Xo, Yo, Co]."""
    b, xd, yd, _ = x.shape
    k, ci = kern.shape[2], kern.shape[3]
    x5 = x.reshape(b, xd, yd, z, ci).permute(0, 4, 1, 2, 3)  # [B,Ci,X,Y,Z]
    if fold == zband.FOLD_S1:
        x5, zs, stride, pad = F.pad(x5, (1, 1)), 1, 1, 1
    else:
        lo, hi, _ = me_down_align(z)
        x5, zs, stride, pad = F.pad(x5, (lo, hi)), 2, 2, 0
    y = F.conv3d(x5[..., zs * o:zs * o + k], kern.permute(4, 3, 0, 1, 2),
                 stride=(stride, stride, 1), padding=(pad, pad, 0))
    return y[..., 0].permute(0, 2, 3, 1)


def replay_zband(fold, b, xd, yd, z, ci, co):
    """``zband_tiling``'s schedule over x [b, xd, yd, z*ci] and the fold of
    a [k, k, k, ci, co] kernel, slabs padded to C8, on the replayed output
    slabs; every replayed output element written by exactly one tile,
    every box past its live channels zeros.  The reference: the dense
    folded conv (``bev_grid``'s fold) where it is small, else the 3-D
    conv, whose weight view of each slab is then built block by block
    (the fold's (zi, o) block is kern[:, :, t] at zi = zs o + t - zlo)."""
    k = 3 if fold == zband.FOLD_S1 else 2
    kern = _ints((k, k, k, ci, co), 1)
    x = _ints((b, xd, yd, z * ci), 0)
    ci8, c8 = c_step(ci), c_step(co)
    t = zband.zband_tiling(fold, b, xd, yd, z, ci8, c8, sms=132)
    zo, c = t.zo, co
    assert (t.nks, t.ntn) == (-(-ci8 // 64), -(-c8 // 64))
    dense = k * k * z * ci * zo * co <= DENSE_MAX
    xp = pad_slabs(x, z, ci8)
    # the tensor maps' views, outermost first
    if fold == zband.FOLD_S1:
        xv = xp.reshape(b, xd, yd, z, ci8)
    else:
        xv = xp.reshape(b * t.Xo, 2, t.Yo, 2 * z, ci8)
    if dense:
        w = (bg.fold_w2_stride1 if fold == zband.FOLD_S1
             else bg.fold_w2_k2s2)(kern, z)
        want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        stride=1 if fold == zband.FOLD_S1 else 2,
                        padding=1 if fold == zband.FOLD_S1 else 0).permute(
                            0, 2, 3, 1)
        wv = pad_fold(w, z, ci8, zo, c8).reshape(t.taps, z, ci8, zo, c8)
    got = torch.full((b, t.Xo, t.Yo, zo * c8), float("nan"))
    for o in _replayed_slabs(zo):
        if not dense:  # slab o's column of the weight view, alone
            wo = torch.zeros(t.taps, z, ci8, 1, c8)
            for s in range(t.zk):
                zi = t.zs * o + s - t.zlo
                if 0 <= zi < z:
                    wo[:, zi, :ci, 0, :co] = kern[:, :, s].reshape(t.taps,
                                                                   ci, co)
        for tile in range(t.tiles):
            bb, x0, y0, to, n0, live, steps = zband.zband_tile(t, tile)
            if to != o:
                continue
            acc = torch.zeros(128, 64)
            for i in range(steps):
                zi, tap, c0, xs, ws = zband.zband_step(t, tile, i)
                assert zi in live and c0 < ci8
                depth = zband.mma_depth(t, i)
                a = _tma_box(xv, xs, t.x_box).reshape(128, 64)
                wb = (_tma_box(wv, ws, t.w_box) if dense else _tma_box(
                    wo, (ws[0], 0, *ws[2:]), t.w_box)).reshape(64, 64)
                assert not a[:, depth:].any() and not wb[depth:].any()
                acc += a[:, :depth] @ wb[:depth]
            cols = min(64, c8 - n0)
            nx, ny = min(8, t.Xo - x0), min(16, t.Yo - y0)
            region = got[bb, x0:x0 + nx, y0:y0 + ny,
                         o * c8 + n0:o * c8 + n0 + cols]
            assert torch.isnan(region).all()  # each element once
            region[:] = acc.reshape(8, 16, 64)[:nx, :ny, :cols]
        slab = got[..., o * c8:(o + 1) * c8]
        assert not slab[..., c:].any()  # the padded channels: zeros
        ref = (want[..., o * c:(o + 1) * c] if dense
               else _conv3d_slab(fold, x, kern, z, o))
        assert torch.equal(slab[..., :c], ref), (fold, z, ci, co, o)


def replay_conv0(b, xd, yd, z, c0, c1, k0):
    """``conv0_tiling``'s schedule (K4's conv0 off its sm90 tiles, ``csrc/
    head_conv0_sm90.cu``) over feats [b, xd, yd, z*c0] and the fold of a
    [k0, k0, k0, c0, c1] kernel, output slabs padded to C1_8: per tile and
    slice the halo boxes land in a flat image of the shared memory ([block]
    [x][y][8 channels], NaN between the blocks), each MMA step's A operand
    is read through the no-swizzle descriptor's addressing (LBO: one cell
    with a pair of taps, else the next block; SBO: one halo row), B is the
    two weight boxes.  The result must equal the dense folded conv
    exactly, every output element written once, the padded channels
    zero.  Returns the tiling."""
    h = k0 // 2
    kern = _ints((k0, k0, k0, c0, c1), 1)
    c18 = c_step(c1)
    w = pad_fold(bg.fold_w2_stride1(kern, z), 1, z * c0, z, c18)
    x = _ints((b, xd, yd, z * c0), 0)
    t = bev_head.conv0_tiling(b, xd, yd, k0, c0, z, c18, sms=132)
    zc18 = z * c18
    assert t.x_dims == (c_step(z * c0), yd, xd, b)
    assert t.w_dims == (zc18, z * c0, k0, k0)
    want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=h).permute(0, 2, 3, 1)
    xv = F.pad(x, (0, t.x_dims[0] - z * c0))  # the tensor map's view
    yh, xh = t.x_box[1], t.x_box[2]
    hs = -(-xh * yh * 16 // 128) * 128 // 16  # a block's stride, 16 B units
    lbo, kk_n = (1, 1) if t.pair else (hs, t.sb // 2)
    # element of (GEMM row 8 g + r, K column 8 kb + e) from a start of 0
    g, r, kb, e = torch.meshgrid(*(torch.arange(n) for n in (8, 8, 2, 8)),
                                 indexing="ij")
    idx = ((g * yh + r + kb * lbo) * 8 + e).reshape(64, 16)
    got = torch.full((b, xd, yd, zc18), float("nan"), dtype=x.dtype)
    for tile in range(t.tiles):
        bb, x0, y0, n0, a0 = bev_head.conv0_tile(t, tile)
        lo, hi = bev_head.conv0_window(k0, c0, c18, z, n0)
        assert a0 == lo - lo % 8 and hi - a0 <= 8 * t.nb
        # the tile's output columns read no fold row outside its window
        cols = slice(n0, n0 + C0_N)
        assert not w[:, :, :lo, cols].any() and not w[:, :, hi:, cols].any()
        acc = torch.zeros(128, C0_N, dtype=x.dtype)
        for sl in range(t.nsl):
            ch0 = a0 + 8 * t.sb * sl
            halo = torch.full((t.sb, hs * 8), float("nan"), dtype=x.dtype)
            for c in range(t.sb):
                box = _tma_box(xv, (ch0 + 8 * c, y0 - h, x0 - h, bb),
                               t.x_box)
                halo[c, :xh * yh * 8] = box.reshape(-1)
            halo = halo.reshape(-1)
            for i in range(t.steps):
                for dx, dy in bev_head.conv0_step(t, i):
                    wb = torch.cat([_tma_box(w, (n0 + 64 * half, ch0, dy,
                                                 dx), t.w_box).reshape(-1, 64)
                                    for half in (0, 1)], dim=1)
                    for wg in (0, 1):
                        start = (8 * wg + dx) * yh + dy
                        for kk in range(kk_n):
                            a = halo[idx + (start + 2 * kk * hs) * 8]
                            acc[64 * wg:64 * wg + 64] += (
                                a @ wb[16 * kk:16 * kk + 16])
        nx, ny = min(16, xd - x0), min(8, yd - y0)
        ncol = min(C0_N, zc18 - n0)
        region = got[bb, x0:x0 + nx, y0:y0 + ny, n0:n0 + ncol]
        assert torch.isnan(region).all()  # each element once
        region[:] = acc.reshape(16, 8, C0_N)[:nx, :ny, :ncol]
    assert not got.reshape(b, xd, yd, z, c18)[..., c1:].any()
    assert torch.equal(got, want), (z, c0, c1, k0)
    return t


@pytest.mark.parametrize("k0", [1, 3, 5])
@pytest.mark.parametrize("c1", [5, 24, 108])
@pytest.mark.parametrize("c0", [1, 3])
@pytest.mark.parametrize("z", [1, 2, 3, 6, 40])
def test_conv0_window_replay_is_the_folded_conv(z, c0, c1, k0):
    """K4's conv0 off its sm90 tiles, replayed (``replay_conv0``) on 18 x
    10 cells (ragged 16 x 8 patches; the halo reads zeros at every edge):
    the dense folded conv exactly, with windows that clip at both z edges
    (their boxes past Z*C0 read zeros), a pair of taps per MMA step where
    every window fits 8 channels, up to 8 blocks (z = 40, C0 = 3, C1 = 5,
    k0 = 5: 16 slabs a tile, 20 x 3 channels)."""
    t = replay_conv0(1, 18, 10, z, c0, c1, k0)
    assert t.pair == (t.nb == 1) and t.nsl == 1
    assert t.nb == (8 if (z, c0, c1, k0) == (40, 3, 5, 5) else t.nb)
    assert t.tg * t.steps == k0 * (-(-k0 // 2) if t.pair else k0)


@pytest.mark.parametrize("z,c0,k0", [(12, 8, 5), (40, 5, 3)])
def test_conv0_window_past_64_channels_is_sliced(z, c0, k0):
    """A window wider than 64 channels (C0 = 8 and 5: 12 and 16 slabs of
    C1_8 = 8 a tile) runs in slices of 8 blocks, each with its own halo,
    one accumulator across them: still the folded conv exactly."""
    t = replay_conv0(1, 18, 10, z, c0, 5, k0)
    assert t.nb > 8 and (t.sb, t.nsl) == (8, 2)


def test_conv0_k_loop_reads_the_window_not_the_fold():
    """At W5's widths (z = 40, C0 = 1, C1 = 108 -> 112) a tile's K is 25
    taps of 16 channels, not the dense fold's 25 x 40, five taps a ring
    stage; at W2's (z = 6, C1 = 24) every window fits 8 channels: 15 MMA
    steps of two taps, three a stage."""
    w5 = bev_head.conv0_tiling(4, 128, 128, 5, 1, 40, 112, sms=132)
    assert (w5.pair, w5.nb, w5.sb, w5.nsl, w5.tg, w5.steps) == (0, 2, 2, 1,
                                                                 5, 5)
    assert 16 * w5.tg * w5.steps * (w5.sb // 2) < 5 * 5 * 40
    w2 = bev_head.conv0_tiling(32, 128, 128, 5, 1, 6, 24, sms=132)
    assert (w2.pair, w2.nb, w2.tg, w2.steps, w2.w_box) == (1, 1, 3, 5,
                                                           (64, 8, 2, 1))
    assert (w2.x_dims, w2.x_box) == ((8, 128, 128, 32), (8, 13, 20, 1))
    assert w2.tiles == 32 * 8 * 16 * 2 and w2.grid == 264


@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("z", ZS)
def test_s1_replay_is_the_folded_conv(z, c):
    """The 3x3 'same' conv (K3's phases): 9 x 18 cells, so the patches are
    ragged in x and y and the halo reads zeros at every edge."""
    replay_zband(zband.FOLD_S1, 1, 9, 18, z, c, c)


@pytest.mark.parametrize("c", CS)
@pytest.mark.parametrize("z", ZS)
def test_k2s2_replay_is_the_folded_conv(z, c):
    """The k2s2 down (K2, K4's down0): 2 x 18 x 36 cells -> 9 x 18, so the
    last x patch of item 0 reads rows of item 1 (never stored) and item
    1's reads past the map (zeros); ME's z pairing at odd z // 2."""
    replay_zband(zband.FOLD_K2S2, 2, 18, 36, z, c, c)


def test_live_slabs_are_the_folds_band():
    """Output slab zo's live input slabs: zo - 1 .. zo + 1 for the 3x3x3
    fold, 2 zo + t - lo for the k2s2 one, clipped; every output slab has
    at least one."""
    for z in range(1, 80):
        s1 = zband.zband_tiling(zband.FOLD_S1, 1, 8, 8, z, 8, 8, 132)
        k2 = zband.zband_tiling(zband.FOLD_K2S2, 1, 8, 8, z, 8, 8, 132)
        lo, _, zo = me_down_align(z)
        assert k2.zo == zo
        for o in range(z):
            assert zband.live_slabs(s1, o) == range(max(o - 1, 0),
                                                    min(o + 2, z))
        for o in range(zo):
            live = zband.live_slabs(k2, o)
            assert len(live) >= 1 and list(live) == [
                zi for zi in (2 * o - lo, 2 * o + 1 - lo) if 0 <= zi < z]


# ------------------------------------------------------- the pad round trip
def _dyadic(shape, seed, lo=-4, hi=5, scale=0.25):
    """Values on a coarse dyadic grid: products and short sums are exact in
    fp32, so the padded and unpadded plain versions agree bit for bit."""
    return _ints(shape, seed).clamp(lo, hi) * scale


def _affine(c, z, seed):
    g = torch.Generator().manual_seed(seed)
    s = torch.randint(1, 4, (c,), generator=g).float() * 0.5
    b = torch.randint(-2, 3, (c,), generator=g).float() * 0.25
    return s.repeat(z), b.repeat(z)


def _mask(b, xd, z, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, xd, xd, z, generator=g) < 0.5


@pytest.mark.parametrize("z,c1,c2", [(3, 20, 12), (5, 60, 60), (6, 25, 30)])
def test_k2_pad_round_trip(z, c1, c2):
    """K2's down0 (``down0_plain``) on slabs padded to C8 gives the
    unpadded result: the padded channels' BN0 scale and bias are 0."""
    zo = me_down_align(z)[2]
    b, xd = 2, 8
    mask = _mask(b, xd, z, 0)
    g0 = _dyadic((b, xd, xd, z * c1), 1)
    s0, b0 = _affine(c1, z, 2)
    wd = bg.fold_w2_k2s2(_dyadic((2, 2, 2, c1, c2), 3), z)
    sd, bd = _affine(c2, zo, 4)
    want = bev_down.down0_plain(g0, mask, s0, b0, wd, sd, bd, z=z)[0]
    c18, c28 = c_step(c1), c_step(c2)
    got = bev_down.down0_plain(
        pad_slabs(g0, z, c18), mask, pad_slabs(s0, z, c18),
        pad_slabs(b0, z, c18), pad_fold(wd, z, c18, zo, c28),
        pad_slabs(sd, zo, c28), pad_slabs(bd, zo, c28), z=z)[0]
    assert not got.reshape(b, xd // 2, xd // 2, zo, c28)[..., c2:].any()
    assert torch.equal(unpad_slabs(got, zo, c2), want)


@pytest.mark.parametrize("residual", ["identity", "downsample"])
@pytest.mark.parametrize("z,c", [(2, 20), (3, 60), (4, 30)])
def test_k3_pad_round_trip(z, c, residual):
    """K3's block (``eca_block_plain``: both conv phases, the ECA pool and
    its zero-padded 1-D conv over C, the combine) on slabs padded to C8
    gives the unpadded result, with the identity and the 1x1 residual."""
    b, xd = 2, 6
    ci = c if residual == "identity" else c // 2 + 3
    mask = _mask(b, xd, z, 5)
    x = bg.mask_bev(_dyadic((b, xd, xd, z * ci), 6), mask, z)
    w1 = bg.fold_w2_stride1(_dyadic((3, 3, 3, ci, c), 7, scale=0.125), z)
    w2 = bg.fold_w2_stride1(_dyadic((3, 3, 3, c, c), 8, scale=0.125), z)
    s1, b1 = _affine(c, z, 9)
    s2, b2 = _affine(c, z, 10)
    w_eca = torch.tensor([0.5, -0.25, 1.0, 0.75, -0.5])
    ds = {}
    if residual == "downsample":
        sd, bd = _affine(c, z, 11)
        ds = dict(wd=bg.fold_w2_stride1(_dyadic((1, 1, 1, ci, c), 12), z),
                  scale_d=sd, bias_d=bd)
    want = bev_block_sm.eca_block_plain(x, mask, w1, w2, s1, b1, s2, b2,
                                        w_eca, z, **ds)
    ci8, c8 = c_step(ci), c_step(c)
    pds = {}
    if ds:
        pds = dict(wd=pad_fold(ds["wd"], z, ci8, z, c8),
                   scale_d=pad_slabs(ds["scale_d"], z, c8),
                   bias_d=pad_slabs(ds["bias_d"], z, c8))
    got = bev_block_sm.eca_block_plain(
        pad_slabs(x, z, ci8), mask, pad_fold(w1, z, ci8, z, c8),
        pad_fold(w2, z, c8, z, c8), *(pad_slabs(v, z, c8) for v in
                                      (s1, b1, s2, b2)), w_eca, z, **pds)
    assert not got.reshape(b, xd, xd, z, c8)[..., c:].any()
    # the convs agree bit for bit; ECA's masked mean sums fp32 over the
    # C8-wide layout, in another order: fp32 rounding apart
    err = (unpad_slabs(got, z, c) - want).abs().max()
    assert err <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("z,c0,c1,c2,k0", [(4, 1, 20, 20, 5),
                                           (6, 1, 30, 12, 3),
                                           (3, 2, 60, 60, 1)])
def test_k4_pad_round_trip(z, c0, c1, c2, k0):
    """K4's head (``head_plain``: conv0 with its fp32 BN0 epilogue, then
    down0) with conv0's output slabs padded to C8 (w0's columns and the
    affines: zeros) gives the unpadded result."""
    zo = me_down_align(z)[2]
    b, xd = 2, 8
    mask = _mask(b, xd, z, 13)
    feats = bg.mask_bev(_dyadic((b, xd, xd, z * c0), 14), mask, z)
    w0 = bg.fold_w2_stride1(_dyadic((k0, k0, k0, c0, c1), 15), z)
    s0, b0 = _affine(c1, z, 16)
    wd = bg.fold_w2_k2s2(_dyadic((2, 2, 2, c1, c2), 17), z)
    sd, bd = _affine(c2, zo, 18)
    want = bev_head.head_plain(feats, mask, w0, s0, b0, wd, sd, bd, z=z)[0]
    c18, c28 = c_step(c1), c_step(c2)
    got = bev_head.head_plain(
        feats, mask, pad_fold(w0, z, c0, z, c18), pad_slabs(s0, z, c18),
        pad_slabs(b0, z, c18), pad_fold(wd, z, c18, zo, c28),
        pad_slabs(sd, zo, c28), pad_slabs(bd, zo, c28), z=z)[0]
    assert torch.equal(unpad_slabs(got, zo, c2), want)


def test_pad_slabs_puts_the_zeros_at_each_slabs_end():
    t = torch.arange(1, 13).float().reshape(1, 12)  # z = 3 slabs of C = 4
    p = pad_slabs(t, 3, 8)
    assert p.reshape(3, 8)[:, 4:].eq(0).all()
    assert torch.equal(p.reshape(3, 8)[:, :4], t.reshape(3, 4))
    assert torch.equal(unpad_slabs(p, 3, 4), t)
    assert pad_slabs(t, 3, 4) is t and unpad_slabs(t, 3, 4) is t
    w = torch.arange(2 * 6).float().reshape(1, 1, 2, 6)  # zi 2 x 1, zo 3 x 2
    pw = pad_fold(w, 2, 8, 3, 8).reshape(2, 8, 3, 8)
    assert torch.equal(pw[:, :1, :, :2], w.reshape(2, 1, 3, 2))
    assert pw.sum() == w.sum()


# ------------------------------------------------------- K1 past D = 512
@pytest.mark.parametrize("dim", [1536, 2048])
def test_k1_wide_plain_matches_pallas(dim):
    """K1 at D = 1536 and 2048 (the grid instance's widths since it
    replaced the wide one up to GRID_MAX_DIM): its plain version against
    JAX's ``fused_euler_ode`` (interpreted), K1's fp32 tolerance; the
    tiling takes the grid instance, 32 groups of 4 blocks, each group a
    band of D / 32 columns, each block a quarter of its k range."""
    rng = np.random.default_rng(dim)
    x = rng.standard_normal((3, dim)).astype(np.float32)
    w = (rng.standard_normal((dim, dim)) / np.sqrt(dim)).astype(np.float32)
    b = (rng.standard_normal(dim) * 0.1).astype(np.float32)
    want = jax_ode.fused_euler_ode(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), 10, 0.1, "relu")
    t = ode_step.ode_tiling(3, dim)
    assert ode_step.ode_instance(3, dim) == "grid"
    assert t.args() == (dim, dim // 32, dim // 4, 128, 1) and t.rows == 4
    ops.reset_launches()
    got = ode_step.fused_euler_ode(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b), 10, 0.1, "relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert ode_step.fused_euler_ode.launches == 0


@pytest.mark.parametrize("batch", [1, 3, 32, 128])
@pytest.mark.parametrize("dim", [520, 1024, 1536, 2048, 2176])
def test_k1_grid_tiling_covers_every_output_once(batch, dim):
    """The grid instance: each of the 128 blocks (one an SM, co-resident)
    sums its k-slice of its group's column band for every row, the
    slices of a group cover the band's k range once, and the columns
    each block finishes (``ode_block``) cover every (row, column) of the
    padded state exactly once; W's tile, the x slice and the partial tile
    fit a block's shared memory up to the capacity, 2176 (W read once);
    the scratch holds the other state, two buffers of partial tiles and
    the 33 barrier counters."""
    t = ode_step.ode_tiling(batch, dim)
    assert isinstance(t, ode_step.OdeGridTiling)
    assert t.grid == ode_step.GRID_BLOCKS == 128
    assert t.rg == min(8, -(-batch // 4)) and t.band % 4 == 0
    assert ode_step.grid_smem(t.dim, t.rg) <= ode_step.GRID_SMEM
    groups = t.grid // ode_step.GRID_GROUP
    assert t.band * groups == t.dim and t.kslice * 4 == t.dim
    assert t.scratch_floats(batch) == (batch * t.dim + 256 * t.rows * t.band
                                       + 33)
    seen = np.zeros((batch, t.dim), np.int64)
    w_rows = np.zeros((t.dim, t.dim), np.int64)
    for blk in range(t.grid):
        rows, cols = ode_step.ode_block(t, blk, batch)
        assert rows == range(batch)
        seen[:, cols.start:cols.stop] += 1
        c0 = blk // ode_step.GRID_GROUP * t.band
        k0 = blk % ode_step.GRID_GROUP * t.kslice
        assert c0 <= cols.start and cols.stop <= c0 + t.band
        w_rows[k0:k0 + t.kslice, c0:c0 + t.band] += 1
    assert (seen == 1).all() and (w_rows == 1).all()


@pytest.mark.parametrize("batch", [1, 32])
def test_k1_grid_instance_ends_at_its_capacity(batch):
    """``ode_instance`` names the grid instance on (512, 2176] and the
    wide one above: at 2304 W's tile (162 KB a block) and the x slice of
    32 rows (74 KB) no longer fit."""
    assert [ode_step.ode_instance(batch, d) for d in (512, 513, 2176, 2177,
                                                      2304)] == [
        "resident", "grid", "grid", "wide", "wide"]
    assert ode_step.grid_smem(2176) <= ode_step.GRID_SMEM
    assert ode_step.grid_smem(2304) > ode_step.GRID_SMEM
