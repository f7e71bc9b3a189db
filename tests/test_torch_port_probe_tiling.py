"""The probe kernels' launch geometry, replayed on the CPU.

P2's Hopper route (``csrc/probe_down_v2.cu``) and P1's conv phases
(``csrc/probe_block_sm_v2.cu``) take every tensor-map box, patch and tap
row from ``ops/probe_down_v2.down_concat_tiling`` and
``ops/probe_block_sm_v2.concat_conv_tiling``; the kernels run only on the
card (``test_torch_port_cuda.py``).  Here the boxes are gathered from small
integer tensors as TMA reads them (zero outside the tensor) and multiplied
in float64, so every sum is exact:

* P2: per tile, the steps' plane boxes cover the K = 4*Z*C1 product
  exactly once, and the replay with the BN0 prologue and the epilogue
  equals ``down_concat_plain``;
* P1: the halo box, written into a NaN-filled buffer of the kernel's
  shared-memory size, and each tap's rows ``(px+dx)*HY + py+dy`` of it
  reproduce ``_conv3x3_concat`` at chunk 1, 3 and 9, with ragged patches,
  Z*C = 96 (zero-filled channels and a ragged N tile) and full multi-tile
  maps;
* both width rules take every width the parent took.
"""

import itertools

import pytest
import torch

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build, bev_block_sm
from agplace_tpu_torch.ops import probe_block_sm_v2 as p1
from agplace_tpu_torch.ops import probe_down_v2 as p2
from agplace_tpu_torch.sparse import bev_grid as bg
from tests.test_torch_port_stage0 import _ints, _tma_box

torch.set_num_threads(1)


# --------------------------------------------------------------------- P2
def _replay_down_concat(b, xo, yo, zc1, zc2, z, sms):
    """Walk ``down_concat_tiling``'s tiles block by block as the persistent
    kernel does.  Per tile and K step: plane p's zero-filled box, BN0 +
    relu + the z-mask of parity p applied to it (bf16, as the kernel's
    prologue), times the two wd boxes; the epilogue on the float64 sum.
    Small integers keep every bf16 value and every sum exact."""
    g = torch.Generator().manual_seed(0)
    planes = [_ints((b, xo, yo, zc1), p) for p in range(4)]
    wd = _ints((2, 2, zc1, zc2), 4)
    mask = torch.rand(b, 2 * xo, 2 * yo, z, generator=g) < 0.5
    s0 = torch.ones(zc1)
    b0 = torch.randint(-1, 2, (zc1,), generator=g).float()
    sd, bd = torch.ones(zc2), torch.randint(-2, 3, (zc2,), generator=g).float()
    lo, hi, zo = me_down_align(z)
    m_out = bg.mask_down(mask, (0, 0), (0, 0), (lo, hi))
    t = p2.down_concat_tiling(b, xo, yo, zc1, zc2, sms)
    assert t.g_dims == (zc1, yo, xo, b) and t.g_box == (64, 16, 8, 1)
    assert t.w_dims == (zc2, 4 * zc1) and t.w_box == (64, 64)
    assert (t.npx, t.npy, t.nn) == (-(-xo // 8), -(-yo // 16), zc2 // 128)
    assert t.tiles == b * t.npx * t.npy * t.nn and t.grid == min(t.tiles, sms)
    assert t.steps == 4 * zc1 // 64
    # the kernel takes the geometry as is: 12 pointers, z, zo, the fields
    assert len(_build._SIGNATURES["agp_down_concat_sm90"]) == \
        12 + 2 + len(t.args()) + 1
    wm = wd.reshape(4 * zc1, zc2)
    c1 = zc1 // z
    got = torch.full((b, xo, yo, zc2), float("nan"), dtype=torch.float64)
    for blk in range(t.grid):
        for tile in range(blk, t.tiles, t.grid):
            acc = torch.zeros(128, 128, dtype=torch.float64)
            covered = torch.zeros(4, zc1, dtype=torch.int64)
            for step in range(t.steps):
                plane, gc, wcs = p2.down_concat_coords(t, tile, step)
                c0, yo0, xo0, bb = gc
                covered[plane, c0:c0 + 64] += 1
                a = _tma_box(planes[plane], gc, t.g_box).reshape(8, 16, 64)
                # the z-mask of plane (px, py) at (xo, yo): the full-
                # resolution cell (2 xo + px, 2 yo + py)
                px, py = divmod(plane, 2)
                mz = _tma_box(mask[:, px::2, py::2].double(),
                              (0, yo0, xo0, bb), (z, 16, 8, 1))
                mc = mz.reshape(8, 16, z).repeat_interleave(c1, dim=-1)
                act = torch.relu(a * s0[c0:c0 + 64].double()
                                 + b0[c0:c0 + 64].double())
                act = act * mc[..., c0:c0 + 64]
                acc += act.reshape(128, 64) @ torch.cat(
                    [_tma_box(wm, wc, t.w_box) for wc in wcs], dim=1)
            assert bool((covered == 1).all())  # K covered exactly once
            _, (_, yo0, xo0, bb), ((n0, _), _) = p2.down_concat_coords(
                t, tile, 0)
            nx, ny = min(8, xo - xo0), min(16, yo - yo0)
            assert torch.isnan(got[bb, xo0:xo0 + nx, yo0:yo0 + ny,
                                   n0:n0 + 128]).all()  # each cell once
            got[bb, xo0:xo0 + nx, yo0:yo0 + ny, n0:n0 + 128] = acc.reshape(
                8, 16, 128)[:nx, :ny]
    # the epilogue's rounding points: bf16(acc), the affine in bf16
    bf = torch.bfloat16
    got = got.to(bf) * sd.to(bf) + bd.to(bf)
    got = bg.mask_bev(torch.relu(got), m_out, zo)
    want = p2.down_concat_gemm_plain([p.to(bf) for p in planes], mask, s0,
                                     b0, wd, sd, bd, m_out, z=z)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,xo,yo,zc1,zc2,z", [
    (3, 10, 18, 256, 128, 4),   # ragged patches, KITTI-360's widths
    (1, 8, 16, 512, 256, 8),    # z = 8: two N tiles
    (2, 4, 20, 1024, 512, 16),  # z = 16: four N tiles, 64 K steps
])
def test_p2_tiling_covers_the_concat_product(b, xo, yo, zc1, zc2, z):
    _replay_down_concat(b, xo, yo, zc1, zc2, z, sms=3)


def test_p2_plane_order_is_the_folds():
    """Step k's plane p = k0 // Z*C1 is wd's tap (dx, dy) = divmod(p, 2),
    rows k0 .. k0 + 63 of the [2, 2, Z*C1, Zo*C2] fold read row-major."""
    zc1 = 128
    t = p2.down_concat_tiling(1, 8, 16, zc1, 128, sms=132)
    wd = _ints((2, 2, zc1, 128), 3)
    wm = wd.reshape(4 * zc1, 128)
    for step in range(t.steps):
        plane, (c0, _, _, _), ((_, k0), _) = p2.down_concat_coords(t, 0, step)
        assert k0 == plane * zc1 + c0
        dx, dy = divmod(plane, 2)
        assert torch.equal(wm[k0:k0 + 64], wd[dx, dy, c0:c0 + 64])


def _stage0_widths():
    """Every (Z*C1, Zo*C2, z) the parent's rule (``check_stage0_args``)
    takes with Z*C1 up to 1024 and Zo*C2 up to 512."""
    for z, zc1, zc2 in itertools.product((2, 3, 4, 8, 16),
                                         range(32, 1025, 32),
                                         range(8, 513, 8)):
        zo = me_down_align(z)[2]
        if (zc1 // z) % 8 == 0 and zc1 % z == 0 and zc2 % zo == 0 \
                and (zc2 // zo) % 8 == 0:
            yield zc1, zc2, z


def test_p2_width_rule_takes_every_width_the_parent_took():
    """Each width runs on one of the two routes: K2's Hopper main loop
    where its tiles divide the widths, the wmma kernel elsewhere; the
    Hopper route takes exactly K2's rule."""
    n_hopper = n = 0
    for zc1, zc2, z in _stage0_widths():
        n += 1
        hopper = p2.on_hopper_tiles(zc1, zc2, z)
        n_hopper += hopper
        assert hopper == (zc1 % 64 == 0 and zc2 % 128 == 0
                          and zc1 % (8 * z) == 0
                          and zc2 % (2 * me_down_align(z)[2]) == 0)
    assert n > 1000 and 0 < n_hopper < n
    for zc1, zc2, z in ((32, 16, 4), (256, 128, 4), (96, 32, 2)):
        b, xo = 1, 2
        zo = me_down_align(z)[2]
        planes = [torch.zeros(b, xo, xo, zc1, dtype=torch.bfloat16)] * 4
        out = p2.down_concat_gemm(
            planes, torch.zeros(b, 2 * xo, 2 * xo, z, dtype=torch.bool),
            torch.ones(zc1), torch.zeros(zc1), torch.zeros(2, 2, zc1, zc2),
            torch.ones(zc2), torch.zeros(zc2),
            torch.zeros(b, xo, xo, zo, dtype=torch.bool), z=z)
        assert out.shape == (b, xo, xo, zc2)


def test_p2_gemm_checks_its_arguments():
    planes = [torch.zeros(1, 2, 2, 256, dtype=torch.bfloat16)] * 4
    args = (torch.zeros(1, 4, 4, 4, dtype=torch.bool), torch.ones(256),
            torch.zeros(256), torch.zeros(2, 2, 256, 128), torch.ones(128),
            torch.zeros(128), torch.zeros(1, 2, 2, 2, dtype=torch.bool))
    with pytest.raises(ValueError, match="four planes"):
        p2.down_concat_gemm(planes[:3], *args, z=4)
    with pytest.raises(ValueError, match="mask"):
        p2.down_concat_gemm(planes, args[0][..., :2], *args[1:], z=4)
    with pytest.raises(ValueError, match="widths"):
        p2.down_concat_gemm([p[..., :48] for p in planes], *args, z=4)


# --------------------------------------------------------------------- P1
def _replay_concat_conv(b, xd, yd, zci, zco, chunk):
    """Walk ``concat_conv_tiling``'s tiles block by block as the persistent
    kernel does.  At a slab's first stage the halo box is written into a
    NaN-filled buffer of the kernel's halo size (its rows rounded up to
    1 KB); each stage's taps read rows (px+dx)*HY + py+dy of it (the
    stage's KC channels) against the stage's two w boxes of that tap."""
    x = _ints((b, xd, yd, zci), 0)
    w = _ints((3, 3, zci, zco), 1)
    t = p1.concat_conv_tiling(b, xd, yd, zci, zco, chunk, 5)
    px, py = p1.PATCH
    kc = p1.stage_channels(chunk)
    hy = t.x_box[1]
    assert t.patch == (px, py) and px * py == 128
    assert t.x_dims == (zci, yd, xd, b) and t.x_box == (64, hy, px + 2, 1)
    assert hy >= py + 2
    assert t.w_dims == (zco, zci, 9) and t.w_box == (64, kc, chunk)
    assert (t.npx, t.npy, t.ntn) == (-(-xd // px), -(-yd // py),
                                     -(-zco // 128))
    assert t.steps == -(-zci // 64) * (9 // chunk) * (64 // kc)
    assert t.tiles == b * t.npx * t.npy * t.ntn
    assert t.grid == min(t.tiles, 5 * p1.BLOCKS_PER_SM)
    # the kernel takes the geometry as is: 7 pointers, epi, chunk, z, the
    # fields
    assert len(_build._SIGNATURES["agp_p1_conv_sm90"]) == \
        7 + 3 + len(t.args()) + 1
    rows = -(-(px + 2) * hy * 128 // 1024) * 1024 // 128  # the buffer
    w3 = w.reshape(9, zci, zco)
    m = torch.arange(128)
    cell_x, cell_y = m // py, m % py  # GEMM row m: patch cell (px, py)
    got = torch.full((b, xd, yd, zco), float("nan"), dtype=torch.float64)
    for blk in range(t.grid):
        for tile in range(blk, t.tiles, t.grid):
            acc = torch.zeros(128, 128, dtype=torch.float64)
            buf = None
            taps_seen = torch.zeros(9, -(-zci // 64) * 64, dtype=torch.int64)
            for step in range(t.steps):
                halo, wcs, taps, koff = p1.concat_conv_coords(t, tile, step)
                if halo is not None:
                    buf = torch.full((rows, 64), float("nan"),
                                     dtype=torch.float64)
                    buf[:(px + 2) * hy] = _tma_box(x, halo, t.x_box).reshape(
                        (px + 2) * hy, 64)
                    c0 = halo[0]
                wbox = torch.cat([_tma_box(w3, wc, t.w_box) for wc in wcs],
                                 dim=2)  # [chunk, kc, 128]
                assert len(taps) == chunk
                for ti, tap in enumerate(taps):
                    dx, dy = divmod(tap, 3)
                    a = buf[(cell_x + dx) * hy + cell_y + dy, koff:koff + kc]
                    acc += a @ wbox[ti]
                    taps_seen[tap, c0 + koff:c0 + koff + kc] += 1
            assert bool((taps_seen == 1).all())  # every (tap, channel) once
            (_, y0, x0, bb), ((n0, _, _), _), _, _ = p1.concat_conv_coords(
                t, tile, 0)
            x0, y0 = x0 + 1, y0 + 1  # the halo starts one cell early
            nx, ny, nn = min(px, xd - x0), min(py, yd - y0), min(128,
                                                                 zco - n0)
            assert torch.isnan(got[bb, x0:x0 + nx, y0:y0 + ny,
                                   n0:n0 + nn]).all()  # each cell once
            got[bb, x0:x0 + nx, y0:y0 + ny, n0:n0 + nn] = acc.reshape(
                px, py, 128)[:nx, :ny, :nn]
    want = p1._conv3x3_concat(x.to(torch.bfloat16), w, chunk).double()
    assert torch.equal(got, want)


@pytest.mark.parametrize("chunk", [1, 3, 9])
@pytest.mark.parametrize("b,xd,yd,zci,zco", [
    (2, 12, 20, 128, 256),  # ragged patches, two K slabs, two N tiles
    (1, 9, 9, 96, 96),      # Z*C = 96: a slab and an N tile zero-filled
    (1, 4, 4, 64, 128),     # a map smaller than the patch
    (2, 17, 9, 192, 64),    # ragged in x and y, three K slabs
    (1, 16, 16, 256, 256),  # a full multi-tile map, two N tiles
])
def test_p1_halo_and_tap_rows_replay_the_concat_conv(b, xd, yd, zci, zco,
                                                     chunk):
    """The shipped patch, halo pitch and stage sizes at every chunk."""
    _replay_concat_conv(b, xd, yd, zci, zco, chunk)


def test_p1_shipped_route_is_a_replayed_one():
    t = p1.concat_conv_tiling(32, 64, 64, 128, 128, 3, 132)
    assert t.patch == p1.PATCH
    assert t.x_box[1] == p1.HY
    assert t.grid == 132 * p1.BLOCKS_PER_SM
    assert t.tiles == 32 * 64 * 64 // 128
    assert t.steps == 2 * 3 * 64 // p1.stage_channels(3)


def test_p1_width_rule_takes_every_width_the_parent_took():
    """The parent took Z*Cin and Z*Cout in multiples of 32 with Z*Cout/z a
    multiple of 8 (``check_block_args(..., 32, 32)``); every such width
    gets a geometry the kernel's host check accepts (its rule, mirrored)."""
    n = 0
    for z, zci, zco in itertools.product((1, 2, 4), range(32, 1025, 32),
                                         range(32, 1025, 32)):
        if zco % z or (zco // z) % 8:
            continue
        bev_block_sm.check_widths("p1", zci, zco, z, 32, 32)
        for chunk in p1.CHUNKS:
            t = p1.concat_conv_tiling(1, 8, 16, zci, zco, chunk, 132)
            kc = p1.stage_channels(chunk)
            assert t.x_box[0] == 64 and t.w_box == (64, kc, chunk)
            assert t.ntn == -(-zco // 128) and (zco // z) % 2 == 0
            assert t.steps == -(-zci // 64) * (9 // chunk) * (64 // kc)
        n += 1
    assert n > 1000


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("chunk", [1, 3, 9])
def test_p1_conv_phase_takes_plain_on_cpu(chunk, pool):
    """On CPU tensors ``concat_conv_phase`` is its plain version, and that
    is the block's arithmetic: the phase-1 output and the phase-2 pool of
    ``eca_block_concat_plain``."""
    g = torch.Generator().manual_seed(0)
    mask = torch.rand(2, 8, 8, 2, generator=g) < 0.5
    x = torch.randn(2, 8, 8, 64, generator=g).to(torch.bfloat16)
    w = torch.randn(3, 3, 64, 96, generator=g) * 0.05
    s, bias = torch.rand(96, generator=g) + .5, torch.randn(96, generator=g)
    got = p1.concat_conv_phase(x, mask, w, s, bias, 2, pool, chunk)
    want = p1.concat_conv_phase_plain(x, mask, w, s, bias, 2, pool, chunk)
    for a, b_ in zip(got if pool else (got,), want if pool else (want,)):
        assert torch.equal(a, b_)
    if pool:
        g2, sums = got
        assert sums.dtype == torch.float32 and sums.shape == (2, 96)
        assert g2.dtype == torch.bfloat16


@pytest.mark.parametrize("bad", ["chunk", "mask", "width", "dtype"])
def test_p1_conv_phase_checks_its_arguments(bad):
    x = torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16)
    mask = torch.zeros(1, 4, 4, 2, dtype=torch.bool)
    w = torch.zeros(3, 3, 64, 128)
    s = torch.ones(128)
    kw = dict(chunk=3)
    if bad == "chunk":
        kw["chunk"] = 2
    elif bad == "mask":
        mask = mask[..., :1]
    elif bad == "width":
        x, w = x[..., :48], w[:, :, :48]
    else:
        x = x.float()
    with pytest.raises(ValueError):
        p1.concat_conv_phase(x, mask, w, s, s, 2, False, **kw)
