"""The BEV stage-0 kernels' launch geometry, replayed on the CPU.

K2's down0 GEMM (``csrc/bev_down.cu``) and K4's fused head
(``csrc/bev_head.cu``) take every tensor-map box, patch and im2col index
from ``ops/bev_down.down0_tiling`` and ``ops/bev_head.head_tiling``; the
kernels run only on the card (``test_torch_port_cuda.py``).  Here the boxes
are gathered from small integer tensors as TMA reads them (zero outside the
tensor) and multiplied in float64, so every sum is exact: K2's replay must
give the k2s2 down0 conv, K4's halo + im2col replay conv0's im2col and
conv0 itself at every parity.  At the widths the sm90 tiles do not take,
K2's down0 and K4's down0 half run the z-banded GEMM of
``csrc/zband_sm90.cu`` (replayed by ``test_torch_port_zband.replay_zband``)
and K4's conv0 the window GEMM of ``csrc/head_conv0_sm90.cu`` (replayed by
``test_torch_port_zband.replay_conv0``); the wmma implicit GEMM of
``csrc/conv_igemm.cuh`` that K3's 1x1 residual and K6's narrow conv
phases run is replayed the same way (``ops/widths.igemm_a_source`` over
``igemm_grid``'s blocks).  The shape rules name the instance each width
runs, raise with a message on shapes no z-fold gives, and the plain
versions keep their results.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from agplace_tpu_torch import ops
from agplace_tpu_torch.ops import _build, bev_down, bev_head, widths, zband
from agplace_tpu_torch.sparse import bev_grid as bg

torch.set_num_threads(1)


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


def _ints(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2, 3, shape, generator=g).double()


# --------------------------------------------------------------------- K2
def _replay_down0(b, x, y, zc1, zc2, sms):
    """Walk ``down0_tiling``'s tiles block by block as the persistent
    kernel does; per tile and K step one zero-filled box of the 5-D view of
    g times the two wd boxes of the tile's 128 output channels,
    accumulated over the steps, must give the k2s2 down0 conv exactly."""
    g0 = _ints((b, x, y, zc1), 0)
    wd = _ints((2, 2, zc1, zc2), 1)
    t = bev_down.down0_tiling(b, x, y, zc1, zc2, sms)
    xo, yo = x // 2, y // 2
    assert t.g_dims == (2 * zc1, yo, 2, xo, b)
    assert t.g_box == (64, 16, 1, 8, 1) and t.w_box == (64, 64)
    assert t.w_dims == (zc2, 4 * zc1) and t.steps == 4 * zc1 // 64
    assert (t.npx, t.npy, t.nn) == (-(-xo // 8), -(-yo // 16), zc2 // 128)
    assert t.tiles == b * t.npx * t.npy * t.nn
    assert t.grid == min(t.tiles, sms)
    # the kernel takes the geometry as is: 9 pointers, z, zo, the fields
    assert len(_build._SIGNATURES["agp_bev_down"]) == 9 + 2 + len(t.args()) + 1
    view = g0.reshape(b, xo, 2, yo, 2 * zc1)  # [B, Xo, 2, Yo, 2*Z*C1]
    wm = wd.reshape(4 * zc1, zc2)
    got = torch.full((b, xo, yo, zc2), float("nan"), dtype=torch.float64)
    for blk in range(t.grid):
        for tile in range(blk, t.tiles, t.grid):
            acc = torch.zeros(128, 128, dtype=torch.float64)
            for step in range(t.steps):
                gc, wcs = bev_down.down0_coords(t, tile, step)
                a = _tma_box(view, gc, t.g_box).reshape(128, 64)
                acc += a @ torch.cat([_tma_box(wm, wc, t.w_box)
                                      for wc in wcs], dim=1)
            (_, yo0, _, xo0, bb), ((n0, _), _) = bev_down.down0_coords(
                t, tile, 0)
            nx, ny = min(8, xo - xo0), min(16, yo - yo0)
            assert torch.isnan(got[bb, xo0:xo0 + nx, yo0:yo0 + ny,
                                   n0:n0 + 128]).all()  # each cell once
            got[bb, xo0:xo0 + nx, yo0:yo0 + ny, n0:n0 + 128] = acc.reshape(
                8, 16, 128)[:nx, :ny]
    want = F.conv2d(g0.permute(0, 3, 1, 2), wd.permute(3, 2, 0, 1), stride=2)
    assert torch.equal(got, want.permute(0, 2, 3, 1))


@pytest.mark.parametrize("b,x,y,zc1", [(3, 20, 36, 64), (1, 16, 32, 128),
                                       (2, 4, 8, 256), (1, 34, 18, 64)])
def test_k2_down0_tiling_covers_the_conv(b, x, y, zc1):
    """Zo*C2 = 128 (KITTI-360's): ragged patches (Xo not a multiple of 8,
    Yo not of 16) and B = 3 included, blocks walking several tiles."""
    _replay_down0(b, x, y, zc1, 128, sms=4)


@pytest.mark.parametrize("b,x,y,zc1,zc2", [(2, 18, 34, 512, 256),
                                           (1, 20, 20, 1024, 512)])
def test_k2_down0_tiling_covers_the_conv_over_n_tiles(b, x, y, zc1, zc2):
    """The z = 8 and z = 16 presets' widths: Zo*C2 / 128 N tiles per
    patch, each with its own wd boxes and output channels."""
    _replay_down0(b, x, y, zc1, zc2, sms=3)


def test_k2_tap_order_is_the_folds():
    """Step k's wd rows k0 = 64 k lie in tap (dx, dy) = divmod(k0 // Z*C1,
    2), which is the [2, 2, ...] fold's (dx, dy) in row-major order; the g
    box of that step starts at view column dy * Z*C1 and view row dx."""
    zc1 = 128
    t = bev_down.down0_tiling(1, 16, 32, zc1, 128, sms=132)
    wd = bg.fold_w2_k2s2(_ints((2, 2, 2, zc1 // 2, 64), 2), 2)
    wm = wd.reshape(4 * zc1, 128)
    for step in range(t.steps):
        (c, _, dx, _, _), ((_, k0), _) = bev_down.down0_coords(t, 0, step)
        tap, c0 = divmod(k0, zc1)
        assert (dx, c // zc1) == divmod(tap, 2) and c % zc1 == c0
        assert torch.equal(wm[k0:k0 + 64], wd[dx, tap % 2, c0:c0 + 64])


def test_k2_persistent_grid_visits_every_tile_once():
    t = bev_down.down0_tiling(32, 128, 128, 256, 128, sms=132)
    assert t.tiles == 32 * 8 * 4 and t.grid == 132
    seen = sorted(tile for blk in range(t.grid)
                  for tile in range(blk, t.tiles, t.grid))
    assert seen == list(range(t.tiles))
    assert bev_down.down0_tiling(1, 16, 16, 64, 128, sms=132).grid == 1


def _replay_igemm(x, w, stride, pad):
    """The wmma instance (``conv_igemm.cuh``) replayed block by block: per
    M x N tile of ``igemm_grid``, the A rows gathered column by column
    where ``igemm_a_source`` says (zeros outside the map and past K), the
    B rows of the weight matrix (zeros past K), multiplied over the
    padded K; each output element written by one block."""
    b, h, wy, cin = x.shape
    kh, kw, _, cout = w.shape
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wy + 2 * pad - kw) // stride + 1
    m, k = b * ho * wo, kh * kw * cin
    mt, nt, kt = widths.igemm_grid(m, cout, k)
    bb, ox, oy = torch.meshgrid(torch.arange(b), torch.arange(ho),
                                torch.arange(wo), indexing="ij")
    bb, ox, oy = bb.reshape(-1), ox.reshape(-1), oy.reshape(-1)
    a = torch.zeros(m, kt * widths.IGEMM_BK, dtype=torch.float64)
    for col in range(k):
        (dx, dy), ci = widths.igemm_a_source(col, cin, kw)
        ix, iy = ox * stride + dx - pad, oy * stride + dy - pad
        ok = (ix >= 0) & (ix < h) & (iy >= 0) & (iy < wy)
        a[ok, col] = x[bb[ok], ix[ok], iy[ok], ci]
    wm = torch.zeros(kt * widths.IGEMM_BK, cout, dtype=torch.float64)
    wm[:k] = w.reshape(k, cout)
    got = torch.full((m, cout), float("nan"), dtype=torch.float64)
    bm, bn = widths.IGEMM_BM, widths.IGEMM_BN
    for i in range(mt):
        for j in range(nt):
            rows = slice(i * bm, (i + 1) * bm)
            cols = slice(j * bn, (j + 1) * bn)
            assert torch.isnan(got[rows, cols]).all()  # each element once
            got[rows, cols] = a[rows] @ wm[:, cols]
    want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    stride=stride, padding=pad)
    assert torch.equal(got.reshape(b, ho, wo, cout),
                       want.permute(0, 2, 3, 1))


NO_FOLD = "no z-fold's width"


@pytest.mark.parametrize("x,y,zc1,zc2,z,match", [
    (20, 19, 256, 128, 4, "not even"),
    (20, 20, 320, 128, 5, NO_FOLD),  # Zo = 3: C2 = 128/3
    (20, 20, 256, 128, 33, NO_FOLD),  # z = 33: C1 = 256/33
    (20, 20, 256, 128, 0, NO_FOLD),  # z = 0
    (20, 20, 102, 128, 4, NO_FOLD),  # C1 = 102/4
])
def test_k2_shape_rule_raises(x, y, zc1, zc2, z, match):
    with pytest.raises(ValueError, match=match):
        bev_down.check_down0_args("k2", x, y, zc1, zc2, z)


@pytest.mark.parametrize("zc1,zc2,z", [
    (96, 128, 4),    # Z*C1 not a multiple of the 64-channel slab (C1 = 24)
    (256, 64, 4),    # Zo*C2 below the 128-channel N tile
    (2048, 128, 4),  # Z*C1 above the 1024 the sm90 affine staging holds
    (512, 128, 32),  # z = 32: past the 16 mask bits of a row and tap
    (320, 192, 5),   # z = 5, Zo = 3 (--vox_grid_extent 128 128 5)
    (100, 128, 4),   # C1 = 25
    (8192, 4096, 128),  # Z*C1 > 4096
])
def test_k2_shape_rule_takes(zc1, zc2, z):
    """Widths the sm90 tiles refuse run on the z-banded instance; its
    schedule over those widths, replayed on the CPU, is the down0 conv
    exactly."""
    from tests.test_torch_port_zband import replay_zband

    zo = bev_down.me_down_align(z)[2]
    assert bev_down.check_down0_args("k2", 8, 4, zc1, zc2, z) == "zband"
    replay_zband("k2s2", 1, 8, 4, z, zc1 // z, zc2 // zo)


@pytest.mark.parametrize("zc2", [640, 1024])
def test_k2_shape_rule_bounds_the_n_tiles(zc2):
    """The sm90 instance takes Zo*C2 up to 512 (the down BN's affine is
    staged in shared memory); wider maps run the z-banded one, whose N
    tiles of 64 cover each output slab, at any width; a Zo*C2 that is no
    multiple of Zo raises."""
    assert bev_down.check_down0_args("k2", 20, 20, 64, 512, 4) == "sm90"
    for zc2_ in (zc2, 8 * zc2):
        assert bev_down.check_down0_args("k2", 20, 20, 1024, zc2_,
                                         4) == "zband"
        t = zband.zband_tiling("k2s2", 32, 20, 20, 4, 256, zc2_ // 2, 132)
        assert t.ntn * 64 >= zc2_ // 2 > (t.ntn - 1) * 64
    with pytest.raises(ValueError, match=NO_FOLD):
        bev_down.check_down0_args("k2", 20, 20, 1024, zc2 + 1, 4)


def _stage0_cpu_args(z=4, c1=64, b=2, xy=8, k0=3):
    g = torch.Generator().manual_seed(0)
    zo = bev_down.me_down_align(z)[2]
    mask = torch.rand(b, xy, xy, z, generator=g) < 0.3
    w0 = bg.fold_w2_stride1(torch.randn(k0, k0, k0, 1, c1, generator=g), z)
    wd = bg.fold_w2_k2s2(torch.randn(2, 2, 2, c1, c1, generator=g) * .1, z)
    s0 = torch.rand(z * c1, generator=g) + .5
    b0 = torch.randn(z * c1, generator=g) * .1
    sd = torch.rand(zo * c1, generator=g) + .5
    bd = torch.randn(zo * c1, generator=g) * .1
    return mask, w0, s0, b0, wd, sd, bd


@pytest.mark.parametrize("bad", ["mask_out_shape", "mask_out_dtype",
                                 "mask_dtype", "scale0", "bias_d"])
@pytest.mark.parametrize("kernel", ["k2", "k4"])
def test_stage0_gemms_check_masks_and_affines(kernel, bad):
    """The kernels read both masks and all four affines in full: a wrong
    shape, dtype or length raises before dispatch instead of reading out
    of bounds."""
    z = 4
    mask, w0, s0, b0, wd, sd, bd = _stage0_cpu_args(z)
    feats = mask.to(torch.bfloat16)
    m_out = bg.mask_down(mask, (0, 0), (0, 0), (0, 0))
    if bad == "mask_out_shape":
        m_out = m_out[..., :1]
    elif bad == "mask_out_dtype":
        m_out = m_out.to(torch.uint8)
    elif bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif bad == "scale0":
        s0 = s0[:-2]
    else:
        bd = torch.cat([bd, bd])
    with pytest.raises(ValueError, match="mask|affines"):
        if kernel == "k2":
            g0 = bg.bev_conv2d(feats, w0, 1, (1, 1), (1, 1))
            bev_down.down0_gemm(g0, mask, s0, b0, wd, sd, bd, m_out, z=z)
        else:
            bev_head.head_gemm(feats, mask, w0, s0, b0, wd, sd, bd, m_out,
                               z=z)


def test_k2_down0_gemm_checks_then_takes_plain_on_cpu():
    """``down0_gemm`` applies its shape rule before dispatch; on CPU
    tensors it is ``down0_plain``, and ``conv0_down0_plain`` is conv0
    followed by it."""
    g = torch.Generator().manual_seed(0)
    b, xy, z, c1 = 2, 8, 4, 64
    mask = torch.rand(b, xy, xy, z, generator=g) < 0.3
    feats = mask.to(torch.bfloat16)
    w0 = bg.fold_w2_stride1(torch.randn(3, 3, 3, 1, c1, generator=g), z)
    wd = bg.fold_w2_k2s2(torch.randn(2, 2, 2, c1, c1, generator=g) * .1, z)
    s0 = torch.rand(z * c1, generator=g) + .5
    b0 = torch.randn(z * c1, generator=g) * .1
    sd = torch.rand(2 * c1, generator=g) + .5
    bd = torch.randn(2 * c1, generator=g) * .1
    g0 = bg.bev_conv2d(feats, w0, 1, (1, 1), (1, 1))
    ops.reset_launches()
    want, m_want = bev_down.conv0_down0_plain(feats, mask, w0, s0, b0, wd,
                                              sd, bd, z=z)
    got = bev_down.down0_gemm(g0, mask, s0, b0, wd, sd, bd, m_want, z=z)
    assert torch.equal(got, want)
    assert torch.equal(m_want, bg.mask_down(mask, (0, 0), (0, 0), (0, 0)))
    assert sum(ops.launches().values()) == 0
    # C1 = 25: taken, each slab padded to 32 channels on the card
    narrow = (g0[..., :100], mask, s0[:100], b0[:100], wd[:, :, :100], sd,
              bd)
    assert torch.equal(bev_down.down0_gemm(*narrow, m_want, z=z),
                       bev_down.down0_plain(*narrow, z=z)[0])
    with pytest.raises(ValueError, match=NO_FOLD):
        bev_down.down0_gemm(g0[..., :102], mask, s0[:102], b0[:102],
                            wd[:, :, :102], sd, bd, m_want, z=z)


# --------------------------------------------------------------------- K4
def _halo_view(feats, t):
    """feats as the tensor map views it, outermost first: [1, B, X, Y*4]
    at Z*C0 = 4 (8-byte cells), else [B, X, Y, Z*C0] itself."""
    b, x, y, zc0 = feats.shape
    return feats.reshape(1, b, x, y * 4) if zc0 == 4 else feats


def _head_im2col(halo, k0, zc0, kp, par):
    """The kernel's im2col of one parity from the halo [rows, 36, Z*C0],
    through ``head_im2col``'s word placement: [128, kp]."""
    col = torch.zeros(128, kp, dtype=torch.float64)
    for row in range(128):
        for tap in range(k0 * k0):
            hx, hy, words = bev_head.head_im2col(k0, zc0, row, par, tap)
            assert len(words) == zc0 // 4
            for w, (slab, chunk, off) in enumerate(words):
                k = slab * 64 + chunk * 8 + off // 2
                assert k == zc0 * tap + 4 * w and off in (0, 8)
                col[row, k:k + 4] = halo[hx, hy, 4 * w:4 * w + 4]
    return col


@pytest.mark.parametrize("b,x,y,k0,zc0", [
    (3, 20, 20, 5, 4), (2, 16, 36, 3, 4), (1, 32, 32, 5, 4), (1, 4, 40, 3, 4),
    (2, 20, 20, 5, 8), (1, 16, 36, 3, 8), (1, 20, 20, 5, 16),
    (1, 4, 40, 3, 16)])
def test_k4_halo_and_im2col_replay_conv0(b, x, y, k0, zc0):
    """Per tile one zero-filled halo box of feats ([B, X, Y*4] at Z*C0 = 4,
    [B, X, Y, Z*C0] at 8 and 16); per parity the kernel's im2col of the
    patch's 128 rows from it equals conv0's im2col at the parity's cells
    (border zeros included), its padded depth stays zero, and times the
    zero-padded W0 it gives conv0 exactly."""
    zc1 = 64
    h = k0 // 2
    feats = _ints((b, x, y, zc0), 3)
    w0 = _ints((k0, k0, zc0, zc1), 4)
    t = bev_head.head_tiling(b, x, y, k0, zc0, zc1, 128, sms=132)
    kp = bev_head.head_depth(k0, zc0)
    cells = 2 * bev_head.PATCH_Y + 2 * bev_head.HALO_LEAD
    if zc0 == 4:  # 36 cells of 4 channels: 288 bytes
        assert t.x_dims == (y * 4, x, b, 1)
        assert t.x_box == (cells * 4, 16 + 2 * h, 1, 1)
        # the inner start is 16-byte aligned (8 bf16) at every tile
        assert all(bev_head.head_coords(t, i, k0)[0][0] % 8 == 0
                   for i in range(t.tiles))
    else:  # channels innermost: within TMA's 256-element box limit
        assert t.x_dims == (zc0, y, x, b)
        assert t.x_box == (zc0, cells, 16 + 2 * h, 1)
        assert all(bev_head.head_coords(t, i, k0)[0][0] == 0
                   for i in range(t.tiles))
    assert max(t.x_box) <= 256
    assert kp % 64 == 0 and zc0 * k0 * k0 <= kp < zc0 * k0 * k0 + 64
    assert t.w0_dims[0] == zc1 and t.w0_dims[1] >= kp
    assert t.resident == (zc0 == 4)
    assert t.wd_dims == (128, 4 * zc1)
    assert len(_build._SIGNATURES["agp_bev_head"]) == 10 + 4 + len(t.args()) + 1
    w0p = torch.zeros(kp, zc1, dtype=torch.float64)
    w0p[:zc0 * k0 * k0] = w0.reshape(-1, zc1)
    padded = F.pad(feats, (0, 0, h, h, h, h))  # conv0's zero padding
    conv0 = F.conv2d(feats.permute(0, 3, 1, 2), w0.permute(3, 2, 0, 1),
                     padding=h).permute(0, 2, 3, 1)
    view = _halo_view(feats, t)
    xo, yo = x // 2, y // 2
    for tile in range(t.tiles):
        start, (xo0, yo0, bb, n0) = bev_head.head_coords(t, tile, k0)
        assert n0 == 0
        halo = _tma_box(view, start, t.x_box).reshape(16 + 2 * h, cells, zc0)
        for par in range(4):
            dx, dy = divmod(par, 2)
            col = _head_im2col(halo, k0, zc0, kp, par)
            for row in range(128):
                ox, oy = xo0 + row // 16, yo0 + row % 16
                if ox >= xo or oy >= yo:
                    continue  # the kernel stores no such row
                cx, cy = 2 * ox + dx, 2 * oy + dy
                want = padded[bb, cx:cx + k0, cy:cy + k0].reshape(-1)
                assert torch.equal(col[row, :zc0 * k0 * k0], want)
                assert not col[row, zc0 * k0 * k0:].any()
                assert torch.equal(col[row] @ w0p, conv0[bb, cx, cy])


@pytest.mark.parametrize("b,x,y,k0,zc0,zc1,zc2", [
    (2, 20, 20, 5, 4, 256, 128),   # KITTI-360's widths: W0 resident
    (1, 16, 34, 3, 4, 512, 128),   # Z*C1 > 256: W0 streamed at Z*C0 = 4
    (1, 16, 32, 5, 4, 256, 256),   # two N tiles: W0 streamed at Z*C0 = 4
    (1, 20, 20, 5, 8, 512, 256),   # the z = 8 presets': 2 N tiles
    (1, 16, 32, 5, 16, 1024, 512),  # the z = 16 preset's: 4 N tiles
])
def test_k4_ring_replays_conv0_and_down0(b, x, y, k0, zc0, zc1, zc2):
    """The whole K4 walk replayed in float64 on small integers (every sum
    exact): per tile the halo and per parity the im2col as above; per
    (parity, 64-channel chunk) conv0 from W0's boxes (resident: loaded
    once, ``head_tiling``'s w0 box; streamed: the ring's ``head_step``
    boxes of 128 rows, the MMAs stopping at kp), the activation (relu:
    head_plain's BN0 affine and rounding left out, they are elementwise)
    times the chunk's two wd boxes of the tile's N tile from the ring; the
    blocks of the persistent grid together write every output cell and
    channel once, equal to down0(relu(conv0)), the function head_plain
    computes."""
    h = k0 // 2
    feats = _ints((b, x, y, zc0), 5)
    w0 = _ints((k0, k0, zc0, zc1), 6)
    wd = _ints((2, 2, zc1, zc2), 7)
    t = bev_head.head_tiling(b, x, y, k0, zc0, zc1, zc2, sms=3)
    kp, nch = bev_head.head_depth(k0, zc0), zc1 // 64
    assert t.nn == zc2 // 128 and t.tiles == b * t.npx * t.npy * t.nn
    assert t.resident == (zc0 == 4 and zc1 <= 256 and zc2 == 128)
    w0p = torch.zeros(t.w0_dims[1], zc1, dtype=torch.float64)
    w0p[:zc0 * k0 * k0] = w0.reshape(-1, zc1)
    wm = wd.reshape(4 * zc1, zc2)
    act = torch.relu(F.conv2d(feats.permute(0, 3, 1, 2),
                              w0.permute(3, 2, 0, 1), padding=h))
    want = F.conv2d(act, wd.permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1)
    view = _halo_view(feats, t)
    cells = 2 * bev_head.PATCH_Y + 2 * bev_head.HALO_LEAD
    xo, yo = x // 2, y // 2
    got = torch.full((b, xo, yo, zc2), float("nan"), dtype=torch.float64)
    cols = {}  # a patch's im2col, the same for each of its N tiles
    for blk in range(t.grid):
        for tile in range(blk, t.tiles, t.grid):
            start, (xo0, yo0, bb, n0) = bev_head.head_coords(t, tile, k0)
            if start not in cols:
                halo = _tma_box(view, start, t.x_box).reshape(
                    16 + 2 * h, cells, zc0)
                cols[start] = [_head_im2col(halo, k0, zc0, kp, par)
                               for par in range(4)]
            acc_d = torch.zeros(128, 128, dtype=torch.float64)
            acc0 = torch.zeros(128, 64, dtype=torch.float64)
            for i in range(t.steps):
                kind, par, c, boxes = bev_head.head_step(t, tile, i)
                if kind == "w0":  # streamed: 128 rows of chunk c's columns
                    col0, row0 = boxes
                    box = _tma_box(w0p, boxes, t.w0_box)
                    hi = min(row0 + 128, kp)
                    acc0 += cols[start][par][:, row0:hi] @ box[:hi - row0]
                    continue
                if t.resident:  # W0 loaded once, as SLAB-row boxes
                    acc0 = sum(cols[start][par][:, r:r + 64]
                               @ _tma_box(w0p, (64 * c, r), t.w0_box)
                               for r in range(0, kp, 64))
                assert [wc[1] for wc in boxes] == [par * zc1 + 64 * c] * 2
                acc_d += torch.relu(acc0) @ torch.cat(
                    [_tma_box(wm, wc, t.wd_box) for wc in boxes], dim=1)
                acc0 = torch.zeros(128, 64, dtype=torch.float64)
            nx, ny = min(8, xo - xo0), min(16, yo - yo0)
            assert torch.isnan(got[bb, xo0:xo0 + nx, yo0:yo0 + ny,
                                   n0:n0 + 128]).all()  # each once
            got[bb, xo0:xo0 + nx, yo0:yo0 + ny, n0:n0 + 128] = acc_d.reshape(
                8, 16, 128)[:nx, :ny]
    assert torch.equal(got, want)


def test_k4_head_gemm_takes_plain_on_cpu():
    """``head_gemm`` (K4's kernel with the output mask given) is
    ``head_plain`` on CPU tensors, checks its shape rule first, and
    ``fused_head`` is it plus the output mask; nothing launches."""
    g = torch.Generator().manual_seed(0)
    b, xy, z, c1 = 2, 8, 4, 64
    mask = torch.rand(b, xy, xy, z, generator=g) < 0.3
    args = (mask.to(torch.bfloat16), mask,
            bg.fold_w2_stride1(torch.randn(5, 5, 5, 1, c1, generator=g), z),
            torch.rand(z * c1, generator=g) + .5,
            torch.randn(z * c1, generator=g) * .1,
            bg.fold_w2_k2s2(torch.randn(2, 2, 2, c1, c1, generator=g) * .1,
                            z),
            torch.rand(2 * c1, generator=g) + .5,
            torch.randn(2 * c1, generator=g) * .1)
    ops.reset_launches()
    want, m_out = bev_head.fused_head(*args, z=z)
    assert torch.equal(bev_head.head_gemm(*args, m_out, z=z), want)
    assert torch.equal(want, bev_head.head_plain(*args, z=z)[0])
    assert sum(ops.launches().values()) == 0
    with pytest.raises(ValueError, match=NO_FOLD):
        bev_head.head_gemm(*args[:5], args[5][..., :61], *(a[:61] for a in
                                                         args[6:]),
                           m_out, z=z)


def test_k4_persistent_grid_is_one_block_per_sm():
    t = bev_head.head_tiling(32, 128, 128, 5, 4, 256, 128, sms=132)
    assert t.tiles == 1024 and t.grid == 132
    assert t.x_box == (144, 20, 1, 1)  # the 5.8 KB halo of KITTI
    assert bev_head.head_tiling(1, 8, 8, 5, 4, 256, 128, sms=132).grid == 1


@pytest.mark.parametrize("zc0,k0,zc1,zc2,z,match", [
    (4, 7, 256, 128, 4, "odd and <= 5"),
    (4, 4, 256, 128, 4, "odd and <= 5"),
    (4, 5, 256, 128, 33, NO_FOLD),  # z = 33: C1 = 256/33
    (0, 5, 256, 128, 4, "Z\\*C0 = 0"),
    (4, 5, 256, 131, 4, NO_FOLD),  # C2 = 131/2
])
def test_k4_shape_rule_raises(zc0, k0, zc1, zc2, z, match):
    with pytest.raises(ValueError, match=match):
        bev_head.check_head_args(32, 32, zc0, k0, zc1, zc2, z)


@pytest.mark.parametrize("zc0,k0,zc1,zc2,z", [
    (12, 5, 256, 128, 4),   # Z*C0 off the im2col box widths (C0 = 3)
    (4, 5, 2048, 128, 4),   # Z*C1 > 1024
    (4, 3, 128, 64, 4),     # Zo*C2 = 64
    (6, 5, 192, 128, 6),    # z = 6 (W2 of the smoke's [widths])
    (1, 3, 8, 8, 1),        # z = 1, C1 = 8
    (4100, 3, 40, 20, 4),   # Z*C0 past 4096 (C0 = 1025)
    (4, 5, 8192, 128, 4),   # Z*C1 > 4096
    (4, 3, 128, 60, 4),     # C2 = 30
    (4, 5, 100, 128, 4),    # C1 = 25
    (8, 5, 512, 200, 8),    # C2 = 50
    (40, 1, 4320, 2160, 40),  # k0 = 1, z = 40, C1 = 108, Z*C1 = 4320
])
def test_k4_shape_rule_takes(zc0, k0, zc1, zc2, z):
    """Widths K4's sm90 tiles refuse run on WINDOW_ZBAND: conv0 (any Z*C0,
    its K loop over each tile's window of live input channels) replayed
    through the window GEMM's schedule, down0 through the z-banded one,
    are the folded convs exactly (conv0's output slabs padded to a
    multiple of 8 channels)."""
    from tests.test_torch_port_zband import replay_conv0, replay_zband

    assert bev_head.check_head_args(8, 4, zc0, k0, zc1, zc2,
                                    z) == "window+zband"
    if zc0 * zc1 <= 1 << 22:
        replay_conv0(1, 8, 4, z, zc0 // z, zc1 // z, k0)
    replay_zband("k2s2", 1, 8, 4, z, zc1 // z,
                 zc2 // bev_down.me_down_align(z)[2])


def test_stage0_kitti_widths_pass_both_rules():
    bev_down.check_down0_args("k2", 128, 128, 256, 128, 4)
    bev_head.check_head_args(128, 128, 4, 5, 256, 128, 4)
    bev_head.check_head_args(20, 20, 4, 3, 256, 128, 4)
    assert np.array_equal(bev_head.head_tiling(3, 20, 20, 3, 4, 256, 128,
                                               sms=132).args(),
                          (80, 20, 3, 1, 144, 18, 1, 1, 256, 64, 64, 64, 128,
                           1024, 64, 64, 2, 1, 1, 16, 6, 6))


@pytest.mark.parametrize("preset", ["default", "nuscenes", "synthetic"])
def test_k2_rule_takes_every_presets_stage0(preset):
    """K2 is the default stage 0 of every preset: the widths its conv0 and
    down0 fold to (Z*C1 = z * planes[0] -> Zo*C2 = Zo * planes[0]) at the
    preset's grid pass its rule."""
    from agplace_tpu_torch import config

    cfg = {"default": config.Config(), "nuscenes": config.nuscenes_config(),
           "synthetic": config.synthetic_config()}[preset].model.mm
    x, y, z = cfg.vox_grid_extent
    c1 = cfg.voxfe_planes[0]
    bev_down.check_down0_args("k2", x, y, z * c1,
                              bev_down.me_down_align(z)[2] * c1, z)


@pytest.mark.parametrize("k0", [3, 5])
@pytest.mark.parametrize("preset", ["kitti360", "default", "nuscenes",
                                    "synthetic"])
def test_k4_rule_takes_every_presets_stage0(preset, k0):
    """With ``bev_pallas_head`` set, K4 takes each preset's stage 0: conv0
    over Z*C0 = z occupancy channels (C0 = 1) to Z*C1 = z * planes[0],
    down0 to Zo*C2 = Zo * planes[0], at the preset's grid; the tiling
    picks the resident instance at KITTI-360's widths only."""
    from agplace_tpu_torch import config

    cfg = {"kitti360": config.kitti360_config(), "default": config.Config(),
           "nuscenes": config.nuscenes_config(),
           "synthetic": config.synthetic_config()}[preset].model.mm
    x, y, z = cfg.vox_grid_extent
    c1 = cfg.voxfe_planes[0]
    zo = bev_down.me_down_align(z)[2]
    bev_head.check_head_args(x, y, z, k0, z * c1, zo * c1, z)
    t = bev_head.head_tiling(32, x, y, k0, z, z * c1, zo * c1, sms=132)
    assert t.resident == (z == 4) and t.nn == zo * c1 // 128
    assert max(t.x_box) <= 256 and t.w0_box[1] <= 256


@pytest.mark.parametrize("zc0", [4, 8, 16])
@pytest.mark.parametrize("zc2", [128, 256, 384, 512])
def test_k4_rule_takes_the_wider_widths(zc0, zc2):
    """Z*C0 in (4, 8, 16), Z*C1 up to 1024 and Zo*C2 any multiple of 128
    up to 512 pass; everything K4 took before (Z*C0 = 4, Z*C1 <= 256,
    Zo*C2 = 128, z <= 4) still does."""
    for k0 in (3, 5):
        bev_head.check_head_args(32, 32, zc0, k0, 1024, zc2, 16)
        bev_head.check_head_args(32, 32, zc0, k0, 512, zc2, 8)
    for zc1, z in ((64, 1), (128, 2), (192, 3), (256, 4), (256, 2)):
        bev_head.check_head_args(20, 20, 4, 5, zc1, 128, z)
    assert bev_head.check_head_args(32, 32, zc0, 5, 1024, zc2 + 64,
                                    16) == "window+zband"
    with pytest.raises(ValueError, match=NO_FOLD):
        bev_head.check_head_args(32, 32, zc0, 5, 1024, zc2 + 4, 16)
