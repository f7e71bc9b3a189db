"""K4 — the fused BEV-FPN head: conv0 + BN0 + relu + mask + down0 + BN + relu
+ mask, with the full-resolution conv0 activation never written.

Port of ``agplace_tpu/ops/pallas/bev_head.py:fused_head``.  The CUDA kernel
(``csrc/bev_head.cu``, TMA + wgmma) computes conv0 itself, per output patch
from one input halo and one output parity at a time, and feeds each chunk
of the parity's activation from registers straight into the down0 MMA.
``head_tiling`` is its launch geometry, its one source; ``head_coords``,
``head_step`` and ``head_im2col`` replay its TMA boxes, its ring steps and
its im2col on the CPU.  Like JAX's kernel it takes every width of the MM's
flags: ``head_instance`` is the rule by shape, the sm90 kernel's resident
or streamed instance where its tiles take the widths, and elsewhere
WINDOW_ZBAND: conv0 on the TMA + wgmma GEMM of ``csrc/head_conv0_sm90.cu``,
whose K loop reads only the window of input channels a tile's output
slabs reach in the fold (``conv0_tiling``; ``conv0_tile`` and
``conv0_window`` replay it), its activation through memory, then down0 on
the fp32 instance of the z-banded wgmma GEMM (``csrc/zband_sm90.cu``), the
same fp32 epilogues; each z-slab of conv0's output padded to a multiple
of 8 channels (``widths.pad_slabs``), the output sliced back.  Both halves
take the fold's off-band blocks as the zeros ``fold_w2_stride1`` and
``fold_w2_k2s2`` put there: hand them folds, not dense weights.

``head_plain`` is the plain version, with the TPU kernel's rounding
(``bev_head.py:146-163``): conv0 accumulated in fp32, the BN0 affine in
fp32 with fp32 scale and bias, relu, mask, ONE bf16 round; down0
accumulated in fp32, its affine in fp32, relu, the output mask, one round.
K2 (``ops/bev_down.py``) rounds elsewhere — conv0's output before its
affine, the affine itself in bf16, the down0 sum before its affine — so the
two differ by isolated bf16 ulps and neither is the other's plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build, bev_down, zband
from agplace_tpu_torch.ops.widths import (SM90, WINDOW, ZBAND, c_step,
                                          pad_fold, pad_slabs, unpad_slabs)
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16
_F32 = torch.float32


def head_plain(feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
               bias_d, *, z: int):
    k0 = int(w0_folded.shape[0])
    # bf16 operands, fp32 accumulation, result left unrounded
    x = feats.to(_BF16).float()
    w0 = w0_folded.to(_BF16).float()
    h = bg.bev_conv2d(x, w0, 1, (k0 // 2,) * 2, (k0 // 2,) * 2, _F32)
    h = torch.relu(h * scale0.float() + bias0.float())
    h = bg.mask_bev(h, mask, z).to(_BF16)
    lo_z, hi_z, zo = me_down_align(z)
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z))
    d = bg.bev_conv2d(h.float(), wd_folded.to(_BF16).float(), 2, (0, 0),
                      (0, 0), _F32)
    d = torch.relu(d * scale_d.float() + bias_d.float())
    return bg.mask_bev(d, mask_out, zo).to(_BF16), mask_out


# The sm90 kernel's tiles (csrc/bev_head.cu): conv0 k0 in (3, 5) over Z*C0 in
# ZC0S channels, its im2col depth k0*k0*Z*C0 padded to KP, a multiple of
# the slab (64 to 448); the down0 half takes K2's rule
# (bev_down.check_down0_args: Z*C1 up to 1024, Zo*C2 a multiple of the
# 128-channel N tile up to 512, z <= 16), every preset's stage 0.  A block
# owns the 8 x 16 output patch of K2's GEMM and one N tile; one block per
# SM.  W0 stays in shared memory at Z*C0 = 4, Z*C1 <= RESIDENT_ZC1 and one
# N tile (KITTI-360's widths), else it streams through the kernel's ring in
# (64 x W0_STREAM_ROWS) boxes.
ZC0S = (4, 8, 16)
RESIDENT_ZC1 = 256
PATCH_X, PATCH_Y, BLOCK_N, SLAB = 8, 16, 128, 64
W0_STREAM_ROWS = 128
# The halo starts HALO_LEAD cells before the patch along y for every k0
# (at Z*C0 = 4 its inner TMA coordinate stays 16-byte aligned), k0 // 2
# rows along x; it is HALO_CELLS cells wide
HALO_LEAD = 2
HALO_CELLS = 2 * PATCH_Y + 2 * HALO_LEAD
RESIDENT, STREAMED = "resident", "streamed"
WINDOW_ZBAND = f"{WINDOW}+{ZBAND}"  # conv0's window GEMM, down0 on zband


@dataclass(frozen=True)
class HeadTiling:
    """Launch geometry of K4 over feats [B, X, Y, Z*C0] with w0 [k0, k0,
    Z*C0, Z*C1] and wd [2, 2, Z*C1, Zo*C2], as the kernel takes it
    (``args``).  Tile ``i`` is ((b * npx + xp) * npy + yp) * nn + n, as
    K2's: a patch's N tiles are adjacent; block j takes tiles j, j + grid,
    ...  Tensor-map dims and boxes are innermost first; the halo box holds
    HALO_CELLS cells of Z*C0 channels per row, 16 + 2h rows."""

    x_dims: Tuple[int, int, int, int]  # (Y*4, X, B, 1) or (Z*C0, Y, X, B)
    x_box: Tuple[int, int, int, int]  # (144, 16+2h, 1, 1), (Z*C0, 36, 16+2h, 1)
    w0_dims: Tuple[int, int]  # (Z*C1, rows): the zero-padded im2col weight
    w0_box: Tuple[int, int]  # (64, SLAB) resident, (64, 128) streamed
    wd_dims: Tuple[int, int]  # (Zo*C2, 4 * Z*C1)
    wd_box: Tuple[int, int]  # (64, 64)
    npx: int
    npy: int
    nn: int  # N tiles: Zo*C2 / BLOCK_N
    steps: int  # ring steps per tile (head_step)
    tiles: int
    grid: int

    @property
    def resident(self) -> bool:
        """W0 loaded once per block (else streamed per chunk)."""
        return self.w0_box[1] == SLAB

    def args(self) -> Tuple[int, ...]:
        return (*self.x_dims, *self.x_box, *self.w0_dims, *self.w0_box,
                *self.wd_dims, *self.wd_box, self.npx, self.npy, self.nn,
                self.steps, self.tiles, self.grid)


def head_depth(k0: int, zc0: int) -> int:
    """conv0's im2col depth k0*k0*Z*C0 padded to a multiple of the slab."""
    return -(-zc0 * k0 * k0 // SLAB) * SLAB


def head_tiling(b: int, x: int, y: int, k0: int, zc0: int, zc1: int,
                zc2: int, sms: int) -> HeadTiling:
    """The persistent grid of one block per SM (``sms``: the card's SM
    count)."""
    h = k0 // 2
    xo, yo = x // 2, y // 2
    npx, npy, nn = -(-xo // PATCH_X), -(-yo // PATCH_Y), zc2 // BLOCK_N
    tiles = b * npx * npy * nn
    rows = 2 * PATCH_X + 2 * h
    if zc0 == 4:  # 8-byte cells: the view [B, X, Y*4, 1]
        x_dims, x_box = (y * 4, x, b, 1), (HALO_CELLS * 4, rows, 1, 1)
    else:  # the view [B, X, Y, Z*C0], channels innermost
        x_dims, x_box = (zc0, y, x, b), (zc0, HALO_CELLS, rows, 1)
    kp, nch = head_depth(k0, zc0), zc1 // 64
    if zc0 == 4 and zc1 <= RESIDENT_ZC1 and zc2 == BLOCK_N:
        w0_dims, w0_box, steps = (zc1, kp), (64, SLAB), 4 * nch
    else:
        nw0 = -(-kp // W0_STREAM_ROWS)
        w0_dims, w0_box = (zc1, nw0 * W0_STREAM_ROWS), (64, W0_STREAM_ROWS)
        steps = 4 * nch * (nw0 + 1)
    return HeadTiling(x_dims, x_box, w0_dims, w0_box, (zc2, 4 * zc1),
                      (64, 64), npx, npy, nn, steps, tiles, min(tiles, sms))


def head_coords(t: HeadTiling, tile: int, k0: int):
    """The halo box of tile ``tile``: at ((2 yo0 - HALO_LEAD) * 4, 2 xo0 -
    h, b, 0) of the [B, X, Y*4, 1] view, or (0, 2 yo0 - HALO_LEAD, 2 xo0 -
    h, b) of [B, X, Y, Z*C0] (negative or past the map: zeros); returns
    (halo start, (xo0, yo0, b, n0)), n0 the tile's first output channel."""
    h = k0 // 2
    n0, r = (tile % t.nn) * BLOCK_N, tile // t.nn
    yp, r = r % t.npy, r // t.npy
    xp, b = r % t.npx, r // t.npx
    xo0, yo0 = xp * PATCH_X, yp * PATCH_Y
    y0 = 2 * yo0 - HALO_LEAD
    start = ((y0 * 4, 2 * xo0 - h, b, 0) if t.x_box[0] == HALO_CELLS * 4
             else (0, y0, 2 * xo0 - h, b))
    return start, (xo0, yo0, b, n0)


def head_step(t: HeadTiling, tile: int, i: int):
    """Ring step ``i`` of tile ``tile``: ("w0", par, c, (col, row)) for a
    streamed W0 box (conv0 chunk c's 64 columns, 128 rows from ``row``) or
    ("wd", par, c, ((n0, k), (n0 + 64, k))) for the two wd boxes of chunk
    (par, c) (rows k = par * Z*C1 + 64 c of the N tile's 128 columns)."""
    zc1, nch = t.w0_dims[0], t.w0_dims[0] // 64
    n0 = (tile % t.nn) * BLOCK_N
    per = 1 if t.resident else t.steps // (4 * nch)
    j, r = divmod(i, per)
    par, c = divmod(j, nch)
    if r < per - 1:
        return "w0", par, c, (64 * c, W0_STREAM_ROWS * r)
    k = par * zc1 + 64 * c
    return "wd", par, c, ((n0, k), (n0 + 64, k))


def head_im2col(k0: int, zc0: int, row: int, par: int, t: int):
    """Where the kernel's im2col puts tap ``t`` = a*k0 + bb of GEMM row
    ``row`` (patch cell (row // 16, row % 16)) at parity ``par`` = 2 dx +
    dy: (halo row, halo cell, [(im2col slab, 16-byte chunk before the
    swizzle, byte offset in the chunk) of each of its Z*C0 / 4 8-byte
    words]).  The Z*C0 channels at columns Z*C0 t .. Z*C0 (t + 1) - 1 are
    halo cell (2 xi + dx + a, 2 yi + dy + bb + HALO_LEAD - k0 // 2)."""
    xi, yi = divmod(row, PATCH_Y)
    dx, dy = divmod(par, 2)
    a, bb = divmod(t, k0)
    words = [(cb >> 7, (cb >> 4) & 7, cb & 15)
             for cb in range(2 * zc0 * t, 2 * zc0 * (t + 1), 8)]
    return (2 * xi + dx + a, 2 * yi + dy + bb + HALO_LEAD - k0 // 2, words)


def head_instance(zc0: int, k0: int, zc1: int, zc2: int, z: int) -> str:
    """K4's instance: conv0 k0 over Z*C0 input channels to Z*C1, down0 to
    Zo*C2.  RESIDENT or STREAMED (the sm90 kernel, ``head_tiling`` picks
    which) at k0 in (3, 5), Z*C0 in ZC0S and K2's sm90 widths; WINDOW_ZBAND
    at every other width; raises outside JAX's gate (k0 odd and <= 5) and
    on widths no z-fold gives."""
    if not (k0 % 2 == 1 and 1 <= k0 <= 5):
        raise ValueError(f"fused_head: conv0 kernel size {k0} outside "
                         f"JAX's gate (odd and <= 5)")
    if zc0 < 1:
        raise ValueError(f"fused_head: conv0 over Z*C0 = {zc0} channels")
    down = bev_down.down0_instance(zc1, zc2, z, "fused_head")
    if zc0 not in ZC0S or k0 == 1 or down != SM90:
        return WINDOW_ZBAND
    return (RESIDENT if zc0 == 4 and zc1 <= RESIDENT_ZC1 and zc2 == BLOCK_N
            else STREAMED)


def check_head_args(x: int, y: int, zc0: int, k0: int, zc1: int, zc2: int,
                    z: int) -> str:
    """K4's shape rule: even X and Y and ``head_instance``; returns the
    instance."""
    _build.check(x % 2 == 0 and y % 2 == 0,
                 f"fused_head: spatial dims {x}x{y} are not even")
    return head_instance(zc0, k0, zc1, zc2, z)


def head_gemm(feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
              bias_d, mask_out, *, z: int):
    """K4's kernel on the card (``head_plain`` on the CPU) with the output
    mask precomputed: ``fused_head``'s arguments and mask_out [B,X/2,Y/2,Zo]
    bool.  Returns [B,X/2,Y/2,Zo*C2] bf16."""
    b, x, y, zc0 = feats.shape
    k0 = int(w0_folded.shape[0])
    zc1, zc2 = int(w0_folded.shape[3]), int(wd_folded.shape[3])
    inst = check_head_args(x, y, zc0, k0, zc1, zc2, z)
    _build.check(tuple(w0_folded.shape) == (k0, k0, zc0, zc1)
                 and tuple(wd_folded.shape) == (2, 2, zc1, zc2),
                 f"fused_head: w0 {tuple(w0_folded.shape)} wd "
                 f"{tuple(wd_folded.shape)}")
    bev_down.check_down0_tensors("fused_head", mask, scale0, bias0, scale_d,
                                 bias_d, mask_out, b, x, y, zc1, zc2, z)
    ins = (feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
           bias_d, mask_out)
    if not _build.on_cuda(*ins):
        return head_plain(*ins[:-1], z=z)[0]
    if inst == WINDOW_ZBAND:
        return head_zband(*ins, z=z)
    dev = feats.device
    out = torch.empty((b, x // 2, y // 2, zc2), dtype=_BF16, device=dev)
    kk = k0 * k0 * zc0
    t = head_tiling(b, x, y, k0, zc0, zc1, zc2,
                    torch.cuda.get_device_properties(dev).multi_processor_count)
    w0p = torch.zeros((t.w0_dims[1], zc1), dtype=_BF16, device=dev)
    w0p[:kk] = w0_folded.reshape(kk, zc1)
    _build.call("agp_bev_head", _build.aligned(feats.to(_BF16)),
                mask.contiguous(), w0p, scale0.float().contiguous(),
                bias0.float().contiguous(),
                _build.aligned(wd_folded.to(_BF16)),
                scale_d.float().contiguous(), bias_d.float().contiguous(),
                mask_out.contiguous(), out, z, me_down_align(z)[2], k0, zc0,
                *t.args())
    return out


def pad_head(w0_folded, scale0, bias0, wd_folded, scale_d, bias_d, *,
             z: int):
    """WINDOW_ZBAND's operands: each z-slab of conv0's output padded to
    C1_8 = 8 * ceil(C1 / 8) channels (w0's columns, BN0's scale and bias:
    zeros, so a padded channel of h is 0), wd's slabs and the down BN's
    affine to C1_8 -> C2_8; each is itself where C == C8."""
    zo = me_down_align(z)[2]
    zc0 = int(w0_folded.shape[2])
    c18 = c_step(int(w0_folded.shape[3]) // z)
    c28 = c_step(int(wd_folded.shape[3]) // zo)
    return (pad_fold(w0_folded.to(_BF16), 1, zc0, z, c18),
            pad_slabs(scale0.float(), z, c18),
            pad_slabs(bias0.float(), z, c18),
            pad_fold(wd_folded.to(_BF16), z, c18, zo, c28),
            pad_slabs(scale_d, zo, c28), pad_slabs(bias_d, zo, c28))


def head_zband(feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
               bias_d, mask_out, *, z: int):
    """K4's WINDOW_ZBAND instance on CUDA tensors whose shapes ``head_gemm``
    checked: the operands padded (``pad_head``), conv0 (``head_conv0``)
    into h [B, X, Y, Z*C1_8], then down0 over h on the z-banded GEMM's
    fp32 instance, its output sliced back to Zo*C2."""
    w0, s0, b0, wd, sd, bd = pad_head(w0_folded, scale0, bias0, wd_folded,
                                      scale_d, bias_d, z=z)
    h = head_conv0(feats, mask, w0, s0, b0, z=z)
    out = zband.zband_conv(zband.INST_K4_DOWN, h, wd, sd, bd, mask_out, z)
    zo = me_down_align(z)[2]
    return unpad_slabs(out, zo, int(wd_folded.shape[3]) // zo)


# conv0 of WINDOW_ZBAND (csrc/head_conv0_sm90.cu): a tile is a 16 (x) x 8
# (y) patch of output cells times C0_BLOCK_N channels of the flattened
# Z*C1_8 axis; its A operand is the halo'd patch of the tile's channel
# window, one TMA box per 8-channel block, C0_SLICE_BLOCKS blocks a halo
# slice; C0_BLOCKS_PER_SM persistent blocks per SM
C0_PATCH_X, C0_PATCH_Y, C0_BLOCK_N = 16, 8, 128
C0_SLICE_BLOCKS, C0_BLOCKS_PER_SM, C0_STAGE_BYTES = 8, 2, 24 * 1024


@dataclass(frozen=True)
class Conv0Tiling:
    """Launch geometry of conv0 over feats [B, X, Y, Z*C0] (channels padded
    to Z*C0_8, a multiple of 8) to h [B, X, Y, Z*C1_8], as the kernel takes
    it (``args``).  Tile ``i`` is ((b * npx + xp) * npy + yp) * ntn + n;
    block j takes tiles j, j + grid, ...  Dims and boxes innermost first:
    feats as (Z*C0_8, Y, X, B), its halo box one 8-channel block of 15 + k0
    x 8 + k0 cells (one spare cell a row); w0 as (Z*C1_8, Z*C0, k0 dy, k0
    dx), its box 64 columns of 8 rows of two taps (``pair``) or of 8 sb
    rows of one tap."""

    x_dims: Tuple[int, int, int, int]
    x_box: Tuple[int, int, int, int]
    w_dims: Tuple[int, int, int, int]
    w_box: Tuple[int, int, int, int]
    z: int
    k0: int
    c0: int
    c18: int
    npx: int
    npy: int
    ntn: int  # N tiles: ceil(Z*C1_8 / C0_BLOCK_N)
    nb: int  # the widest window, in 8-channel blocks
    sb: int  # blocks of a halo slice
    nsl: int  # slices of a tile
    pair: int  # 1: a 16-deep MMA step is two taps of one block
    tg: int  # taps (pairs) of a ring step: a row of k0, or 1
    steps: int  # ring steps of a slice
    tiles: int
    grid: int

    def args(self) -> Tuple[int, ...]:
        return (*self.x_dims, *self.x_box, *self.w_dims, *self.w_box, self.z,
                self.k0, self.c0, self.c18, self.npx, self.npy, self.ntn,
                self.nb, self.sb, self.nsl, self.pair, self.tg, self.steps,
                self.tiles, self.grid)


def conv0_window(k0: int, c0: int, c18: int, z: int, n0: int):
    """The input channels [a0, hi) of feats that the output channels [n0,
    n0 + C0_BLOCK_N) of Z*C1_8 read in the fold: the slabs za .. zb they
    lie in reach slabs za - k0 // 2 .. zb + k0 // 2 (clipped to [0, Z)),
    channels [lo, hi); a0 is lo rounded down to 8 (a TMA box's start is
    16-byte aligned)."""
    h = k0 // 2
    za = n0 // c18
    zb = (min(n0 + C0_BLOCK_N, z * c18) - 1) // c18
    return max(za - h, 0) * c0 // 8 * 8, min(zb + h + 1, z) * c0


def conv0_tiling(b: int, x: int, y: int, k0: int, c0: int, z: int,
                 c18: int, sms: int) -> Conv0Tiling:
    """The persistent grid of C0_BLOCKS_PER_SM blocks per SM (``sms``: the
    card's SM count) over B x X x Y cells, conv0 k0 x k0 from z slabs of
    c0 channels to z slabs of c18 (a multiple of 8)."""
    zc0, zc18 = z * c0, z * c18
    ntn = -(-zc18 // C0_BLOCK_N)
    nb = max(-(-(hi - a0) // 8) for a0, hi in (
        conv0_window(k0, c0, c18, z, n * C0_BLOCK_N) for n in range(ntn)))
    pair = int(nb == 1)
    sb = 1 if pair else min(C0_SLICE_BLOCKS, nb + nb % 2)
    row = (k0 + 1) // 2 if pair else k0  # taps (pairs) of a dx row
    w_box = (64, 8, 2, 1) if pair else (64, 8 * sb, 1, 1)
    tap_bytes = 2 * 2 * w_box[0] * w_box[1] * w_box[2]
    tg = row if row * tap_bytes <= C0_STAGE_BYTES else 1
    npx, npy = -(-x // C0_PATCH_X), -(-y // C0_PATCH_Y)
    tiles = b * npx * npy * ntn
    return Conv0Tiling((c_step(zc0), y, x, b),
                       (8, C0_PATCH_Y + k0, C0_PATCH_X + k0 - 1, 1),
                       (zc18, zc0, k0, k0), w_box, z, k0, c0, c18, npx, npy,
                       ntn, nb, sb, -(-nb // sb), pair, tg, k0 * row // tg,
                       tiles, min(tiles, C0_BLOCKS_PER_SM * sms))


def conv0_tile(t: Conv0Tiling, tile: int):
    """Tile ``tile`` as the kernel decodes it: (b, x0, y0, n0, a0), the
    patch origin, its first output channel and its window's start."""
    n0, r = (tile % t.ntn) * C0_BLOCK_N, tile // t.ntn
    yp, r = r % t.npy, r // t.npy
    xp, b = r % t.npx, r // t.npx
    a0 = conv0_window(t.k0, t.c0, t.c18, t.z, n0)[0]
    return b, xp * C0_PATCH_X, yp * C0_PATCH_Y, n0, a0


def conv0_step(t: Conv0Tiling, i: int):
    """Ring step ``i`` of a slice: its ``tg`` taps (dx, dy) in the order of
    the stage's boxes (with a pair, the first of taps dy, dy + 1)."""
    taps = []
    for j in range(i * t.tg, (i + 1) * t.tg):
        if t.pair:
            dx, m = divmod(j, (t.k0 + 1) // 2)
            taps.append((dx, 2 * m))
        else:
            taps.append(divmod(j, t.k0))
    return taps


def head_conv0(feats, mask, w0, s0, b0, *, z: int):
    """WINDOW_ZBAND's conv0 (``agp_head_conv0``) on CUDA tensors, w0 (a
    ``fold_w2_stride1``) and the affines padded by ``pad_head``: h [B, X,
    Y, Z*C1_8] bf16.  feats' channels are padded with zeros to a multiple
    of 8 (the tensor map's row stride); w0's rows end at Z*C0, and TMA reads
    the rows past it as zeros."""
    b, x, y, zc0 = feats.shape
    k0, zc18 = int(w0.shape[0]), int(w0.shape[3])
    t = conv0_tiling(b, x, y, k0, zc0 // z, z, zc18 // z,
                     torch.cuda.get_device_properties(
                         feats.device).multi_processor_count)
    xp = feats.to(_BF16)
    if t.x_dims[0] != zc0:
        xp = F.pad(xp, (0, t.x_dims[0] - zc0))
    h = torch.empty((b, x, y, zc18), dtype=_BF16, device=feats.device)
    _build.call("agp_head_conv0", _build.aligned(xp), mask.contiguous(),
                _build.aligned(w0), _build.aligned(s0), _build.aligned(b0),
                h, *t.args())
    return h


def fused_head(feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
               bias_d, *, z: int):
    """feats [B,X,Y,Z*C0] (masked; cast to bf16, as JAX does), mask
    [B,X,Y,Z] bool, w0_folded [k0,k0,Z*C0,Z*C1], scale0/bias0 [Z*C1] fp32,
    wd_folded [2,2,Z*C1,Zo*C2], scale_d/bias_d [Zo*C2] fp32.  Returns
    (feats [B,X/2,Y/2,Zo*C2] bf16, mask_out [B,X/2,Y/2,Zo]).  Gated on
    either device as the TPU kernel is: k0 odd and <= 5, even X and Y that
    need no ME alignment padding (its parity split pairs (2m, 2m+1))."""
    _, x, y, _ = feats.shape
    k0 = int(w0_folded.shape[0])
    _build.check(k0 % 2 == 1 and k0 <= 5,
                 f"fused_head: conv0 kernel size {k0} (odd and <= 5)")
    _build.check(me_down_align(x)[:2] == (0, 0)
                 and me_down_align(y)[:2] == (0, 0),
                 f"fused_head: spatial dims {x}x{y} need ME padding")
    ins = (feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
           bias_d)
    if not _build.on_cuda(*ins):
        return head_plain(*ins, z=z)
    lo_z, hi_z, _ = me_down_align(z)
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    out = head_gemm(*ins, mask_out, z=z)
    fused_head.launches += 1
    fused_head.instances[head_instance(int(feats.shape[3]), k0,
                                       int(w0_folded.shape[3]),
                                       int(wd_folded.shape[3]), z)] += 1
    return out, mask_out


fused_head.launches = 0
fused_head.instances = dict.fromkeys((RESIDENT, STREAMED, WINDOW_ZBAND), 0)
