"""K2 — fused stage-0 epilogue + masked down0 of the BEV FPN.

Port of ``agplace_tpu/ops/pallas/bev_down.py:fused_conv0_down0``.  conv0
runs outside the kernel as one full-resolution cuDNN conv (XLA ran it
outside the Pallas call); the CUDA kernel ``csrc/bev_down.cu`` (TMA +
wgmma, ``down0_gemm``) applies BN0, relu and the z-mask to the A operand in
registers, runs the down0 product in fp32, and applies the down BN, relu and
the output mask.  ``down0_tiling`` is the kernel's launch geometry, its one
source; ``down0_coords`` replays its TMA boxes on the CPU.
``conv0_down0_plain`` is the plain version: the unfused prefix ``BEVConv ->
BN -> relu -> mask -> BEVConv(k2s2) -> BN -> relu -> mask``
(``bev_grid.py:720-740``), whose second half is ``down0_plain``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16
# The down0 GEMM's tiles: a block owns PATCH_X x PATCH_Y output cells of one
# item (128 GEMM rows) and BLOCK_N output channels (all of them at KITTI-360;
# Zo*C2 / BLOCK_N N tiles in all); each K step is one tap of a SLAB-channel
# slab.  Z*C1 up to MAX_ZC1 and Zo*C2 up to MAX_ZC2 (the affines are staged
# in shared memory), z up to MAX_Z (16 mask bits per row and tap): the
# presets' z = 4, 8 and 16 (Z*C1 256, 512, 1024 -> Zo*C2 128, 256, 512).
PATCH_X, PATCH_Y, BLOCK_N, SLAB = 8, 16, 128, 64
MAX_ZC1, MAX_ZC2, MAX_Z = 1024, 512, 16


@dataclass(frozen=True)
class Down0Tiling:
    """Launch geometry of the down0 GEMM over conv0's output g [B, X, Y,
    Z*C1] with wd [2, 2, Z*C1, Zo*C2], as the kernel takes it (``args``).
    Tile ``i`` is ((b * npx + xp) * npy + yp) * nn + n: a patch's N tiles
    are adjacent, so its second read of g hits L2; block j takes tiles j,
    j + grid, ...  Tensor-map dims and boxes are innermost first."""

    g_dims: Tuple[int, int, int, int, int]  # (2*Z*C1, Yo, 2, Xo, B)
    g_box: Tuple[int, int, int, int, int]  # (SLAB, PATCH_Y, 1, PATCH_X, 1)
    w_dims: Tuple[int, int]  # (Zo*C2, 4 * Z*C1): wd as a row-major matrix
    w_box: Tuple[int, int]  # (64, SLAB): two boxes per step cover BLOCK_N
    npx: int  # patches along xo
    npy: int  # patches along yo
    nn: int  # N tiles: Zo*C2 / BLOCK_N
    steps: int  # K steps per tile: 4 taps x Z*C1 / SLAB slabs
    tiles: int
    grid: int  # blocks

    def args(self) -> Tuple[int, ...]:
        """The fields flat, in order: the kernel's geometry arguments."""
        return (*self.g_dims, *self.g_box, *self.w_dims, *self.w_box,
                self.npx, self.npy, self.nn, self.steps, self.tiles,
                self.grid)


def down0_tiling(b: int, x: int, y: int, zc1: int, zc2: int,
                 sms: int) -> Down0Tiling:
    """The persistent grid of one block per SM (``sms``: the card's SM
    count; 129 KB of shared memory a block)."""
    xo, yo = x // 2, y // 2
    npx, npy, nn = -(-xo // PATCH_X), -(-yo // PATCH_Y), zc2 // BLOCK_N
    tiles = b * npx * npy * nn
    return Down0Tiling((2 * zc1, yo, 2, xo, b), (SLAB, PATCH_Y, 1, PATCH_X, 1),
                       (zc2, 4 * zc1), (BLOCK_N // 2, SLAB), npx, npy, nn,
                       4 * zc1 // SLAB, tiles, min(tiles, sms))


def down0_coords(t: Down0Tiling, tile: int, step: int):
    """TMA coordinates of K step ``step`` of tile ``tile``, as the kernel's
    producer computes them from ``t``: the g box at (dy*Z*C1 + c0, yo0, dx,
    xo0, b) of the 5-D view (past the map: zeros), tap = 2 dx + dy, and the
    two wd boxes at (n0, k0) and (n0 + 64, k0), k0 = step * SLAB, n0 =
    BLOCK_N * (tile % nn) the tile's first output channel."""
    zc1 = t.g_dims[0] // 2
    n0, r = (tile % t.nn) * BLOCK_N, tile // t.nn
    yp, r = r % t.npy, r // t.npy
    xp, b = r % t.npx, r // t.npx
    k0 = step * SLAB
    tap, c0 = divmod(k0, zc1)
    dx, dy = divmod(tap, 2)
    return ((dy * zc1 + c0, yp * PATCH_Y, dx, xp * PATCH_X, b),
            ((n0, k0), (n0 + BLOCK_N // 2, k0)))


def down0_plain(g0, mask, scale0, bias0, wd_folded, scale_d, bias_d, *,
                z: int):
    """BN0 + relu + z-mask of conv0's bare output g0, then down0 + BN +
    relu + mask, in g0's dtype.  Returns (feats, mask_out)."""
    fd = g0.dtype
    h = bg.mask_bev(torch.relu(g0 * scale0.to(fd) + bias0.to(fd)), mask, z)
    lo_z, hi_z, zo = me_down_align(z)
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z))
    d = bg.bev_conv2d(h, wd_folded, 2, (0, 0), (0, 0))
    d = bg.mask_bev(torch.relu(d * scale_d.to(fd) + bias_d.to(fd)),
                    mask_out, zo)
    return d, mask_out


def conv0_down0_plain(feats, mask, w0_folded, scale0, bias0, wd_folded,
                      scale_d, bias_d, *, z: int):
    k0 = w0_folded.shape[0]
    g0 = bg.bev_conv2d(feats, w0_folded, 1, (k0 // 2,) * 2, (k0 // 2,) * 2)
    return down0_plain(g0, mask, scale0, bias0, wd_folded, scale_d, bias_d,
                       z=z)


def check_stage0_args(name, feats, w0_folded, wd_folded, z: int):
    """The stage-0 shape rules of P2's kernel: spatial dims that need no ME
    padding, channel widths on its tiles."""
    _, x, y, _ = feats.shape
    zc1, zc2 = int(w0_folded.shape[3]), int(wd_folded.shape[3])
    zo = me_down_align(z)[2]
    _build.check(me_down_align(x)[:2] == (0, 0)
                 and me_down_align(y)[:2] == (0, 0),
                 f"{name}: spatial dims {x}x{y} need ME padding")
    _build.check(zc1 % 32 == 0 and (zc1 // z) % 8 == 0
                 and (zc2 // zo) % 8 == 0 and zc2 % 8 == 0,
                 f"{name}: channel widths {zc1}->{zc2} at z={z} not "
                 f"multiples of the kernel's tiles")
    _build.check(tuple(wd_folded.shape) == (2, 2, zc1, zc2),
                 f"{name}: wd {tuple(wd_folded.shape)}")


def down0_widths_ok(zc1: int, zc2: int, z: int, *, max_zc1: int = MAX_ZC1,
                    max_zc2: int = MAX_ZC2, max_z: int = MAX_Z) -> bool:
    """Whether the down0 GEMM's tiles take these widths: Z*C1 a multiple of
    the 64-channel slab up to ``max_zc1``, Z*C1/z a multiple of 8, z up to
    ``max_z``, Zo*C2 a multiple of the 128-channel N tile up to
    ``max_zc2`` and C2 even (the epilogue's channel pairs in one z-slab;
    Zo is 3 at z = 5)."""
    zo = me_down_align(z)[2]
    return (zc1 % SLAB == 0 and zc1 <= max_zc1 and 1 <= z <= max_z
            and zc1 % (8 * z) == 0 and zc2 % BLOCK_N == 0
            and 0 < zc2 <= max_zc2 and zc2 % (2 * zo) == 0)


def check_down0_args(name, x: int, y: int, zc1: int, zc2: int, z: int, *,
                     max_zc1: int = MAX_ZC1, max_zc2: int = MAX_ZC2,
                     max_z: int = MAX_Z):
    """The down0 GEMM's shape rule (K2's, and with K4's limits its down0
    half): even X and Y and ``down0_widths_ok``."""
    _build.check(x % 2 == 0 and y % 2 == 0,
                 f"{name}: spatial dims {x}x{y} are not even")
    _build.check(down0_widths_ok(zc1, zc2, z, max_zc1=max_zc1,
                                 max_zc2=max_zc2, max_z=max_z),
                 f"{name}: channel widths {zc1}->{zc2} at z={z} outside the "
                 f"kernel's tiles (Z*C1 a multiple of {SLAB} up to "
                 f"{max_zc1}, Z*C1/z of 8, z <= {max_z}, Zo*C2 a multiple "
                 f"of {BLOCK_N} up to {max_zc2}, C2 even)")


def check_down0_tensors(name, mask, scale0, bias0, scale_d, bias_d,
                        mask_out, b: int, x: int, y: int, zc1: int, zc2: int,
                        z: int):
    """The occupancy masks and BN affines the stage-0 kernels read in full:
    bool masks [B, X, Y, z] and [B, X/2, Y/2, Zo], Z*C1 and Zo*C2 affine
    entries."""
    zo = me_down_align(z)[2]
    _build.check(mask.dtype == torch.bool and mask_out.dtype == torch.bool
                 and tuple(mask.shape) == (b, x, y, z)
                 and tuple(mask_out.shape) == (b, x // 2, y // 2, zo),
                 f"{name}: mask {tuple(mask.shape)} {mask.dtype}, mask_out "
                 f"{tuple(mask_out.shape)} {mask_out.dtype} at "
                 f"[{b},{x},{y}] z={z}")
    _build.check(scale0.numel() == zc1 and bias0.numel() == zc1
                 and scale_d.numel() == zc2 and bias_d.numel() == zc2,
                 f"{name}: affines of {scale0.numel()}, {bias0.numel()}, "
                 f"{scale_d.numel()}, {bias_d.numel()} entries, not Z*C1 = "
                 f"{zc1} and Zo*C2 = {zc2}")


def down0_gemm(g0, mask, scale0, bias0, wd_folded, scale_d, bias_d,
               mask_out, *, z: int):
    """K2's kernel on the card (``down0_plain`` on the CPU): g0 [B,X,Y,Z*C1]
    bf16 (conv0's bare output), mask [B,X,Y,Z] bool, scale0/bias0 [Z*C1],
    wd_folded [2,2,Z*C1,Zo*C2], scale_d/bias_d [Zo*C2], mask_out
    [B,X/2,Y/2,Zo] bool.  Returns [B,X/2,Y/2,Zo*C2] bf16."""
    b, x, y, zc1 = g0.shape
    zc2 = int(wd_folded.shape[3])
    check_down0_args("down0_gemm", x, y, zc1, zc2, z)
    _build.check(tuple(wd_folded.shape) == (2, 2, zc1, zc2),
                 f"down0_gemm: g {tuple(g0.shape)} wd "
                 f"{tuple(wd_folded.shape)} at z={z}")
    check_down0_tensors("down0_gemm", mask, scale0, bias0, scale_d, bias_d,
                        mask_out, b, x, y, zc1, zc2, z)
    if not _build.on_cuda(g0, mask, scale0, bias0, wd_folded, scale_d,
                          bias_d, mask_out):
        return down0_plain(g0, mask, scale0, bias0, wd_folded, scale_d,
                           bias_d, z=z)[0]
    _build.check(g0.dtype == _BF16, "down0_gemm: bf16 g")
    t = down0_tiling(b, x, y, zc1, zc2, torch.cuda.get_device_properties(
        g0.device).multi_processor_count)
    out = torch.empty((b, x // 2, y // 2, zc2), dtype=_BF16,
                      device=g0.device)
    _build.call("agp_bev_down", _build.aligned(g0), mask.contiguous(),
                scale0.float().contiguous(), bias0.float().contiguous(),
                _build.aligned(wd_folded.to(_BF16)),
                scale_d.float().contiguous(), bias_d.float().contiguous(),
                mask_out.contiguous(), out, z, me_down_align(z)[2],
                *t.args())
    return out


def fused_conv0_down0(feats, mask, w0_folded, scale0, bias0, wd_folded,
                      scale_d, bias_d, *, z: int):
    """feats [B,X,Y,Z*C0] (masked; the kernel takes them in bf16, as
    JAX's does), mask [B,X,Y,Z] bool, w0_folded [k0,k0,Z*C0,Z*C1],
    scale0/bias0 [Z*C1] fp32, wd_folded [2,2,Z*C1,Zo*C2], scale_d/bias_d
    [Zo*C2] fp32.  X and Y must need no ME alignment padding.  Returns
    (feats [B,X/2,Y/2,Zo*C2], mask_out [B,X/2,Y/2,Zo]); bf16 from the
    kernel, the feats dtype from the plain version."""
    ins = (feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
           bias_d)
    if not _build.on_cuda(*ins):
        return conv0_down0_plain(*ins, z=z)
    _, x, y, _ = feats.shape
    k0 = int(w0_folded.shape[0])
    lo_z, hi_z, _ = me_down_align(z)
    feats = feats.to(_BF16)  # the fp32 model's occupancy grid: exact
    _build.check(me_down_align(x)[:2] == (0, 0)
                 and me_down_align(y)[:2] == (0, 0),
                 f"fused_conv0_down0: spatial dims {x}x{y} need ME padding")
    check_down0_args("fused_conv0_down0", x, y, int(w0_folded.shape[3]),
                     int(wd_folded.shape[3]), z)
    g0 = bg.bev_conv2d(feats, w0_folded, 1, (k0 // 2,) * 2,
                       (k0 // 2,) * 2).contiguous()
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    out = down0_gemm(g0, mask, scale0, bias0, wd_folded, scale_d, bias_d,
                     mask_out, z=z)
    fused_conv0_down0.launches += 1
    return out, mask_out


fused_conv0_down0.launches = 0
