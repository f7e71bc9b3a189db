"""P2 — BEV stage 0 as one concat GEMM over the four conv0 parity planes.

Port of the probe kernel ``scripts/probe_down_v2.py:make_v2`` (``fused_v2``,
whose Pallas call is at ``:143``), an alternative formulation of K2
(``ops/bev_down.py``).  conv0 runs outside the kernel as four bare stride-2
convs, one per output parity (cuDNN bf16, as XLA ran them outside the
Pallas call, ``:94-104``).  The CUDA kernel ``csrc/probe_down_v2.cu``
(``down_concat_gemm``) reads the four contiguous planes as one K = 4*Z*C1
operand, applies the wide BN0 affine, relu and the z-mask on the way in,
and the down BN, relu and the output mask in its epilogue.  At the widths
K2's tiles take it runs K2's Hopper main loop (TMA + RS wgmma, one 4-D box
of a plane per K step; ``down_concat_tiling`` is its launch geometry, its
one source, and ``down_concat_coords`` replays its boxes on the CPU); at
the narrower widths the first design took, its wmma kernel, chosen by
shape.
``down_concat_plain`` is the plain version, the probe kernel's arithmetic
in PyTorch, and ``down_concat_gemm_plain`` its GEMM half.  No model path
calls P2, as in JAX; ``scripts/probe_torch_down_v2.py`` times it against
K2.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build, bev_down
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16
# K2's tiles: an 8 x 16 patch of output cells, 128 output channels, K steps
# of one plane's 64-channel slab
PATCH_X, PATCH_Y, BLOCK_N, SLAB = (bev_down.PATCH_X, bev_down.PATCH_Y,
                                   bev_down.BLOCK_N, bev_down.SLAB)


@dataclass(frozen=True)
class DownConcatTiling:
    """Launch geometry of the Hopper route over the planes g_p [B, Xo, Yo,
    Z*C1] with wd [2, 2, Z*C1, Zo*C2], as the kernel takes it (``args``).
    Tile ``i`` is ((b * npx + xp) * npy + yp) * nn + n, block j takes tiles
    j, j + grid, ... (K2's order).  Tensor-map dims and boxes are innermost
    first; the four planes share one map shape."""

    g_dims: Tuple[int, int, int, int]  # (Z*C1, Yo, Xo, B)
    g_box: Tuple[int, int, int, int]  # (SLAB, PATCH_Y, PATCH_X, 1)
    w_dims: Tuple[int, int]  # (Zo*C2, 4 * Z*C1): wd as a row-major matrix
    w_box: Tuple[int, int]  # (64, SLAB): two boxes per step cover BLOCK_N
    npx: int  # patches along xo
    npy: int  # patches along yo
    nn: int  # N tiles: Zo*C2 / BLOCK_N
    steps: int  # K steps per tile: 4 planes x Z*C1 / SLAB slabs
    tiles: int
    grid: int  # blocks

    def args(self) -> Tuple[int, ...]:
        """The fields flat, in order: the kernel's geometry arguments."""
        return (*self.g_dims, *self.g_box, *self.w_dims, *self.w_box,
                self.npx, self.npy, self.nn, self.steps, self.tiles,
                self.grid)


def down_concat_tiling(b: int, xo: int, yo: int, zc1: int, zc2: int,
                       sms: int) -> DownConcatTiling:
    """The persistent grid of one block per SM (``sms``: the card's SM
    count)."""
    npx, npy, nn = -(-xo // PATCH_X), -(-yo // PATCH_Y), zc2 // BLOCK_N
    tiles = b * npx * npy * nn
    return DownConcatTiling((zc1, yo, xo, b), (SLAB, PATCH_Y, PATCH_X, 1),
                            (zc2, 4 * zc1), (BLOCK_N // 2, SLAB), npx, npy,
                            nn, 4 * zc1 // SLAB, tiles, min(tiles, sms))


def down_concat_coords(t: DownConcatTiling, tile: int, step: int):
    """What K step ``step`` of tile ``tile`` loads, as the kernel's
    producer computes it from ``t``: (plane p, the box of g_p at (c0, yo0,
    xo0, b) (past the map: zeros), the two wd boxes at (n0, k0) and (n0 +
    64, k0)), k0 = step * SLAB = p * Z*C1 + c0."""
    zc1 = t.g_dims[0]
    n0, r = (tile % t.nn) * BLOCK_N, tile // t.nn
    yp, r = r % t.npy, r // t.npy
    xp, b = r % t.npx, r // t.npx
    k0 = step * SLAB
    plane, c0 = divmod(k0, zc1)
    return (plane, (c0, yp * PATCH_Y, xp * PATCH_X, b),
            ((n0, k0), (n0 + BLOCK_N // 2, k0)))


def on_hopper_tiles(zc1: int, zc2: int, z: int) -> bool:
    """The route: K2's Hopper main loop where its tiles take the widths,
    the first design's wmma kernel at the other widths
    ``check_stage0_args`` takes."""
    return bev_down.down0_widths_ok(zc1, zc2, z)


def parity_planes(feats, w0_folded):
    """conv0 as four bare stride-2 convs in bf16.  Plane ``2*px + py`` is
    the full-resolution 'same' conv at the cells ``(2*xo + px, 2*yo + py)``:
    its padding is ``(h - px, k0 - 2 - h + px)`` on x (and likewise on y)
    with ``h = k0 // 2``.  Each is [B, X/2, Y/2, Z*C1]."""
    k0 = int(w0_folded.shape[0])
    h = k0 // 2
    fb = feats.to(_BF16)
    return [bg.bev_conv2d(fb, w0_folded, 2, (h - px, k0 - 2 - h + px),
                          (h - py, k0 - 2 - h + py))
            for px in range(2) for py in range(2)]


def _parity_mask(mask, c1: int):
    """[B, X, Y, Z] -> [B, X/2, Y/2, 4*Z*C1]: the z-mask of each parity
    plane, in the planes' concatenation order, expanded over C1."""
    b, x, y, z = mask.shape
    m = (mask.reshape(b, x // 2, 2, y // 2, 2, z).permute(0, 1, 3, 2, 4, 5)
         .reshape(b, x // 2, y // 2, 4 * z))
    return m.repeat_interleave(c1, dim=-1)


def down_concat_gemm_plain(planes, mask, scale0, bias0, wd_folded, scale_d,
                           bias_d, mask_out, *, z: int):
    """The GEMM half of ``down_concat_plain`` on precomputed planes and
    output mask.  Returns [B, X/2, Y/2, Zo*C2] bf16."""
    b, xo, yo, zc1 = planes[0].shape
    zc2 = int(wd_folded.shape[3])
    zo = me_down_align(z)[2]
    g = torch.cat(list(planes), dim=-1)
    s0 = scale0.to(_BF16).repeat(4)  # the wide affine over 4*Z*C1
    b0 = bias0.to(_BF16).repeat(4)
    act = torch.where(_parity_mask(mask, zc1 // z), torch.relu(g * s0 + b0),
                      0)
    wd = wd_folded.to(_BF16).reshape(4 * zc1, zc2)
    acc = act.float().reshape(-1, 4 * zc1) @ wd.float()
    out = (acc.to(_BF16) * scale_d.to(_BF16) + bias_d.to(_BF16))
    return bg.mask_bev(torch.relu(out).reshape(b, xo, yo, zc2), mask_out, zo)


def down_concat_plain(feats, mask, w0_folded, scale0, bias0, wd_folded,
                      scale_d, bias_d, *, z: int):
    lo_z, hi_z, _ = me_down_align(z)
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z))
    out = down_concat_gemm_plain(parity_planes(feats, w0_folded), mask,
                                 scale0, bias0, wd_folded, scale_d, bias_d,
                                 mask_out, z=z)
    return out, mask_out


def down_concat_gemm(planes, mask, scale0, bias0, wd_folded, scale_d,
                     bias_d, mask_out, *, z: int):
    """P2's kernel on the card (``down_concat_gemm_plain`` on the CPU): the
    four parity planes [B,X/2,Y/2,Z*C1] bf16 (conv0's bare output, plane
    2*px + py), mask [B,X,Y,Z] bool, scale0/bias0 [Z*C1], wd_folded
    [2,2,Z*C1,Zo*C2], scale_d/bias_d [Zo*C2], mask_out [B,X/2,Y/2,Zo] bool.
    Returns [B,X/2,Y/2,Zo*C2] bf16."""
    _build.check(len(planes) == 4
                 and all(p.shape == planes[0].shape for p in planes),
                 f"down_concat_gemm: four planes of one shape, got "
                 f"{[tuple(p.shape) for p in planes]}")
    b, xo, yo, zc1 = planes[0].shape
    zc2 = int(wd_folded.shape[3])
    zo = me_down_align(z)[2]
    _build.check(zc1 % 32 == 0 and (zc1 // z) % 8 == 0
                 and (zc2 // zo) % 8 == 0 and zc2 % 8 == 0
                 and tuple(wd_folded.shape) == (2, 2, zc1, zc2),
                 f"down_concat_gemm: widths {zc1}->{zc2} at z={z}, wd "
                 f"{tuple(wd_folded.shape)}: not multiples of the kernel's "
                 f"tiles")
    bev_down.check_down0_tensors("down_concat_gemm", mask, scale0, bias0,
                                 scale_d, bias_d, mask_out, b, 2 * xo,
                                 2 * yo, zc1, zc2, z)
    ins = (*planes, mask, scale0, bias0, wd_folded, scale_d, bias_d,
           mask_out)
    if not _build.on_cuda(*ins):
        return down_concat_gemm_plain(planes, mask, scale0, bias0,
                                      wd_folded, scale_d, bias_d, mask_out,
                                      z=z)
    _build.check(all(p.dtype == _BF16 for p in planes),
                 "down_concat_gemm: bf16 planes")
    dev = planes[0].device
    gs = [_build.aligned(p) for p in planes]
    wd = _build.aligned(wd_folded.to(_BF16))
    out = torch.empty((b, xo, yo, zc2), dtype=_BF16, device=dev)
    m, mo = mask.contiguous(), mask_out.contiguous()
    sd, bd = scale_d.float().contiguous(), bias_d.float().contiguous()
    if on_hopper_tiles(zc1, zc2, z):
        t = down_concat_tiling(b, xo, yo, zc1, zc2, torch.cuda.
                               get_device_properties(dev).
                               multi_processor_count)
        _build.call("agp_down_concat_sm90", *gs, m,
                    scale0.float().contiguous(), bias0.float().contiguous(),
                    wd, sd, bd, mo, out, z, zo, *t.args())
    else:  # the wide affine over the 4*Z*C1 concatenated channels
        _build.call("agp_down_concat", *gs, m, scale0.float().repeat(4),
                    bias0.float().repeat(4), wd, sd, bd, mo, out, b, 2 * xo,
                    2 * yo, zc1, z, zc2, zo)
    return out


def fused_down_concat(feats, mask, w0_folded, scale0, bias0, wd_folded,
                      scale_d, bias_d, *, z: int):
    """The arguments of K2's ``fused_conv0_down0``: feats [B,X,Y,Z*C0],
    mask [B,X,Y,Z] bool, w0_folded [k0,k0,Z*C0,Z*C1], scale0/bias0 [Z*C1]
    fp32, wd_folded [2,2,Z*C1,Zo*C2], scale_d/bias_d [Zo*C2] fp32.
    Returns (feats [B,X/2,Y/2,Zo*C2] bf16, mask_out [B,X/2,Y/2,Zo])."""
    ins = (feats, mask, w0_folded, scale0, bias0, wd_folded, scale_d,
           bias_d)
    if not _build.on_cuda(*ins):
        return down_concat_plain(*ins, z=z)
    lo_z, hi_z, _ = me_down_align(z)
    bev_down.check_stage0_args("fused_down_concat", feats, w0_folded,
                               wd_folded, z)
    mask_out = bg.mask_down(mask, (0, 0), (0, 0), (lo_z, hi_z)).contiguous()
    out = down_concat_gemm(parity_planes(feats, w0_folded), mask, scale0,
                           bias0, wd_folded, scale_d, bias_d, mask_out, z=z)
    fused_down_concat.launches += 1
    return out, mask_out


fused_down_concat.launches = 0
