"""The z-banded implicit GEMM (``csrc/zband_sm90.cu``): the BEV convs of K2,
K3 and K4 at every width their preset sm90 tiles do not take.

A z-folded conv's weight [k, k, Zi*Ci, Zo*Co] is block-banded: output
slab zo of the 3x3x3 stride-1 fold (``bev_grid.fold_w2_stride1``) reads
input slabs zo - 1 .. zo + 1, the k2s2 down's (``fold_w2_k2s2``) 2 zo + t
- lo, t in (0, 1), and every other block is zero.  The kernel's tile is an
8 x 16 patch of output cells times BLOCK_N channels of one output slab;
its K loop visits only that slab's live input slabs, then the spatial taps,
then SLAB-channel slices of the slab (``zband_tile``, ``zband_step``).  It
reads the fold's live blocks alone and takes every other block as the
zeros the fold puts there.  Slabs are read at a multiple of 8 channels
(the wrappers pad: ``widths.pad_slabs``).

``zband_tiling`` is the kernel's launch geometry, its one source: the 5-D
tensor-map views of x and w, the widths and the schedule.  ``zband_conv``
launches one of its four instances (``INST_*``) on CUDA tensors whose
shapes the caller checked.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from agplace_tpu_torch.data.voxels import me_down_align
from agplace_tpu_torch.ops import _build

_BF16 = torch.bfloat16
FOLD_S1, FOLD_K2S2 = "s1", "k2s2"
# the instances: K2's down0 (k2s2, BN0 prologue, bf16 epilogue), K3's conv
# phases (3x3, bf16 relu-mask / pool epilogues), K4's down0 half (k2s2,
# fp32 epilogue)
INST_K2, INST_K3_RELU, INST_K3_POOL, INST_K4_DOWN = range(4)
FOLDS = {INST_K2: FOLD_K2S2, INST_K3_RELU: FOLD_S1, INST_K3_POOL: FOLD_S1,
         INST_K4_DOWN: FOLD_K2S2}
PATCH_X, PATCH_Y, BLOCK_N, SLAB = 8, 16, 64, 64
BLOCKS_PER_SM = 2


@dataclass(frozen=True)
class ZbandTiling:
    """Launch geometry of one instance over x [B, X, Y, Zi*Ci] with w [k, k,
    Zi*Ci, Zo*Co] (Ci, Co multiples of 8), as the kernel takes it
    (``args``).  Tile ``i`` is (((b * npx + xp) * npy + yp) * zo + o) * ntn
    + n; block j takes tiles j, j + grid, ...  Tensor-map dims and boxes are
    innermost first: x as (Ci, Zi, Y, X, B) for the 3x3 conv, (Ci, 2 Zi,
    Yo, 2, B Xo) for the k2s2 down; w as (Co, Zo, Ci, Zi, taps)."""

    x_dims: Tuple[int, int, int, int, int]
    x_box: Tuple[int, int, int, int, int]
    w_dims: Tuple[int, int, int, int, int]
    w_box: Tuple[int, int, int, int, int]
    X: int
    Y: int
    Xo: int
    Yo: int
    zi: int
    ci: int
    zo: int
    co: int
    npx: int
    npy: int
    ntn: int  # N tiles of a slab: ceil(Co / BLOCK_N)
    nks: int  # K slices of a slab: ceil(Ci / SLAB)
    taps: int
    zk: int  # the fold's input slabs per output slab
    zs: int  # input slab of (zo, t): zs * zo + t - zlo
    zlo: int
    tiles: int
    grid: int

    @property
    def fold(self) -> str:
        return FOLD_S1 if self.taps == 9 else FOLD_K2S2

    def args(self) -> Tuple[int, ...]:
        """The fields flat, in order: the kernel's geometry arguments."""
        return (*self.x_dims, *self.x_box, *self.w_dims, *self.w_box,
                self.X, self.Y, self.Xo, self.Yo, self.zi, self.ci, self.zo,
                self.co, self.npx, self.npy, self.ntn, self.nks, self.taps,
                self.zk, self.zs, self.zlo, self.tiles, self.grid)


def zband_tiling(fold: str, b: int, x: int, y: int, zi: int, ci: int,
                 co: int, sms: int) -> ZbandTiling:
    """The persistent grid of BLOCKS_PER_SM blocks per SM (``sms``: the
    card's SM count) over B x X x Y cells of zi slabs of ci channels, to co
    channels per output slab (ci, co multiples of 8)."""
    if fold == FOLD_S1:
        xo, yo, zo, taps, zk, zs, zlo = x, y, zi, 9, 3, 1, 1
        x_dims, x_box = (ci, zi, y, x, b), (SLAB, 1, PATCH_Y, PATCH_X, 1)
    else:
        lo, _, zo = me_down_align(zi)
        xo, yo, taps, zk, zs, zlo = x // 2, y // 2, 4, 2, 2, lo
        x_dims = (ci, 2 * zi, yo, 2, b * xo)
        x_box = (SLAB, 1, PATCH_Y, 1, PATCH_X)
    npx, npy = -(-xo // PATCH_X), -(-yo // PATCH_Y)
    ntn, nks = -(-co // BLOCK_N), -(-ci // SLAB)
    tiles = b * npx * npy * zo * ntn
    return ZbandTiling(x_dims, x_box, (co, zo, ci, zi, taps),
                       (BLOCK_N, 1, SLAB, 1, 1), x, y, xo, yo, zi, ci, zo, co,
                       npx, npy, ntn, nks, taps, zk, zs, zlo, tiles,
                       min(tiles, BLOCKS_PER_SM * sms))


def live_slabs(t: ZbandTiling, o: int) -> range:
    """The input slabs output slab ``o`` reads: the fold's zs * o + s -
    zlo, s < zk, clipped to [0, Zi)."""
    first = t.zs * o - t.zlo
    return range(max(first, 0), min(first + t.zk, t.zi))


def zband_tile(t: ZbandTiling, tile: int):
    """Tile ``tile`` as the kernel decodes it: (b, x0, y0, zo, n0, live
    input slabs, K steps), x0 and y0 the patch origin in output cells, n0
    the first output channel of the slab."""
    n0, r = (tile % t.ntn) * BLOCK_N, tile // t.ntn
    o, r = r % t.zo, r // t.zo
    yp, r = r % t.npy, r // t.npy
    xp, b = r % t.npx, r // t.npx
    live = live_slabs(t, o)
    return (b, xp * PATCH_X, yp * PATCH_Y, o, n0, live,
            len(live) * t.taps * t.nks)


def zband_step(t: ZbandTiling, tile: int, i: int):
    """K step ``i`` of tile ``tile``: (input slab, tap, first channel of
    the slice, the x box's start, the w box's start), the starts innermost
    first as the producer issues them (negative or past the view: zeros)."""
    b, x0, y0, o, n0, live, _ = zband_tile(t, tile)
    ks, r = i % t.nks, i // t.nks
    tap, zi = r % t.taps, live[0] + r // t.taps
    c0 = ks * SLAB
    if t.fold == FOLD_S1:
        dx, dy = divmod(tap, 3)
        xs = (c0, zi, y0 + dy - 1, x0 + dx - 1, b)
    else:
        dx, dy = divmod(tap, 2)
        xs = (c0, dy * t.zi + zi, y0, dx, b * t.Xo + x0)
    return zi, tap, c0, xs, (n0, o, c0, zi, tap)


def mma_depth(t: ZbandTiling, i: int) -> int:
    """The channels of K step ``i``'s slice the MMAs read: its 16-deep
    steps that hold live channels (all 64 but in a slab's last, ragged
    slice); the rest of the slice is zeros and is not issued."""
    return min(SLAB, t.ci - (i % t.nks) * SLAB + 15) // 16 * 16


def _f32(v):
    """An fp32 affine as the kernel reads it (pairs as 8-byte vectors)."""
    return None if v is None else _build.aligned(v.float())


def zband_conv(inst: int, x, w, scale, bias, mask, z: int, mask_in=None,
               s_in=None, b_in=None):
    """Launch instance ``inst`` on CUDA tensors: x [B, X, Y, Zi*Ci] bf16 of
    z = Zi slabs, w [k, k, Zi*Ci, Zo*Co] (Ci, Co multiples of 8), the
    epilogue's affine [Zo*Co], the output occupancy ``mask`` [B, Xo, Yo,
    Zo], and for INST_K2 the input occupancy ``mask_in`` [B, X, Y, Zi] and
    BN0's affine [Zi*Ci].  Returns the [B, Xo, Yo, Zo*Co] bf16 map, and for
    INST_K3_POOL also its fp32 masked sums [B, Zo*Co]."""
    b, xd, yd, zci = x.shape
    zo = int(mask.shape[3])
    zco = int(w.shape[3])
    dev = x.device
    t = zband_tiling(FOLDS[inst], b, xd, yd, z, zci // z, zco // zo,
                     torch.cuda.get_device_properties(
                         dev).multi_processor_count)
    out = torch.empty((b, t.Xo, t.Yo, zco), dtype=_BF16, device=dev)
    pool = (torch.zeros((b, zco), dtype=torch.float32, device=dev)
            if inst == INST_K3_POOL else None)
    _build.call("agp_zband", _build.aligned(x), _build.aligned(w.to(_BF16)),
                None if mask_in is None else mask_in.contiguous(),
                _f32(s_in), _f32(b_in), _f32(scale), _f32(bias),
                mask.contiguous(), out, pool, inst, *t.args())
    return (out, pool) if pool is not None else out
