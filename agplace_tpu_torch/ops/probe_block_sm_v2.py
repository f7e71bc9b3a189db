"""P1 — the eval ECA block with each 3x3 conv as an im2col-concat GEMM.

Port of the probe kernel ``scripts/probe_block_sm_v2.py:make_v2``
(``fused_v2``, whose Pallas call is at ``:178``), an alternative formulation
of K3 (``ops/bev_block_sm.py``).  It computes K3's block with K3's rounding
points; only the conv differs: the nine taps go in groups of ``chunk`` (1, 3
or 9), each group is one product over ``chunk * Zcin`` concatenated
channels, the groups summed in fp32 and the sum rounded to bf16 once
(``probe_block_sm_v2.py:62-80``).  The JAX module's ``CHUNK`` environment
variable is the ``chunk`` argument here.

The CUDA version keeps K3's phase split (the ECA pool is a reduction over a
whole batch item).  Its two conv phases (``concat_conv_phase``,
``csrc/probe_block_sm_v2.cu``) run on TMA + wgmma: per (patch, 64-channel
slab) one TMA box brings the halo'd input patch into shared memory once,
every tap reads shifted rows of it, and each ring stage holds ``chunk``
taps' weights; ``concat_conv_tiling`` is their launch geometry, its one
source, and ``concat_conv_coords`` replays their boxes on the CPU.  The
ECA phase and the combine (with the 1x1 downsample in its GEMM) are K3's
own (``csrc/eca.cuh``, ``csrc/bev_block_sm.cu``).  ``eca_block_concat_plain``
is the plain version, the probe kernel's arithmetic in PyTorch, written
with the conv phases' plain version ``concat_conv_phase_plain``.  No model
path calls P1, as in JAX; ``scripts/probe_torch_block_sm_v2.py`` times it
against K3.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from agplace_tpu_torch.ops import _build, bev_block_sm
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16
CHUNKS = (1, 3, 9)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on the H100
# The conv phases' tiles, as the kernel is compiled: an output patch of
# PATCH = 16 x 8 cells (128 GEMM rows) and BLOCK_N output channels, K slabs
# of SLAB input channels (one 128-byte row of bf16 per halo cell), halo
# rows of HY cells read by each tap through shifted shared-memory
# descriptors, and BLOCKS_PER_SM resident blocks.  Two blocks per SM
# measured 1.18-1.38x faster than one with larger stages (PERF.md section
# 6, PR 9).
BLOCK_N, SLAB = 128, 64
PATCH = (16, 8)
HY = 10
BLOCKS_PER_SM = 2


def stage_channels(chunk: int) -> int:
    """Input channels of a weight stage (``chunk`` taps of them): two
    blocks per SM leave a block about 100 KB, so 64 at chunk 1, 32 at
    chunk 3 and 16 at chunk 9."""
    return SLAB // {1: 1, 3: 2, 9: 4}[chunk]


@dataclass(frozen=True)
class ConcatConvTiling:
    """Launch geometry of one conv phase over x [B, X, Y, Zcin] with w
    [3, 3, Zcin, Zcout], as the kernel takes it (``args``).  Tile ``i`` is
    ((b * npx + xp) * npy + yp) * ntn + nt; block j takes tiles j, j + grid,
    ...  Tensor-map dims and boxes are innermost first, as TMA takes them;
    boxes past Zcin, Zcout or the map read zeros."""

    x_dims: Tuple[int, int, int, int]  # (Zcin, Y, X, B)
    x_box: Tuple[int, int, int, int]  # the halo: (SLAB, HY, PX + 2, 1)
    w_dims: Tuple[int, int, int]  # (Zcout, Zcin, 9): w as [9, Zcin, Zcout]
    w_box: Tuple[int, int, int]  # (64, stage channels, chunk taps)
    npx: int  # patches along x
    npy: int  # patches along y
    ntn: int  # output-channel tiles
    steps: int  # ring stages per tile: slabs x 9 / chunk x SLAB / KC
    tiles: int
    grid: int  # blocks

    @property
    def patch(self) -> Tuple[int, int]:
        return self.x_box[2] - 2, 128 // (self.x_box[2] - 2)

    def args(self) -> Tuple[int, ...]:
        """The fields flat, in order: the kernel's geometry arguments."""
        return (*self.x_dims, *self.x_box, *self.w_dims, *self.w_box,
                self.npx, self.npy, self.ntn, self.steps, self.tiles,
                self.grid)


def concat_conv_tiling(b: int, xd: int, yd: int, zci: int, zco: int,
                       chunk: int, sms: int) -> ConcatConvTiling:
    """The persistent grid of ``BLOCKS_PER_SM`` blocks per SM (``sms``: the
    card's SM count)."""
    px, py = PATCH
    kc = stage_channels(chunk)
    npx, npy, ntn = -(-xd // px), -(-yd // py), -(-zco // BLOCK_N)
    tiles = b * npx * npy * ntn
    return ConcatConvTiling((zci, yd, xd, b), (SLAB, HY, px + 2, 1),
                            (zco, zci, 9), (BLOCK_N // 2, kc, chunk), npx,
                            npy, ntn, -(-zci // SLAB) * (9 // chunk)
                            * (SLAB // kc), tiles,
                            min(tiles, sms * BLOCKS_PER_SM))


def concat_conv_coords(t: ConcatConvTiling, tile: int, step: int):
    """What ring stage ``step`` of tile ``tile`` loads and reads, as the
    kernel computes it from ``t``: (the halo box at (c0, y0 - 1, x0 - 1, b)
    when the step starts a slab, else None; the two w boxes at (n0, c, j *
    chunk) and (n0 + 64, c, j * chunk), c = c0 + the stage's channel
    offset; the stage's taps j * chunk .. j * chunk + chunk - 1; that
    channel offset into the halo's rows)."""
    chunk, kc = t.w_box[2], t.w_box[1]
    h = SLAB // kc
    px, py = t.patch
    nt, r = tile % t.ntn, tile // t.ntn
    yp, r = r % t.npy, r // t.npy
    xp, b = r % t.npx, r // t.npx
    x0, y0, n0 = xp * px, yp * py, nt * BLOCK_N
    s, j, hh = step // (9 // chunk * h), (step // h) % (9 // chunk), step % h
    c0 = s * SLAB
    halo = (c0, y0 - 1, x0 - 1, b) if step % (9 // chunk * h) == 0 else None
    c = c0 + hh * kc
    return (halo, ((n0, c, j * chunk), (n0 + BLOCK_N // 2, c, j * chunk)),
            range(j * chunk, (j + 1) * chunk), hh * kc)


def _conv3x3_concat(src, w, chunk: int):
    """'same' 3x3 conv of src [B,X,Y,K] (bf16) with w [3,3,K,N]: one fp32
    product per group of ``chunk`` taps over their concatenated windows,
    the groups summed in fp32.  Returns fp32 [B,X,Y,N]."""
    b, xd, yd, _ = src.shape
    pad = F.pad(src, (0, 0, 1, 1, 1, 1))
    w = w.to(_BF16)
    taps = [(dx, dy) for dx in range(3) for dy in range(3)]
    acc = None
    for i0 in range(0, 9, chunk):
        grp = taps[i0:i0 + chunk]
        cols = torch.cat([pad[:, dx:dx + xd, dy:dy + yd] for dx, dy in grp],
                         dim=-1)
        wg = torch.cat([w[dx, dy] for dx, dy in grp], dim=0)
        d = cols.reshape(-1, cols.shape[-1]).float() @ wg.float()
        acc = d if acc is None else acc + d
    return acc.reshape(b, xd, yd, -1)


def concat_conv_phase_plain(x, mask, w, scale, bias, z: int, pool: bool,
                            chunk: int = 3):
    """One of P1's conv phases in plain PyTorch: the concat conv rounded to
    bf16 once, the BN affine in bf16.  Phase 1 (``pool`` False) returns
    relu(bn(conv(x))) * mask; phase 2 returns (g = bn(conv(x)), the fp32
    masked sum of g [B, Zcout])."""
    v = _conv3x3_concat(x.to(_BF16), w, chunk).to(_BF16)
    v = v * scale.to(_BF16) + bias.to(_BF16)
    if not pool:
        return bg.mask_bev(torch.relu(v), mask, z)
    return v, bg.mask_bev(v, mask, z).float().sum(dim=(1, 2))


def eca_block_concat_plain(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                           w_eca, z: int, wd=None, scale_d=None, bias_d=None,
                           chunk: int = 3):
    b, _, _, zci = x.shape
    zco = int(w2.shape[3])
    c = zco // z
    x = x.to(_BF16)
    h = concat_conv_phase_plain(x, mask, w1, scale1, bias1, z, False, chunk)
    # ECA: fp32 masked mean of g (not rounded), 1-D channel conv, sigmoid
    g, s_zc = concat_conv_phase_plain(h, mask, w2, scale2, bias2, z, True,
                                      chunk)
    cnt = torch.clamp(mask.float().sum(dim=(1, 2, 3)), min=1.0)[:, None]
    pooled = s_zc.reshape(b, z, c).sum(dim=1) / cnt
    k = int(w_eca.shape[0])
    half = (k - 1) // 2
    padded = F.pad(pooled, (half, k - 1 - half))
    att = torch.zeros_like(pooled)
    for t in range(k):
        att = att + w_eca[t].float() * padded[:, t:t + c]
    att_zc = torch.sigmoid(att).repeat(1, z).to(_BF16)[:, None, None, :]
    r = x
    if wd is not None:
        r = (x.reshape(-1, zci).float()
             @ wd.to(_BF16).reshape(zci, zco).float()).to(_BF16)
        r = (r * scale_d.to(_BF16) + bias_d.to(_BF16)).reshape(g.shape)
    return bg.mask_bev(torch.relu(g * att_zc + r), mask, z)


def smem_bytes(chunk: int) -> int:
    """Shared memory of one block of P1's conv phases (from the kernel)."""
    return _build.lib().agp_p1_smem_bytes(chunk)


def concat_conv_phase(x, mask, w, scale, bias, z: int, pool: bool,
                      chunk: int = 3):
    """One of P1's conv phases (``csrc/probe_block_sm_v2.cu`` on the card,
    ``concat_conv_phase_plain`` on the CPU): x [B,X,Y,Zcin] bf16, mask
    [B,X,Y,Z] bool, w [3,3,Zcin,Zcout] folded, scale/bias [Zcout], Zcin and
    Zcout multiples of 32, Zcout/z of 8.  Phase 1 returns h =
    relu(bn(conv(x))) * mask; phase 2 (``pool``) returns (g = bn(conv(x)),
    its fp32 masked sum [B, Zcout])."""
    b, xd, yd, zci = x.shape
    zco = int(w.shape[3])
    _build.check(chunk in CHUNKS, f"concat_conv_phase: chunk {chunk} not "
                 f"in {CHUNKS}")
    _build.check(x.dtype == _BF16 and mask.dtype == torch.bool
                 and tuple(w.shape) == (3, 3, zci, zco)
                 and tuple(mask.shape) == (b, xd, yd, z)
                 and tuple(scale.shape) == tuple(bias.shape) == (zco,),
                 f"concat_conv_phase: x {tuple(x.shape)} {x.dtype} mask "
                 f"{tuple(mask.shape)} {mask.dtype} w {tuple(w.shape)} "
                 f"scale {tuple(scale.shape)} at z={z}")
    bev_block_sm.check_widths("concat_conv_phase", zci, zco, z, 32, 32)
    if not _build.on_cuda(x, mask, w, scale, bias):
        return concat_conv_phase_plain(x, mask, w, scale, bias, z, pool,
                                       chunk)
    _build.check(smem_bytes(chunk) <= SMEM_LIMIT,
                 f"concat_conv_phase: chunk {chunk} needs "
                 f"{smem_bytes(chunk)} bytes of shared memory")
    t = concat_conv_tiling(b, xd, yd, zci, zco, chunk, torch.cuda.
                           get_device_properties(x.device).
                           multi_processor_count)
    out = torch.empty((b, xd, yd, zco), dtype=_BF16, device=x.device)
    sums = (torch.zeros((b, zco), dtype=torch.float32, device=x.device)
            if pool else None)
    _build.call("agp_p1_conv_sm90", _build.aligned(x), mask.contiguous(),
                _build.aligned(w.to(_BF16)), scale.float().contiguous(),
                bias.float().contiguous(), out, sums, int(pool), chunk, z,
                *t.args())
    return (out, sums) if pool else out


def fused_eca_block_concat(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                           w_eca, z: int, wd=None, scale_d=None, bias_d=None,
                           chunk: int = 3):
    """K3's arguments (``fused_eca_block_sm``) plus ``chunk``, the taps per
    concatenated group (1, 3 or 9).  Returns [B,X,Y,Z*Cout] bf16."""
    _build.check(chunk in CHUNKS, f"fused_eca_block_concat: chunk {chunk} "
                 f"not in {CHUNKS}")
    ds = () if wd is None else (wd, scale_d, bias_d)
    if not _build.on_cuda(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                          w_eca, *ds):
        return eca_block_concat_plain(x, mask, w1, w2, scale1, bias1, scale2,
                                      bias2, w_eca, z, wd, scale_d, bias_d,
                                      chunk)
    bev_block_sm.check_block_args("fused_eca_block_concat", x, w1, w2, z, wd,
                                  32, 32)
    x = _build.aligned(x)
    m = mask.contiguous()
    h = concat_conv_phase(x, m, w1, scale1, bias1, z, False, chunk)
    g, pool = concat_conv_phase(h, m, w2, scale2, bias2, z, True, chunk)
    # the ECA phase and the combine are K3's (their math is identical)
    out = bev_block_sm.eca_combine(x, m, g, pool, w_eca, z, wd, scale_d,
                                   bias_d)
    fused_eca_block_concat.launches += 1
    return out


fused_eca_block_concat.launches = 0
