"""K5 — the ResNet stem tail: BN eval affine, relu, maxpool 3x3/2 pad 1.

Port of ``agplace_tpu/ops/pallas/stem_pool.py:fused_affine_relu_maxpool``.
The CUDA kernel (``csrc/stem_pool.cu``) streams each input row of a band of
output rows once through a shared-memory ring (1-D bulk copies), applies
the affine once per input element and writes only the pooled quarter-size
map.  ``stem_pool_tiling`` is its launch geometry, its one source, and
``stem_pool_unit`` replays what each work unit reads.
``stem_pool_plain`` is the plain version with the kernel's rounding
(``stem_pool.py:62-73``): scale and bias rounded to bf16, ``relu(x * s +
b)`` in fp32 with one bf16 round, then the 3x3/2 window max.  That is not
the unfused module path, which applies the affine in bf16 (a multiply and
an add, each rounded; ``norm.py:76-78``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from agplace_tpu_torch.ops import _build

_BF16 = torch.bfloat16
# The kernel's limits: a unit's row has at most ROW_POSITIONS (output
# column, 8-channel vector) positions (256 consumer threads, two each), a
# channel tile at most MAX_VECTORS vectors; bands of at most MAX_BAND
# output rows; two blocks per SM.
ROW_POSITIONS, MAX_VECTORS, MAX_BAND, BLOCKS_PER_SM = 512, 256, 16, 2


@dataclass(frozen=True)
class StemPoolTiling:
    """Launch geometry of K5 over x [B, H, W, C], as the kernel takes it
    (``args``).  Unit ``u`` is ((b * nband + band) * ntw + wtile) * nct +
    ctile; the persistent grid's block ``i`` takes units i, i + grid, ..."""

    ct: int  # 8-channel vectors per channel tile
    nct: int  # channel tiles
    tw: int  # output columns per column tile
    ntw: int  # column tiles
    band: int  # output rows per band
    nband: int  # bands per item
    units: int  # B * nband * ntw * nct
    slot: int  # bytes of a ring slot: one input row of a unit
    grid: int  # blocks

    def args(self) -> Tuple[int, ...]:
        """The fields flat, in order: the kernel's geometry arguments."""
        return (self.ct, self.nct, self.tw, self.ntw, self.band, self.nband,
                self.units, self.slot, self.grid)


def stem_pool_tiling(b: int, h: int, w: int, c: int,
                     sms: int) -> StemPoolTiling:
    """Channel tiles only past MAX_VECTORS vectors (C > 2048); column tiles
    only where a row tile would exceed ROW_POSITIONS positions (at C = 64,
    W > 128), each with a one-column left halo in its slot; bands as long
    as leave no SM of ``sms`` (the card's SM count) without a unit, at most
    MAX_BAND rows: 16 at [32, 128, 128, 64] on 132 SMs (128 units), and at
    b128 (512 units over a grid of BLOCKS_PER_SM blocks per SM); a single
    query's 64 output rows go in 64 bands of one."""
    cpp, ho, wo = c // 8, h // 2, w // 2
    nct = -(-cpp // MAX_VECTORS)
    ct = -(-cpp // nct)
    tw = min(wo, ROW_POSITIONS // ct)
    ntw = -(-wo // tw)
    slot = (2 * tw + (ntw > 1)) * ct * 16
    band = max(1, min(MAX_BAND, ho, -(-b * ho * ntw * nct // sms)))
    nband = -(-ho // band)
    units = b * nband * ntw * nct
    return StemPoolTiling(ct, nct, tw, ntw, band, nband, units, slot,
                          min(units, BLOCKS_PER_SM * sms))


def stem_pool_unit(t: StemPoolTiling, h: int, w: int, c: int, u: int):
    """What unit ``u`` computes and reads, as the kernel's ``unit_of``
    derives it from ``t``: item b, output rows [r0, r0 + rows), output
    columns [ow0, ow0 + tw_u), channel vectors [cv0, cv0 + ct_u), input rows
    [i0, i1] and input columns [c_lo, c_hi].  Input column c lands in slot
    column c - (2 * ow0 - halo): column 0 of a split row's slot holds its
    left halo."""
    ctile, u = u % t.nct, u // t.nct
    wtile, u = u % t.ntw, u // t.ntw
    band, b = u % t.nband, u // t.nband
    r0, ow0, cv0 = band * t.band, wtile * t.tw, ctile * t.ct
    rows = min(t.band, h // 2 - r0)
    tw_u = min(t.tw, w // 2 - ow0)
    return dict(b=b, r0=r0, rows=rows, ow0=ow0, tw=tw_u, cv0=cv0,
                ct=min(t.ct, c // 8 - cv0), i0=max(2 * r0 - 1, 0),
                i1=2 * (r0 + rows) - 1, c_lo=max(2 * ow0 - 1, 0),
                c_hi=2 * (ow0 + tw_u) - 1, halo=int(t.ntw > 1))


def stem_pool_plain(x, scale, bias):
    s = scale.to(_BF16).float()
    b = bias.to(_BF16).float()
    y = torch.relu(x.float() * s + b).to(_BF16)
    # max_pool2d pads with -inf; every tap is >= 0 after the relu, so this
    # is the kernel's zero pad
    return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


def fused_affine_relu_maxpool(x, scale, bias):
    """x [B,H,W,C] bf16 (the stem conv output), scale/bias [C] fp32 (BN eval
    affine) -> maxpool3x3/2,pad1(relu(x*scale+bias)) as [B,H/2,W/2,C] bf16.
    H and W must be even (every ResNet stem shape is) and scale / bias of
    shape [C]: other shapes raise, on either device.  The kernel takes C in
    multiples of 8; an x that is not dense and 16-byte aligned (its bulk
    copies' unit) is copied first."""
    b, h, w, c = x.shape
    _build.check(h % 2 == 0 and w % 2 == 0,
                 f"fused_affine_relu_maxpool: H, W = {h}, {w} must be even")
    _build.check(tuple(scale.shape) == (c,) and tuple(bias.shape) == (c,),
                 f"fused_affine_relu_maxpool: scale {tuple(scale.shape)} and "
                 f"bias {tuple(bias.shape)} must be [{c}]")
    x = x.to(_BF16)
    if not _build.on_cuda(x, scale, bias):
        return stem_pool_plain(x, scale, bias)
    _build.check(c % 8 == 0,
                 f"fused_affine_relu_maxpool: C = {c} not a multiple of 8")
    x = _build.aligned(x)
    _build.check(x.dtype == _BF16 and x.data_ptr() % 16 == 0,
                 "fused_affine_relu_maxpool: the kernel reads a 16-byte "
                 "aligned bf16 x")
    t = stem_pool_tiling(b, h, w, c, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    out = torch.empty((b, h // 2, w // 2, c), dtype=_BF16, device=x.device)
    _build.call("agp_stem_pool", x, scale.float().contiguous(),
                bias.float().contiguous(), out, b, h, w, c, *t.args())
    fused_affine_relu_maxpool.launches += 1
    return out


fused_affine_relu_maxpool.launches = 0
