"""K3 — the eval-mode BEV ECA basic block.

Port of ``agplace_tpu/ops/pallas/bev_block_sm.py:fused_eca_block_sm``.  The
CUDA version runs the block as four hand-written phases: the two 3x3 convs
(``csrc/conv3x3_sm90.cu``: TMA + wgmma, conv+BN+relu+mask, then conv+BN
with the masked ECA pool in its epilogue), the ECA fold/conv/sigmoid
(``csrc/eca.cuh``), and attention multiply + residual + relu + mask, with
the 1x1 downsample conv+BN in the last phase's GEMM (``csrc/bev_block_sm.cu``).
There is no VMEM gate (``sm_block_vmem_ok`` has no counterpart); the conv
phases' tile rule (``check_block_args``) is the only shape rule.
``conv3x3_tiling`` is the conv phases' launch geometry, its one source:
the kernel takes the tensor-map dims and boxes, the patch grid, the K steps
and the grid from it.  ``eca_block_plain`` is the plain version, the JAX
module's unfused path (``bev_grid.py:496-512``), written with the conv
phases' plain version ``conv_phase_plain``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from agplace_tpu_torch.ops import _build
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16
# The conv phases' tiles: a block owns PATCH_X x PATCH_Y output cells of one
# item (128 GEMM rows) and BLOCK_N output channels; each K step is one tap
# of a SLAB-channel slab (one 128-byte row of bf16 per cell).
PATCH_X, PATCH_Y, BLOCK_N, SLAB = 8, 16, 128, 64
# The kernel's instances (its EPI): K3's bf16 epilogues (phase 1: relu and
# mask; phase 2: the masked pool), then K6's fp32 ones
EPI_BF16_RELU_MASK, EPI_BF16_POOL, EPI_F32_RELU_MASK, EPI_F32_POOL = range(4)


@dataclass(frozen=True)
class Conv3x3Tiling:
    """Launch geometry of one conv phase over x [B, X, Y, Zcin] with w
    [3, 3, Zcin, Zcout], as the kernel takes it (``args``).  Block ``i`` is
    ((b * npx + xp) * npy + yp) * ntn + nt; tensor-map dims and boxes are
    innermost first, as TMA takes them."""

    x_dims: Tuple[int, int, int, int]  # (Zcin, Y, X, B)
    x_box: Tuple[int, int, int, int]  # (SLAB, PATCH_Y, PATCH_X, 1)
    w_dims: Tuple[int, int]  # (Zcout, 9 * Zcin): w as a row-major matrix
    w_box: Tuple[int, int]  # (64, SLAB): two boxes per step cover BLOCK_N
    npx: int  # patches along x
    npy: int  # patches along y
    ntn: int  # output-channel tiles
    steps: int  # K steps: 9 taps x Zcin / SLAB slabs
    grid: int  # blocks

    def args(self) -> Tuple[int, ...]:
        """The fields flat, in order: the kernel's geometry arguments."""
        return (*self.x_dims, *self.x_box, *self.w_dims, *self.w_box,
                self.npx, self.npy, self.ntn, self.steps, self.grid)


def conv3x3_tiling(b: int, xd: int, yd: int, zci: int,
                   zco: int) -> Conv3x3Tiling:
    npx, npy, ntn = -(-xd // PATCH_X), -(-yd // PATCH_Y), zco // BLOCK_N
    return Conv3x3Tiling((zci, yd, xd, b), (SLAB, PATCH_Y, PATCH_X, 1),
                         (zco, 9 * zci), (BLOCK_N // 2, SLAB), npx, npy, ntn,
                         9 * zci // SLAB, b * npx * npy * ntn)


def conv3x3_coords(t: Conv3x3Tiling, block: int, step: int):
    """TMA coordinates of K step ``step`` of block ``block``, as the
    kernel's producer warp computes them from ``t``: the x box at (c0,
    y0 + dy - 1, x0 + dx - 1, b) (negative or past the map: zeros) and the
    two w boxes at (n0, k0) and (n0 + 64, k0), k0 = step * SLAB."""
    nt = block % t.ntn
    r = block // t.ntn
    yp, r = r % t.npy, r // t.npy
    xp, b = r % t.npx, r // t.npx
    k0 = step * SLAB
    tap, c0 = divmod(k0, t.x_dims[0])
    dx, dy = divmod(tap, 3)
    n0 = nt * BLOCK_N
    return ((c0, yp * PATCH_Y + dy - 1, xp * PATCH_X + dx - 1, b),
            ((n0, k0), (n0 + BLOCK_N // 2, k0)))


def eca_block_plain(x, mask, w1, w2, scale1, bias1, scale2, bias2, w_eca,
                    z: int, wd=None, scale_d=None, bias_d=None):
    fd = x.dtype
    g = bg.BEVGrid(feats=x, mask=mask, z=z)
    h = conv_phase_plain(x, mask, w1, scale1, bias1, z, pool=False)
    out = _conv_bn(h, w2, scale2, bias2)  # phase 2 without its pool
    out = bg.eca_apply(g.replace(feats=out), w_eca.reshape(-1, 1, 1))
    r = x
    if wd is not None:
        r = bg.bev_conv2d(x, wd, 1, (0, 0), (0, 0))
        r = r * scale_d.to(fd) + bias_d.to(fd)
    return bg.mask_bev(torch.relu(out + r), mask, z)


def check_widths(name, zci: int, zco: int, z: int, cin_tile: int,
                  cout_tile: int):
    _build.check(zci % cin_tile == 0 and zco % cout_tile == 0
                 and zco % z == 0 and (zco // z) % 8 == 0,
                 f"{name}: widths {zci}->{zco} at z={z} are not multiples of "
                 f"the kernel's tiles (Zcin of {cin_tile}, Zcout of "
                 f"{cout_tile}, Zcout/z of 8)")


def check_block_args(name, x, w1, w2, z: int, wd=None, cin_tile: int = SLAB,
                     cout_tile: int = BLOCK_N):
    """The CUDA phases' shape rules for an ECA block: folded widths that
    are multiples of the conv phases' tiles (K3: Zcin of 64, Zcout of 128;
    P1 passes 32 and 32) and 8-channel z slabs; returns (B, X, Y, Z*Cin,
    Z*Cout)."""
    b, xd, yd, zci = x.shape
    zco = int(w2.shape[3])
    _build.check(x.dtype == _BF16, f"{name}: bf16 x")
    _build.check(tuple(w1.shape) == (3, 3, zci, zco)
                 and tuple(w2.shape) == (3, 3, zco, zco),
                 f"{name}: w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}")
    check_widths(name, zci, zco, z, cin_tile, cout_tile)
    if wd is None:
        _build.check(zci == zco,
                     f"{name}: identity residual needs Cin == Cout")
    else:
        _build.check(tuple(wd.shape) == (1, 1, zci, zco),
                     f"{name}: wd {tuple(wd.shape)}")
    return b, xd, yd, zci, zco


def _conv_bn(x, w, scale, bias):
    """The 3x3 conv (bf16 operands) and BN affine in x's dtype."""
    fd = x.dtype
    return bg.bev_conv2d(x, w, 1, (1, 1), (1, 1)) * scale.to(fd) + bias.to(fd)


def conv_phase_plain(x, mask, w, scale, bias, z: int, pool: bool):
    """One conv phase in plain PyTorch, ``eca_block_plain``'s arithmetic.
    Phase 1 (``pool`` False) returns relu(bn(conv(x))) * mask; phase 2
    returns (g = bn(conv(x)), the fp32 masked sum of g [B, Z*Cout])."""
    v = _conv_bn(x, w, scale, bias)
    if not pool:
        return bg.mask_bev(torch.relu(v), mask, z)
    return v, bg.mask_bev(v, mask, z).float().sum(dim=(1, 2))


def conv_phase(x, mask, w, scale, bias, z: int, pool: bool):
    """One of K3's conv phases (``csrc/conv3x3_sm90.cu`` on the card,
    ``conv_phase_plain`` on the CPU): x [B,X,Y,Zcin] bf16, mask [B,X,Y,Z]
    bool, w [3,3,Zcin,Zcout] folded, scale/bias [Zcout], widths on the
    kernel's tiles.  Phase 1 returns h = relu(bn(conv(x))) * mask; phase 2
    (``pool``, Zcin == Zcout) returns (g = bn(conv(x)), its fp32 masked sum
    [B, Zcout])."""
    b, xd, yd, zci = x.shape
    zco = int(w.shape[3])
    _build.check(x.dtype == _BF16 and mask.dtype == torch.bool,
                 f"conv_phase: bf16 x and bool mask, got {x.dtype} and "
                 f"{mask.dtype}")
    _build.check(tuple(w.shape) == (3, 3, zci, zco)
                 and tuple(mask.shape) == (b, xd, yd, z)
                 and tuple(scale.shape) == tuple(bias.shape) == (zco,)
                 and (zci == zco or not pool),
                 f"conv_phase: x {tuple(x.shape)} mask {tuple(mask.shape)} "
                 f"w {tuple(w.shape)} scale {tuple(scale.shape)} at z={z}, "
                 f"pool={pool}")
    check_widths("conv_phase", zci, zco, z, SLAB, BLOCK_N)
    if not _build.on_cuda(x, mask, w, scale, bias):
        return conv_phase_plain(x, mask, w, scale, bias, z, pool)
    return conv3x3_launch(x, mask, w, scale, bias,
                          EPI_BF16_POOL if pool else EPI_BF16_RELU_MASK, z)


def conv3x3_launch(x, mask, w, scale, bias, epi: int, z: int):
    """Launch instance ``epi`` of ``csrc/conv3x3_sm90.cu`` on CUDA tensors
    whose shapes and widths the caller checked (K3's ``conv_phase``, K6's
    ``fused_eca_block``).  Returns the [B, X, Y, Zcout] bf16 map, and for
    the pool instances also its fp32 masked sums [B, Zcout]."""
    b, xd, yd, zci = x.shape
    zco = int(w.shape[3])
    t = conv3x3_tiling(b, xd, yd, zci, zco)
    out = torch.empty((b, xd, yd, zco), dtype=_BF16, device=x.device)
    pool = epi in (EPI_BF16_POOL, EPI_F32_POOL)
    sums = (torch.zeros((b, zco), dtype=torch.float32, device=x.device)
            if pool else None)
    _build.call("agp_conv3x3", _build.aligned(x), mask.contiguous(),
                _build.aligned(w.to(_BF16)), scale.float().contiguous(),
                bias.float().contiguous(), out, sums, epi, z, *t.args())
    return (out, sums) if pool else out


def eca_combine(x, m, g, pool, w_eca, z: int, wd=None, scale_d=None,
                bias_d=None):
    """Phases 3 and 4 on the card: the ECA attention from the masked pool
    [B, Z*Cout] fp32, then relu(g*att + r) * mask with r = x or the 1x1
    residual conv + BN in the combine's GEMM.  Returns [B,X,Y,Z*Cout]."""
    b, xd, yd, zci = x.shape
    zco = int(g.shape[3])
    att = torch.empty((b, zco), dtype=_BF16, device=x.device)
    w_e = w_eca.float().contiguous()
    _build.call("agp_block_eca", pool, m, w_e, int(w_e.shape[0]), att, b,
                xd * yd * z, z, zco // z)
    out = torch.empty_like(g)
    if wd is not None:
        _build.call("agp_block_combine_ds", x, m, _build.aligned(wd.to(_BF16)),
                    scale_d.float().contiguous(), bias_d.float().contiguous(),
                    g, att, out, b, xd, yd, zci, zco, z)
    else:
        _build.call("agp_block_combine_id", g, x, att, m, out, b, xd, yd,
                    zco, z)
    return out


def fused_eca_block_sm(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                       w_eca, z: int, wd=None, scale_d=None, bias_d=None):
    """x [B,X,Y,Z*Cin] (masked), mask [B,X,Y,Z] bool, w1 [3,3,Z*Cin,Z*Cout]
    and w2 [3,3,Z*Cout,Z*Cout] folded, scale/bias [Z*Cout] fp32 (BN eval
    affines), w_eca [k].  Channel-changing blocks pass the 1x1 residual: wd
    [1,1,Z*Cin,Z*Cout], scale_d/bias_d.  Returns [B,X,Y,Z*Cout]: bf16 from
    the kernel, which takes x in bf16 and rounds at bf16 points whatever
    the model's dtype, as JAX's does; the dtype of x from the plain
    version."""
    ds = () if wd is None else (wd, scale_d, bias_d)
    if not _build.on_cuda(x, mask, w1, w2, scale1, bias1, scale2, bias2,
                          w_eca, *ds):
        return eca_block_plain(x, mask, w1, w2, scale1, bias1, scale2,
                               bias2, w_eca, z, wd, scale_d, bias_d)
    x = _build.aligned(x.to(_BF16))
    check_block_args("fused_eca_block_sm", x, w1, w2, z, wd)
    m = mask.contiguous()
    h = conv_phase(x, m, w1, scale1, bias1, z, pool=False)
    g, pool = conv_phase(h, m, w2, scale2, bias2, z, pool=True)
    out = eca_combine(x, m, g, pool, w_eca, z, wd, scale_d, bias_d)
    fused_eca_block_sm.launches += 1
    return out


fused_eca_block_sm.launches = 0
