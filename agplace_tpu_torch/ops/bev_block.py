"""K6 — the batch-major eval ECA block, identity residual only.

Port of ``agplace_tpu/ops/pallas/bev_block.py:fused_eca_block``.  No model
module calls it, in either package (``BEVECABasicBlock`` takes K3,
``ops/bev_block_sm.py``); it is an op like its JAX twin, used by the tests
and by ``chip_smoke.py``'s parity phase.

Its rounding differs from K3's (``bev_block.py:78-124``): both conv
affines run in fp32 on the fp32 accumulator; conv1 is rounded to bf16 after
relu and mask; conv2 is rounded to bf16 after its affine and read back as
fp32; the masked pool, the ECA conv and the sigmoid stay fp32, and the
attention is never rounded; ``relu(g * att + x) * mask`` runs in fp32 with
one final round.  ``eca_block_bm_plain`` is the plain version with exactly
those rounding points, written with its conv phases' plain version
``bm_conv_phase_plain``.  On the card the block runs as four phases: the
two 3x3 convs with those fp32 epilogues, then the ECA attention
(``csrc/eca.cuh``) and the residual combine (``csrc/bev_block.cu``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from agplace_tpu_torch.ops import _build
from agplace_tpu_torch.ops import bev_block_sm as bsm
from agplace_tpu_torch.sparse import bev_grid as bg

_BF16 = torch.bfloat16
_F32 = torch.float32


def _conv3x3_f32(x, w):
    """bf16 operands, fp32 accumulation, unrounded fp32 result."""
    return bg.bev_conv2d(x.to(_BF16).float(), w.to(_BF16).float(), 1,
                         (1, 1), (1, 1), _F32)


def bm_conv_phase_plain(x, mask, w, scale, bias, z: int, pool: bool):
    """One of K6's conv phases in plain PyTorch, with K6's rounding points:
    the affine in fp32 on the unrounded conv.  Phase 1 (``pool`` False)
    returns h = bf16(relu(conv(x)*s + b) * mask); phase 2 returns (g =
    bf16(conv(x)*s + b), the fp32 masked sum of g [B, Zcout])."""
    c = int(w.shape[3]) // z
    mzc = mask.repeat_interleave(c, dim=-1).float()
    v = _conv3x3_f32(x, w) * scale.float() + bias.float()
    if not pool:
        return (torch.relu(v) * mzc).to(_BF16)
    g = v.to(_BF16)
    return g, (g.float() * mzc).sum(dim=(1, 2))


def eca_block_bm_plain(x, mask, w1, w2, scale1, bias1, scale2, bias2, w_eca,
                       z: int):
    b, _, _, zc = x.shape
    c = zc // z
    mzc = mask.repeat_interleave(c, dim=-1).float()
    h = bm_conv_phase_plain(x, mask, w1, scale1, bias1, z, pool=False)
    g, sums = bm_conv_phase_plain(h, mask, w2, scale2, bias2, z, pool=True)
    g = g.float()
    cnt = torch.clamp(mask.float().sum(dim=(1, 2, 3)), min=1.0)
    pooled = sums.reshape(b, z, c).sum(dim=1) / cnt[:, None]
    k = int(w_eca.shape[0])
    att = F.conv1d(pooled[:, None], w_eca.float().reshape(1, 1, k),
                   padding=(k - 1) // 2)[:, 0]
    att = torch.sigmoid(att).repeat(1, z)  # z-tiled, fp32
    out = torch.relu(g * att[:, None, None, :] + x.to(_BF16).float()) * mzc
    return out.to(_BF16)


def fused_eca_block(x, mask, w1, w2, scale1, bias1, scale2, bias2, w_eca,
                    z: int):
    """x [B,X,Y,Z*C] (masked; cast to bf16), mask [B,X,Y,Z] bool, w1/w2
    folded [3,3,Z*C,Z*C], scale/bias [Z*C] fp32 (BN eval affines), w_eca
    [k].  Identity residual only: other widths raise.  Returns
    [B,X,Y,Z*C] bf16.

    On the card the kernels take Z*C in multiples of 32 and C in multiples
    of 8.  The two conv phases run as instances of K3's TMA + wgmma kernel
    (``csrc/conv3x3_sm90.cu``, EPI 2 and 3: its 64-channel K slabs and
    128-channel N tile) where Z*C is a multiple of 128, and as the wmma
    implicit GEMM of ``csrc/conv_igemm.cuh`` (32-channel K slices, 64-wide
    N tiles) at the other widths (Z*C = 32, 64, 96, 160, ...); both
    hand-written, with the same fp32 epilogues, chosen by shape alone."""
    zc = int(x.shape[3])
    _build.check(tuple(w1.shape) == (3, 3, zc, zc)
                 and tuple(w2.shape) == (3, 3, zc, zc),
                 f"fused_eca_block: identity residual only, x width {zc}, "
                 f"w1 {tuple(w1.shape)} w2 {tuple(w2.shape)}")
    ins = (x, mask, w1, w2, scale1, bias1, scale2, bias2, w_eca)
    if not _build.on_cuda(*ins):
        return eca_block_bm_plain(*ins, z=z)
    b, xd, yd, _ = x.shape
    c = zc // z
    _build.check(zc % 32 == 0 and c % 8 == 0,
                 f"fused_eca_block: width {zc} at z={z} not a multiple of "
                 f"the kernel's tiles")
    x = _build.aligned(x.to(_BF16))
    m = mask.contiguous()
    dev = x.device
    if zc % bsm.SLAB == 0 and zc % bsm.BLOCK_N == 0:
        h = bsm.conv3x3_launch(x, m, w1, scale1, bias1,
                               bsm.EPI_F32_RELU_MASK, z)
        g, pool = bsm.conv3x3_launch(h, m, w2, scale2, bias2,
                                     bsm.EPI_F32_POOL, z)
    else:
        h = torch.empty_like(x)
        _build.call("agp_block_bm_conv1", x, m, _build.aligned(w1.to(_BF16)),
                    scale1.float().contiguous(), bias1.float().contiguous(),
                    h, b, xd, yd, zc, z)
        g = torch.empty_like(x)
        pool = torch.zeros((b, zc), dtype=_F32, device=dev)
        _build.call("agp_block_bm_conv2_pool", h, m,
                    _build.aligned(w2.to(_BF16)), scale2.float().contiguous(),
                    bias2.float().contiguous(), g, pool, b, xd, yd, zc, z)
    att = torch.empty((b, zc), dtype=_F32, device=dev)
    w_e = w_eca.float().contiguous()
    _build.call("agp_block_bm_eca", pool, m, w_e, int(w_e.shape[0]), att, b,
                xd * yd * z, z, c)
    out = torch.empty_like(x)
    _build.call("agp_block_bm_combine", g, x, att, m, out, b, xd, yd, zc, z)
    fused_eca_block.launches += 1
    return out


fused_eca_block.launches = 0
