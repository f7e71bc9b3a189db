"""K5 — the ResNet stem tail: BN eval affine, relu, maxpool 3x3/2 pad 1.

Port of ``agplace_tpu/ops/pallas/stem_pool.py:fused_affine_relu_maxpool``.
The CUDA kernel (``csrc/stem_pool.cu``) reads the conv1 output once and
writes only the pooled quarter-size map.  ``stem_pool_plain`` is the plain
version with the kernel's rounding (``stem_pool.py:62-73``): scale and bias
rounded to bf16, ``relu(x * s + b)`` in fp32 with one bf16 round, then the
3x3/2 window max.  That is not the unfused module path, which applies the
affine in bf16 (a multiply and an add, each rounded; ``norm.py:76-78``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from agplace_tpu_torch.ops import _build

_BF16 = torch.bfloat16


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
    H and W must be even (every ResNet stem shape is): odd sizes raise, on
    either device."""
    b, h, w, c = x.shape
    _build.check(h % 2 == 0 and w % 2 == 0,
                 f"fused_affine_relu_maxpool: H, W = {h}, {w} must be even")
    x = x.to(_BF16)
    if not _build.on_cuda(x, scale, bias):
        return stem_pool_plain(x, scale, bias)
    _build.check(c % 8 == 0,
                 f"fused_affine_relu_maxpool: C = {c} not a multiple of 8")
    out = torch.empty((b, h // 2, w // 2, c), dtype=_BF16, device=x.device)
    _build.call("agp_stem_pool", x.contiguous(), scale.float().contiguous(),
                bias.float().contiguous(), out, b, h, w, c)
    fused_affine_relu_maxpool.launches += 1
    return out


fused_affine_relu_maxpool.launches = 0
