"""Eval-mode BatchNorm (``agplace_tpu/models/norm.py``).

The effective affine is computed in fp32 from the running statistics and
applied in the activation dtype, one multiply and one add, exactly as the
JAX ``BatchNorm2D`` does in eval (``norm.py:71-78``):

    y = x * scale' + bias',  scale' = rsqrt(var + eps) * scale,
                             bias'  = bias - mean * scale'

The BEV voxel branch uses the same module; its callers tile the affine over
the folded z axis.  Training-mode (masked) statistics are a later port.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class BatchNorm2D(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps

    def affine(self, z: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 (scale', bias'), tiled ``z`` times for the folded layout."""
        inv = torch.rsqrt(self.running_var.float() + self.eps)
        w = self.weight.float()
        s = inv * w
        b = self.bias.float() - self.running_mean.float() * inv * w
        return s.repeat(z), b.repeat(z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x [..., C]
        s, b = self.affine()
        return x * s.to(x.dtype) + b.to(x.dtype)
