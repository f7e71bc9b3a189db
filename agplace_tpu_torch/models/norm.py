"""BatchNorm with fp32 statistics and the affine in the activation dtype
(``agplace_tpu/models/norm.py``).

The effective affine is computed in fp32 and applied in the activation
dtype, one multiply and one add, exactly as the JAX ``BatchNorm2D`` does
(``norm.py:49-78``):

    y = x * scale' + bias',  scale' = rsqrt(var + eps) * scale,
                             bias'  = bias - mean * scale'

Eval mode reads the running statistics.  Training mode takes the batch's
mean and E[x^2] in fp32 over every axis but the last, the biased variance
``msq - mean^2`` (no clamp), and moves the running statistics to
``0.9 * old + 0.1 * batch``, the biased variance included (torch's
``nn.BatchNorm2d`` stores the unbiased one, so it is not a drop-in).

The BEV voxel branch uses the same module with masked statistics
(``sparse/bev_grid.bn_apply``); its callers tile the affine over the
folded z axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class BatchNorm2D(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.eps = eps
        self.momentum = momentum

    def affine(self, z: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 (scale', bias') of the running statistics, tiled ``z``
        times for the folded layout."""
        return self.batch_affine(self.running_mean.float(),
                                 self.running_var.float(), z)

    def batch_affine(self, mean: torch.Tensor, var: torch.Tensor,
                     z: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
        """fp32 (scale', bias') of the given statistics, tiled ``z``
        times; differentiable in the statistics and the affine."""
        inv = torch.rsqrt(var + self.eps)
        w = self.weight.float()
        s = inv * w
        b = self.bias.float() - mean * inv * w
        return s.repeat(z), b.repeat(z)

    def track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running statistics towards a batch's (in place)."""
        with torch.no_grad():
            for run, new in ((self.running_mean, mean),
                             (self.running_var, var)):
                run.copy_(self.momentum * run
                          + (1 - self.momentum) * new.detach())

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x [..., C]
        if self.training:
            axes = tuple(range(x.ndim - 1))
            x32 = x.float()
            mean = x32.mean(dim=axes)
            var = x32.square().mean(dim=axes) - mean.square()
            self.track(mean, var)
            s, b = self.batch_affine(mean, var)
        else:
            s, b = self.affine()
        return x * s.to(x.dtype) + b.to(x.dtype)
