"""GeM pooling (``agplace_tpu/models/pooling.py:19-32``)."""

from __future__ import annotations

import torch
from torch import nn


class GeM(nn.Module):
    """``mean(clamp(x, eps) ** p) ** (1/p)`` over H, W of an NHWC map.
    The clamp runs in the map's dtype and the power in fp32 (jnp promotes
    a bf16 map against the fp32 ``p``)."""

    def __init__(self, p_init: float = 3.0, eps: float = 1e-6):
        super().__init__()
        self.p = nn.Parameter(torch.full((1,), p_init))
        self.eps = eps

    def forward(self, x):  # [B, H, W, C] -> [B, C]
        dt = torch.promote_types(x.dtype, self.p.dtype)
        x = torch.clamp(x, min=self.eps).to(dt) ** self.p.to(dt)
        return x.mean(dim=(1, 2)) ** (1.0 / self.p.to(dt))
