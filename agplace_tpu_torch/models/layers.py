"""Small layers with flax ``linen`` semantics on NHWC tensors.

The public layout of the port is the JAX package's NHWC.  A NHWC tensor
permuted to NCHW *is* a ``channels_last`` tensor, so the convolutions here
hand cuDNN its preferred layout without a copy and permute the result back.

Dtype rules follow flax: ``Conv(dtype=d)`` casts input, kernel and bias to
``d`` and returns ``d`` (the conv rounds once, the bias add once);
``Dense`` promotes input and parameters to their common type.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from agplace_tpu_torch.ops import residual_layer_norm


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding=0, dtype: Optional[torch.dtype] = None,
                groups: int = 1) -> torch.Tensor:
    """NHWC conv with an OIHW weight, computed in ``dtype`` (default: the
    input's).  bf16 on the CPU runs as an fp32 conv of the bf16-rounded
    operands, rounded once to bf16 — the XLA CPU semantics the reference
    tests run under."""
    dt = dtype or x.dtype
    xc = x.to(dt).permute(0, 3, 1, 2)
    w = weight.to(dt)
    if dt == torch.bfloat16 and x.device.type == "cpu":
        y = F.conv2d(xc.float(), w.float(), None, stride, padding, 1,
                     groups).to(dt)
    else:
        y = F.conv2d(xc, w, None, stride, padding, 1, groups)
    y = y.permute(0, 2, 3, 1)
    if bias is not None:
        y = y + bias.to(dt)
    return y


class Conv2d(nn.Module):
    """flax ``nn.Conv`` (NHWC in and out); ``weight`` is OIHW.  ``dtype``
    None is flax's ``dtype=None``: the input's and the kernel's common
    type.  ``groups`` is flax's ``feature_group_count``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = torch.float32,
                 groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.groups = groups

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return conv2d_nhwc(x, self.weight, self.bias, self.stride,
                           self.padding, dt, self.groups)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` is [out, in]; ``dtype`` None promotes
    input and parameters to their common dtype, else all three are cast to
    ``dtype`` and the output is in it (a bf16 product accumulates in fp32
    and rounds once)."""

    def __init__(self, cin: int, cout: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis.  Called on x alone it is
    ``F.layer_norm``.  CCT's bf16 inference asks for more at its seams
    between layers (``models/cct.py``): the norm of the stream x +
    ``residual`` through ``ops/residual_layer_norm.
    fused_residual_layer_norm`` (one kernel on the card, the eager chain on
    the CPU), which returns (t = x + residual when ``stream`` is "sum",
    LN(t) when "normed", None when None; bf16(LN(t)) when ``operand``,
    else None)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x, residual=None, stream: Optional[str] = "normed",
                operand: bool = False):
        if residual is None and stream == "normed" and not operand:
            return F.layer_norm(x, x.shape[-1:], self.weight.to(x.dtype),
                                self.bias.to(x.dtype), self.eps)
        return residual_layer_norm.fused_residual_layer_norm(
            x, self.weight, self.bias, self.eps, residual, stream, operand)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def max_pool_nhwc(x: torch.Tensor, k: int, stride: int, padding: int = 0,
                  ceil_mode: bool = False) -> torch.Tensor:
    """flax ``nn.max_pool`` on NHWC (padding with -inf; ``ceil_mode`` as
    torch's, the squeezenet trunks' partial last windows)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), k, stride, padding,
                     ceil_mode=ceil_mode)
    return y.permute(0, 2, 3, 1)


def l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``mm.py:_l2`` — L2-normalise the last axis."""
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)
