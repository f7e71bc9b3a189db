"""Separable grid resizes with ``jax.image.resize``'s weights.

``jax.image.resize`` builds one weight matrix per resized axis
(``scale_and_translate``): sample i of n from m inputs sits at
``(i + 0.5) * m / n - 0.5``; when it shrinks (``antialias``, JAX's
default) the kernel is widened by m / n; each column is divided by its
sum; a sample outside the input gets no weight.  Its kernels are the
triangle (``bilinear``) and Keys' cubic with a = -0.5 (``bicubic``).
torch's ``F.interpolate`` differs on both counts (no antialias unless
asked, a = -0.75 for its bicubic), so the port's resizes of positional
embeddings go through these matrices.  The weights are computed in fp32,
as JAX computes them for a float32 input.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1)
    out = np.where(x >= 1, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                            - np.float32(4)) * x + np.float32(2), out)
    return np.where(x >= 2, np.float32(0), out).astype(np.float32)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(in_size: int, out_size: int, method: str = "bilinear"
                   ) -> np.ndarray:
    """[in_size, out_size] fp32: output j = sum_i x[i] * W[i, j]
    (antialiased, ``jax.image.resize``'s default)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale \
        - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        / kernel_scale
    w = _KERNELS[method](x.astype(f32)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_hw(x: torch.Tensor, hw: Tuple[int, int],
              method: str = "bilinear") -> torch.Tensor:
    """Resize the two axes before the last of ``x`` [..., H, W, D] to
    ``hw`` (an axis already at its size is left alone, as JAX skips it);
    fp32 products."""
    h, w = x.shape[-3], x.shape[-2]
    out = x.float()
    if hw[0] != h:
        wh = torch.from_numpy(resize_weights(h, hw[0], method)).to(x.device)
        out = torch.einsum("...hwd,hi->...iwd", out, wh)
    if hw[1] != w:
        ww = torch.from_numpy(resize_weights(w, hw[1], method)).to(x.device)
        out = torch.einsum("...hwd,wj->...hjd", out, ww)
    return out.to(x.dtype)
