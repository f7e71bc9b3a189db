"""The seam between two layers of CCT's bf16 encoder in one pass: the
residual add of the bf16 branch into the fp32 stream, the LayerNorm of the
sum, and the rounding of that norm to the next Dense's bf16 operand.

No TPU kernel stands behind it: XLA fuses the chain on the TPU.  Eager
PyTorch runs it as three passes over the stream (``tokens + y``,
``F.layer_norm``, then ``x.to(bf16)`` in ``Dense.forward``).  The CUDA
kernel (``csrc/residual_layer_norm.cu``) reads x (and the branch) once and
writes one or two of these, from t = x + float(residual) (t = x without
one):

* ``stream`` "sum": t, fp32; "normed": LN(t), fp32; None: no fp32 output;
* ``operand``: bf16(LN(t)), the next Dense's operand.

CCT asks for t and the operand at ``pre_norm_{i+1}`` (the stream goes on
unnormed), LN(t) and the operand at ``norm1_i`` (the normed value is the
new stream), LN(t) alone at ``ln_f`` and the operand of LN(x) alone at
``pre_norm_0``.  The add is the eager add bit for bit, and the stream
stays fp32; the norm is fp32 with a two-pass mean and variance, so only
the order of the row reduction differs from PyTorch's kernel: LN(t)
agrees to within rounding, and the operand is equal but where the two
fp32 norms round to neighbouring bf16 values.  ``residual_layer_norm_plain``
*is* the eager chain, what the CPU runs.

``fused_residual_layer_norm.launches`` counts the kernel's launches.
``ln_grid`` is the launch geometry, its one source.  ``chain_gap`` is the
check that holds the kernel to the eager chain (``LN_ATOL``,
``OPERAND_EQUAL``), for the card's tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from agplace_tpu_torch.ops import _build

# the kernel's name on the card (a function template of the .cu file): the
# GeoLoc benchmark vouches for a profile by its kernels matching
# "layer_norm_kernel", one a LayerNorm call
KERNEL_NAME = "residual_layer_norm_kernel"
# threads per block (the kernel's compiled value: a warp a row), columns a
# lane's 16-byte load spans across the warp, and the widest row it takes
BLOCK, CHUNK, MAX_C = 256, 128, 512
WARPS = BLOCK // 32
STREAMS = ("sum", "normed", None)
# the kernel against the eager chain: t exact; LN(t) within LN_ATOL; the
# bf16 operand equal on at least OPERAND_EQUAL of the elements, and
# elsewhere one bf16 ulp off, or within LN_ATOL where the norm is near zero
# (there LN(t)'s rounding gap, up to LN_ATOL, spans many of bf16's ulps:
# 79 at a norm of ~2e-6 on an H100)
LN_ATOL, OPERAND_EQUAL = 1e-5, 0.999


def ln_grid(rows: int) -> int:
    """The kernel's blocks over ``rows`` rows: warp w of block b takes row
    b x WARPS + w, the last block's warps past the rows none."""
    return -(-rows // WARPS)


def fits(x: torch.Tensor, residual: Optional[torch.Tensor],
         weight: torch.Tensor, bias: torch.Tensor) -> bool:
    """Whether the kernel takes these operands as they are: x fp32 and the
    residual bf16, both dense, gamma and beta fp32, all 16-byte aligned, C
    a multiple of ``CHUNK`` up to ``MAX_C``."""
    c = x.shape[-1]
    dtypes = ((x, torch.float32), (residual, torch.bfloat16),
              (weight, torch.float32), (bias, torch.float32))
    return (c % CHUNK == 0 and 0 < c <= MAX_C
            and all(t.dtype == dt and t.is_contiguous()
                    and t.data_ptr() % 16 == 0
                    for t, dt in dtypes if t is not None))


def residual_layer_norm_plain(x, weight, bias, eps: float, residual=None,
                              stream: Optional[str] = "normed",
                              operand: bool = False):
    """The eager chain: t = x + residual (the eager add), ``F.layer_norm``
    of t (``LayerNorm.forward``), the norm's ``.to(bf16)``; (t, LN(t) or None by ``stream``; the
    bf16 norm or None)."""
    t = x if residual is None else x + residual
    n = F.layer_norm(t, t.shape[-1:], weight.to(t.dtype), bias.to(t.dtype),
                     eps)
    return ({"sum": t, "normed": n, None: None}[stream],
            n.to(torch.bfloat16) if operand else None)


def fused_residual_layer_norm(x, weight, bias, eps: float, residual=None,
                              stream: Optional[str] = "normed",
                              operand: bool = False
                              ) -> Tuple[Optional[torch.Tensor],
                                         Optional[torch.Tensor]]:
    """LayerNorm (``weight``, ``bias`` [C], ``eps``) of t = x + residual
    (x alone without one) over the last axis; returns (t when ``stream``
    is "sum", LN(t) when "normed", None when None; bf16(LN(t)) when
    ``operand``, else None).  On the card x must be fp32 and the residual
    bf16 of x's shape, and both must ``fit``: anything else raises.  On
    the CPU the plain version runs."""
    c = x.shape[-1]
    _build.check(stream in STREAMS, f"fused_residual_layer_norm: stream "
                                    f"{stream!r} is none of {STREAMS}")
    _build.check(stream is not None or operand,
                 "fused_residual_layer_norm: neither stream nor operand "
                 "asked for")
    _build.check(stream != "sum" or residual is not None,
                 "fused_residual_layer_norm: the sum asked for without a "
                 "residual")
    _build.check(tuple(weight.shape) == (c,) and tuple(bias.shape) == (c,),
                 f"fused_residual_layer_norm: weight and bias must be [{c}]")
    _build.check(residual is None or residual.shape == x.shape,
                 "fused_residual_layer_norm: the residual must be of x's "
                 "shape")
    ops = [t for t in (x, residual) if t is not None]
    if not _build.on_cuda(*ops, weight, bias):
        return residual_layer_norm_plain(x, weight, bias, eps, residual,
                                         stream, operand)
    _build.check(fits(x, residual, weight, bias),
                 f"fused_residual_layer_norm: x {tuple(x.shape)} {x.dtype} "
                 f"must be fp32 and the residual bf16, dense, 16-byte "
                 f"aligned, C % {CHUNK} == 0 and C <= {MAX_C}")
    out = torch.empty_like(x) if stream is not None else None
    op = (torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
          if operand else None)
    rows = x.numel() // c
    if rows:  # no rows: done
        _build.call("agp_residual_layer_norm", x, residual, weight, bias,
                    out, op, rows, c, float(eps), int(stream == "sum"),
                    ln_grid(rows), BLOCK)
        fused_residual_layer_norm.launches += 1
    return out, op


fused_residual_layer_norm.launches = 0


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 ulps of two bf16 tensors, element by element (the
    bit patterns mapped onto a line on which adjacent values are 1 apart,
    -0 and +0 at one point)."""
    def line(t):
        s = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(s < 0, -(s & 0x7FFF), s)
    return (line(a) - line(b)).abs()


def chain_gap(got, want) -> dict:
    """The kernel's outputs ``got`` against the eager chain's ``want``,
    both ``fused_residual_layer_norm``'s pairs: the largest absolute gap
    of the fp32 output; of the operand, the share of equal elements, the
    widest gap in ulps and the elements more than one ulp and more than
    LN_ATOL off (None where not asked for)."""
    rec = {"stream_max_abs": None, "operand_equal": None,
           "operand_max_ulps": None, "operand_far": None}
    if got[0] is not None and got[0].numel():
        rec["stream_max_abs"] = float((got[0] - want[0]).abs().max())
    if got[1] is not None and got[1].numel():
        d = ulps_apart(got[1], want[1])
        gap = (got[1].float() - want[1].float()).abs()
        rec["operand_equal"] = float((d == 0).float().mean())
        rec["operand_max_ulps"] = int(d.max())
        rec["operand_far"] = int(((d > 1) & (gap > LN_ATOL)).sum())
    return rec


def close_to_chain(rec: dict, stream: Optional[str], operand: bool) -> bool:
    """Whether ``chain_gap``'s record meets the check: LN(t) within
    LN_ATOL, the operand equal on OPERAND_EQUAL of the elements and none
    far (t's exactness is the caller's to test)."""
    return ((stream != "normed" or rec["stream_max_abs"] is None
             or rec["stream_max_abs"] <= LN_ATOL)
            and (not operand or rec["operand_equal"] is None
                 or (rec["operand_equal"] >= OPERAND_EQUAL
                     and rec["operand_far"] == 0)))
