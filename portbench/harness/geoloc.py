"""The GeoLoc cell's yardstick: the work of a transformer's attention core,
and device time under the program's span rows.

A span of the program (``agplace_tpu_torch/utils/spans.py``) that is open
while the profiler records leaves a row of its name on the device's
timeline, from the first to the last kernel launched inside it.  Such a row
is no device work: left among the operations, it would count its kernels'
time twice and fill the idle gaps between them.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch.overrides import TorchFunctionMode

from portbench.harness.roofline import BF16, F32, PEAK, Work

Row = Tuple[str, float, float]  # (name, start us, end us)

# the products a tower's forward computes, by the name of the torch
# function it calls: dense layers, convs, einsums and matrix products,
# and PyTorch's fused attention
PRODUCTS = frozenset({
    "linear", "bilinear", "conv1d", "conv2d", "conv3d", "einsum", "matmul",
    "__matmul__", "__rmatmul__", "mm", "bmm", "addmm", "baddbmm",
    "scaled_dot_product_attention"})


def _first_tensor(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a
        if isinstance(a, (list, tuple)):
            t = _first_tensor(a)
            if t is not None:
                return t
    return None


class _ProductDtypes(TorchFunctionMode):
    """Counts the operand dtype of each product called at the torch
    function level, which ``torch.inference_mode`` leaves visible (a
    dispatch mode sees nothing under it); a product's own inner calls
    run with the mode off and are not counted again."""

    def __init__(self):
        super().__init__()
        self.seen: Counter = Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in PRODUCTS:
            a = _first_tensor(args)
            if a is not None:
                self.seen[str(a.dtype).replace("torch.", "")] += 1
        return func(*args, **(kwargs or {}))


def product_dtypes(forward: Callable[[], object]) -> Counter:
    """The operand dtype of each product that ``forward()`` computes,
    counted (its first tensor operand)."""
    with torch.no_grad(), _ProductDtypes() as mode:
        forward()
    return mode.seen


def require_precision(seen: Counter, precision: str) -> None:
    """Raise unless some product of the tower takes ``precision``: a
    program that computes every product in another dtype cannot serve
    the configuration as it states it."""
    if precision != "float32" and not seen.get(precision):
        raise RuntimeError(
            f"the tower computed its {sum(seen.values())} products in "
            f"{dict(seen)}, none in the configuration's {precision}: this "
            f"program does not serve the tower at that precision")


def attention_core_work(batch: int, heads: int, tokens: int, head_dim: int,
                        precision: str = "bfloat16") -> Work:
    """One layer's attention core, softmax(q k^T) v over ``tokens``: 4 B h
    N^2 d FLOPs (QK^T and AV), and q, k, v read and the output written
    once in ``precision``, whatever implements it."""
    size = BF16 if precision == "bfloat16" else F32
    elems = batch * heads * tokens * head_dim
    return Work(4.0 * elems * tokens, 4.0 * size * elems, PEAK[precision])


def split_rows(trace, names: Iterable[str]) -> List[Row]:
    """Take the rows named in ``names`` out of ``trace.device`` (a
    ``profiling.Trace``) and return them."""
    names = frozenset(names)
    rows = [d for d in trace.device if d[0] in names]
    trace.device = [d for d in trace.device if d[0] not in names]
    return rows


def device_s_under(trace, rows: List[Row]) -> Dict[str, float]:
    """Seconds of the device operations that lie inside a row, summed by
    the row's name (an operation inside nested rows counts for each)."""
    out: Dict[str, float] = defaultdict(float)
    for _, s, e in trace.device:
        for name in {n for n, a, b in rows if a <= s and e <= b}:
            out[name] += (e - s) / 1e6
    return dict(out)
