"""FLOP counts (``agplace_tpu/utils/flops.py``).

JAX reads XLA's cost analysis of the compiled function; the port runs the
function once under ``torch.utils.flop_counter.FlopCounterMode``, which
counts the FLOPs of the matrix products, convolutions and attention it
dispatches (2 per multiply-add; elementwise work is not counted).  The
counter gives no bytes accessed and no transcendentals: those keys are
-1.0, JAX's own value for a key its backend does not report.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """{flops, bytes_accessed, transcendentals} of one call of
    ``fn(*args, **kwargs)`` (run once, without gradients)."""
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": -1.0, "transcendentals": -1.0}


def get_flops(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn``."""
    return cost_analysis(fn, *args, **kwargs)["flops"]
