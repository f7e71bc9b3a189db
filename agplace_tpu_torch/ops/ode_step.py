"""K1 — fused fixed-step Euler chain of the FCODE block.

Port of ``agplace_tpu/ops/pallas/ode_step.py:fused_euler_ode`` (forward
only).  The CUDA kernel is ``csrc/ode_step.cu``; ``euler_ode_plain`` is the
plain PyTorch version (the Python Euler loop of ``fusion.py:71-78``).  The
backward kernel (the Pallas ``_bwd``) is a later port: a CUDA input that
needs a gradient raises.
"""

from __future__ import annotations

import torch

from agplace_tpu_torch.ops import _build

ACTS = {"relu": 0, "tanh": 1, "sigmoid": 2, "id": 3}
_ACT_FNS = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
            "id": lambda v: v}


def euler_ode_plain(x, w, b, n_steps: int = 10, dt: float = 0.1,
                    act: str = "relu"):
    """x [B, D] fp32, w [D, D] ([in, out]), b [D]: n_steps of
    ``x + dt * act(x @ w + b)``."""
    fn = _ACT_FNS[act]
    for _ in range(n_steps):
        x = x + dt * fn(x @ w + b)
    return x


def fused_euler_ode(x, w, b, n_steps: int = 10, dt: float = 0.1,
                    act: str = "relu"):
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    if not _build.on_cuda(x, w, b):
        return euler_ode_plain(x, w, b, n_steps, dt, act)
    batch, dim = x.shape
    _build.check(x.dtype == w.dtype == b.dtype == torch.float32,
                 "fused_euler_ode: fp32 x, w, b required")
    _build.check(w.shape == (dim, dim) and b.shape == (dim,),
                 f"fused_euler_ode: bad shapes {x.shape} {w.shape} {b.shape}")
    x, w, b = x.contiguous(), w.contiguous(), b.contiguous()
    out = torch.empty_like(x)
    _build.call("agp_ode_euler", x, w, b, out, batch, dim, int(n_steps),
                float(dt), ACTS[act])
    fused_euler_ode.launches += 1
    return out


fused_euler_ode.launches = 0
