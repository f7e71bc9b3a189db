"""K1 — fused fixed-step Euler chain of the FCODE block.

Port of ``agplace_tpu/ops/pallas/ode_step.py:fused_euler_ode``.  The CUDA
kernel is ``csrc/ode_step.cu``: one launch of thread-block clusters, W
resident across the shared memory of each cluster's blocks; ``ode_tiling``
is its launch geometry, its one source.  ``euler_ode_plain`` is the plain
PyTorch version (the Python Euler loop of ``fusion.py:71-78``).

Gradients go through ``euler_ode`` (``EulerODE``, the custom VJP of JAX's
``ode_step.py:80-117``), and only through it: its forward is the kernel
wrapper (on the CPU the plain version), and its backward, ``euler_ode_bwd``,
recomputes the trajectory and runs the reverse loop in plain torch ops, as
JAX computes its ``_bwd`` in XLA outside any Pallas kernel.  A direct
wrapper call on CUDA inputs that need a gradient raises
(``_build.on_cuda``); ``fused_euler_ode.launches`` counts forward launches.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from agplace_tpu_torch.ops import _build

ACTS = {"relu": 0, "tanh": 1, "sigmoid": 2, "id": 3}
_ACT_FNS = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
            "id": lambda v: v}
# The kernel's tiles (csrc/ode_step.cu): D = 256 (the FCODE width of every
# preset); a cluster of CLUSTER blocks owns ROWS rows of x, block r of it
# W's columns [DIM / CLUSTER * r, DIM / CLUSTER * (r + 1)).
DIM, CLUSTER, ROWS = 256, 8, 4


@dataclass(frozen=True)
class OdeTiling:
    """Launch geometry of K1 over x [B, DIM], as the kernel takes it
    (``args``): row tile ``i`` (rows [ROWS i, ROWS i + ROWS), the last one
    ragged) is the cluster of blocks [CLUSTER i, CLUSTER i + CLUSTER)."""

    rows: int
    cluster: int
    tiles: int
    grid: int

    def args(self):
        return (self.rows, self.cluster, self.tiles, self.grid)


def ode_tiling(batch: int, dim: int) -> OdeTiling:
    _build.check(dim == DIM and batch >= 1,
                 f"fused_euler_ode: x [{batch}, {dim}] outside the kernel's "
                 f"tiles (D = {DIM}, B >= 1)")
    tiles = -(-batch // ROWS)
    return OdeTiling(ROWS, CLUSTER, tiles, tiles * CLUSTER)


def ode_block(t: OdeTiling, block: int, batch: int):
    """The rows and W columns block ``block`` computes and writes, as the
    kernel derives them from ``t``: (rows range, columns range)."""
    r0 = (block // t.cluster) * t.rows
    cols = DIM // t.cluster
    c0 = (block % t.cluster) * cols
    return range(r0, min(r0 + t.rows, batch)), range(c0, c0 + cols)


def euler_ode_plain(x, w, b, n_steps: int = 10, dt: float = 0.1,
                    act: str = "relu"):
    """x [B, D] fp32, w [D, D] ([in, out]), b [D]: n_steps of
    ``x + dt * act(x @ w + b)``."""
    fn = _ACT_FNS[act]
    for _ in range(n_steps):
        x = x + dt * fn(x @ w + b)
    return x


def euler_ode_bwd(x, w, b, g, n_steps: int = 10, dt: float = 0.1,
                  act: str = "relu"):
    """(gx, gw, gb) of ``euler_ode_plain(x, w, b)`` against the output
    cotangent ``g``: JAX's ``_bwd``.  The trajectory is recomputed, then a
    reverse loop accumulates the three gradients in fp32."""
    fn = _ACT_FNS[act]
    xs, pres = [], []
    for _ in range(n_steps):
        pre = x @ w + b
        xs.append(x)
        pres.append(pre)
        x = x + dt * fn(pre)
    gx, gw, gb = g.float(), torch.zeros_like(w), torch.zeros_like(b)
    for x_t, pre_t in zip(reversed(xs), reversed(pres)):
        # y_{t+1} = x_t + dt * act(pre_t);  pre_t = x_t W + b
        if act == "relu":
            dact = (pre_t > 0).to(gx.dtype)
        elif act == "tanh":
            dact = 1.0 - torch.tanh(pre_t) ** 2
        elif act == "sigmoid":
            s = torch.sigmoid(pre_t)
            dact = s * (1.0 - s)
        else:
            dact = torch.ones_like(pre_t)
        gpre = gx * dt * dact
        gw = gw + x_t.T @ gpre
        gb = gb + gpre.sum(dim=0)
        gx = gx + gpre @ w.T
    return gx, gw, gb


class EulerODE(torch.autograd.Function):
    """K1 with JAX's custom VJP: the forward launches the kernel (the plain
    version on the CPU) and saves (x, w, b); the backward is
    ``euler_ode_bwd``."""

    @staticmethod
    def forward(ctx, x, w, b, n_steps: int, dt: float, act: str):
        ctx.save_for_backward(x, w, b)
        ctx.config = (n_steps, dt, act)
        return fused_euler_ode(x, w, b, n_steps, dt, act)

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        return (*euler_ode_bwd(x, w, b, g, *ctx.config), None, None, None)


def euler_ode(x, w, b, n_steps: int = 10, dt: float = 0.1,
              act: str = "relu"):
    """``fused_euler_ode`` with a gradient (``EulerODE``)."""
    return EulerODE.apply(x, w, b, n_steps, dt, act)


def fused_euler_ode(x, w, b, n_steps: int = 10, dt: float = 0.1,
                    act: str = "relu"):
    if act not in ACTS:
        raise ValueError(f"unsupported activation {act!r}")
    if not _build.on_cuda(x, w, b):
        return euler_ode_plain(x, w, b, n_steps, dt, act)
    batch, dim = x.shape
    t = ode_tiling(batch, dim)
    _build.check(x.dtype == w.dtype == b.dtype == torch.float32,
                 "fused_euler_ode: fp32 x, w, b required")
    _build.check(w.shape == (dim, dim) and b.shape == (dim,),
                 f"fused_euler_ode: bad shapes {x.shape} {w.shape} {b.shape}")
    x, w, b = map(_build.aligned, (x, w, b))
    out = torch.empty_like(x)
    _build.call("agp_ode_euler", x, w, b, out, batch, dim, int(n_steps),
                float(dt), ACTS[act], *t.args())
    fused_euler_ode.launches += 1
    return out


fused_euler_ode.launches = 0
