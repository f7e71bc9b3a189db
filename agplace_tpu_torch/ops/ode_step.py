"""K1 — fused fixed-step Euler chain of the FCODE block.

Port of ``agplace_tpu/ops/pallas/ode_step.py:fused_euler_ode``.  Three
instances, chosen by shape (``ode_instance``): up to D = 512
``csrc/ode_step.cu``, one launch of thread-block clusters, W resident
across the shared memory of each cluster's blocks; up to GRID_MAX_DIM
``csrc/ode_grid.cu``, a co-resident grid of one block per SM holding W
across the whole card's shared memory, groups of 4 blocks splitting each
column band's k range, a grid barrier per step; above,
``csrc/ode_wide.cu``'s wide instance, D a runtime width walked by blocks
of 1024 threads, W read from L2 every step.  ``ode_tiling`` is the launch
geometry, its one source.  Like JAX's kernel it takes any D (1 to
``MAX_DIM``, where the wide instance's one row of state no longer fits a
block's shared memory; JAX's VMEM holds W whole only far below that): the
wrapper pads x, W and b with zeros to the instance's width, a multiple of
``DIM_STEP``.  ``euler_ode_plain``
is the plain PyTorch version (the Python Euler loop of
``fusion.py:71-78``).

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
import torch.nn.functional as F

from agplace_tpu_torch.ops import _build

ACTS = {"relu": 0, "tanh": 1, "sigmoid": 2, "id": 3}
_ACT_FNS = {"relu": torch.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid,
            "id": lambda v: v}
# The kernel's tiles (csrc/ode_step.cu): a cluster of CLUSTER blocks owns
# ROWS rows of x, block r of it W's columns [D / CLUSTER * r, D / CLUSTER
# * (r + 1)) of the instance's width D, a multiple of DIM_STEP (D = 256,
# the FCODE width of every preset, is its own); W stays in the cluster's
# shared memory up to MAX_RESIDENT_DIM.  Up to GRID_MAX_DIM the grid
# instance (csrc/ode_grid.cu): GRID_BLOCKS blocks in groups of
# GRID_GROUP, group g W's column band [band g, band (g + 1)), band = D /
# (GRID_BLOCKS / GRID_GROUP), its block q the band's k-slice [kslice q,
# kslice (q + 1)), kslice = D / GRID_GROUP; all B rows in row tiles of 4 x
# GRID_ROW_GROUPS at most.  GRID_MAX_DIM is the widest D whose W tile and
# x slice of 32 rows fit GRID_SMEM bytes (``grid_smem``).  Above, the
# wide instance (csrc/ode_wide.cu) keeps 4, 2 or 1 rows per cluster, as
# many as its two states [2][rows][D] fit in WIDE_SMEM bytes beside b's
# slice (``wide_rows``), up to MAX_DIM.
DIM, CLUSTER, ROWS = 256, 8, 4
DIM_STEP, MAX_RESIDENT_DIM = 128, 512
GRID_BLOCKS, GRID_GROUP, GRID_ROW_GROUPS = 128, 4, 8
GRID_THREADS, GRID_SMEM, GRID_MAX_DIM = 256, 227 * 1024, 2176
WIDE_SMEM, MAX_DIM = 226 * 1024, 27136
RESIDENT, GRID, WIDE = "resident", "grid", "wide"


@dataclass(frozen=True)
class OdeTiling:
    """Launch geometry of K1 over x [B, D] padded to [B, ``dim``], as the
    kernel takes it (``args``): the instance's width and whether W is
    resident, then row tile ``i`` (rows [rows i, rows i + rows), the last
    one ragged) as the cluster of blocks [CLUSTER i, CLUSTER i +
    CLUSTER)."""

    dim: int
    resident: bool
    rows: int
    cluster: int
    tiles: int
    grid: int

    def args(self):
        return (self.dim, int(self.resident), self.rows, self.cluster,
                self.tiles, self.grid)


@dataclass(frozen=True)
class OdeGridTiling:
    """Launch geometry of K1's grid instance over x [B, D] padded to [B,
    ``dim``] (``args``): block j of group j // GRID_GROUP sums its k-slice
    of W's column band for every row, in row tiles of 4 rg rows, and
    finishes a quarter of the band's columns."""

    dim: int
    band: int  # W's columns of a group
    kslice: int  # W's rows of a block
    grid: int
    rg: int

    @property
    def rows(self) -> int:
        """Rows of a row tile."""
        return 4 * self.rg

    def args(self):
        return (self.dim, self.band, self.kslice, self.grid, self.rg)

    def scratch_floats(self, batch: int) -> int:
        """The kernel's scratch: the other state [B, dim], two buffers of
        every block's partial tile, then 1 + GRID_BLOCKS / GRID_GROUP
        barrier counters."""
        return (batch * self.dim + 2 * self.grid * self.rows * self.band
                + 1 + self.grid // GRID_GROUP)


def grid_smem(dim: int, rg: int = GRID_ROW_GROUPS) -> int:
    """The grid instance's shared memory a block at width ``dim``: W's
    tile, b's finishing columns (padded to 4), the x slice of 4 rg rows
    (each padded by 4 floats; its space then holds the k split's
    shares)."""
    band = dim // (GRID_BLOCKS // GRID_GROUP)
    kslice = dim // GRID_GROUP
    tiles = band // 4 * rg
    shares = GRID_THREADS // tiles * tiles * 16
    return 4 * (kslice * band + -(-band // GRID_GROUP // 4) * 4
                + max(4 * rg * (kslice + 4), shares))


def ode_instance(batch: int, dim: int) -> str:
    """K1's instance for x [batch, dim]: RESIDENT (W in the cluster's
    shared memory) up to MAX_RESIDENT_DIM, GRID (W across the shared
    memory of a co-resident grid) up to GRID_MAX_DIM, WIDE (W read from L2
    every step) up to MAX_DIM; an empty x and D past MAX_DIM raise."""
    if batch < 1 or dim < 1:
        raise ValueError(f"fused_euler_ode: x [{batch}, {dim}] is empty")
    if dim > MAX_DIM:
        raise ValueError(f"fused_euler_ode: x [{batch}, {dim}] wider than "
                         f"the wide instance's shared memory holds "
                         f"(D <= {MAX_DIM})")
    return (RESIDENT if dim <= MAX_RESIDENT_DIM else
            GRID if dim <= GRID_MAX_DIM else WIDE)


def ode_width(dim: int) -> int:
    """The instance's width: D padded to a multiple of DIM_STEP."""
    return -(-dim // DIM_STEP) * DIM_STEP


def wide_rows(dim: int) -> int:
    """Rows per cluster of the wide instance at padded width ``dim``: 4, 2
    or 1, the most whose two states and b's slice fit WIDE_SMEM."""
    return next(r for r in (4, 2, 1)
                if (dim // CLUSTER + 2 * r * dim) * 4 <= WIDE_SMEM)


def ode_tiling(batch: int, dim: int):
    """The instance's launch geometry: an ``OdeGridTiling`` for GRID, else
    an ``OdeTiling``."""
    inst = ode_instance(batch, dim)
    width = ode_width(dim)
    if inst == GRID:
        return OdeGridTiling(width, width // (GRID_BLOCKS // GRID_GROUP),
                             width // GRID_GROUP, GRID_BLOCKS,
                             min(GRID_ROW_GROUPS, -(-batch // 4)))
    rows = wide_rows(width) if inst == WIDE else ROWS
    tiles = -(-batch // rows)
    return OdeTiling(width, inst == RESIDENT, rows, CLUSTER, tiles,
                     tiles * CLUSTER)


def ode_block(t, block: int, batch: int):
    """The rows and W columns block ``block`` computes and writes, as the
    kernel derives them from ``t`` (every instance): (rows range, columns
    range) of the padded [B, t.dim] state."""
    if isinstance(t, OdeGridTiling):  # the columns it finishes
        fc = t.band // GRID_GROUP
        c0 = block // GRID_GROUP * t.band + block % GRID_GROUP * fc
        return range(batch), range(c0, c0 + fc)
    r0 = (block // t.cluster) * t.rows
    cols = t.dim // t.cluster
    c0 = (block % t.cluster) * cols
    return range(r0, min(r0 + t.rows, batch)), range(c0, c0 + cols)


def check_grid_resident(t: OdeGridTiling) -> None:
    """Raise unless the card holds every block of the grid instance at
    once (its steps wait on grid-wide barriers: a block that never ran
    would hold the others)."""
    got = _build.lib().agp_ode_grid_resident(t.band, t.kslice, t.rg)
    if got < t.grid:
        raise RuntimeError(
            f"fused_euler_ode: the card holds {got} blocks of the grid "
            f"instance at once (negative: a CUDA error), {t.grid} needed "
            f"({torch.cuda.get_device_name()})")


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
    pad = t.dim - dim
    if pad:  # zero columns of x and b, zero rows and columns of W
        x, b = F.pad(x, (0, pad)), F.pad(b, (0, pad))
        w = F.pad(w, (0, pad, 0, pad))
    x, w, b = map(_build.aligned, (x, w, b))
    out = torch.empty_like(x)
    inst = ode_instance(batch, dim)
    if inst == GRID:
        check_grid_resident(t)
        scratch = torch.empty(t.scratch_floats(batch), dtype=torch.float32,
                              device=x.device)
        _build.call("agp_ode_grid", x, w, b, out, scratch, batch,
                    int(n_steps), float(dt), ACTS[act], *t.args())
    else:
        _build.call("agp_ode_wide" if inst == WIDE else "agp_ode_euler", x,
                    w, b, out, batch, int(n_steps), float(dt), ACTS[act],
                    *t.args())
    fused_euler_ode.launches += 1
    fused_euler_ode.instances[inst] += 1
    return out[:, :dim] if pad else out


fused_euler_ode.launches = 0
fused_euler_ode.instances = dict.fromkeys((RESIDENT, GRID, WIDE), 0)
