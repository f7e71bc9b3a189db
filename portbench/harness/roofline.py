"""The yardstick's arithmetic: published H100 peaks, the roofline bound, and
the work of the hand-written kernels at a cell's shapes.

Frozen from ``chip_smoke.py``'s ``bound`` / ``live_blocks`` /
``conv_flops`` / ``fold_bytes`` / ``block_bound``, restated on shapes so
that nothing here reads the measured program's tensors: a folded voxel
kernel [k, k, Z*cin, Zo*cout] holds one k*k*cin*cout block for each (input
slab, output slab) pair the 3-D kernel reaches, and only those blocks are
work.  Each input byte is counted once and each output byte once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

# NVIDIA's H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_S = 3.35e12
BF16, F32, BOOL = 2, 4, 1


def me_down_align(cells: int):
    lo = (cells // 2) % 2
    hi = (cells + lo) % 2
    return lo, hi, (cells + lo + hi) // 2


def bound_s(flops: float, n_bytes: float, peak: float) -> float:
    """The least seconds: the larger of operations at ``peak`` and bytes at
    the memory rate."""
    return max(flops / peak, n_bytes / HBM_BYTES_S)


def live_blocks_s1(k: int, z: int) -> int:
    """Live (zi, zo) blocks of a stride-1 fold of a k-tap kernel at z."""
    return sum(1 for zo in range(z) for zi in range(z)
               if abs(zi - zo) <= k // 2)


def live_blocks_k2s2(z: int) -> int:
    """Live blocks of the k2s2 down's fold (zi = 2 zo + t - lo)."""
    lo, _, zo_n = me_down_align(z)
    return sum(1 for zo in range(zo_n) for t in range(2)
               if 0 <= 2 * zo + t - lo < z)


@dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    peak: float

    @property
    def bound_s(self) -> float:
        return bound_s(self.flops, self.bytes, self.peak)


def k1_work(batch: int, dim: int, steps: int) -> Work:
    """K1: ``steps`` Euler steps of x @ W + b, relu, fp32: x, W, b read and
    x written once."""
    return Work(2.0 * steps * batch * dim * dim,
                F32 * (2 * batch * dim + dim * dim + dim), PEAK["float32"])


def k2_gemm_work(batch: int, x: int, y: int, z: int, c1: int,
                 c2: int) -> Work:
    """K2's hand kernel, the down0 GEMM with BN0's prologue: conv0's bf16
    map [B, X, Y, Z*C1] and its mask in, BN affines, the live blocks of
    the down fold, the output [B, X/2, Y/2, Zo*C2] and its mask out."""
    zo = me_down_align(z)[2]
    cells_out = batch * (x // 2) * (y // 2)
    blocks = live_blocks_k2s2(z)
    flops = 2.0 * cells_out * blocks * 4 * c1 * c2
    n = (BF16 * batch * x * y * z * c1 + BOOL * batch * x * y * z
         + F32 * 2 * (z * c1 + zo * c2) + BF16 * blocks * 4 * c1 * c2
         + BOOL * cells_out * zo + BF16 * cells_out * zo * c2)
    return Work(flops, n, PEAK["bfloat16"])


def k3_block_work(batch: int, x: int, y: int, z: int, cin: int,
                  cout: int, eca_k: int) -> Work:
    """K3's whole ECA block: both 3x3x3 convs and the 1x1 residual where
    the channels change, against x, the mask, the BN affines, the ECA
    kernel, the folds' live blocks and the output once."""
    cells = batch * x * y
    b3 = live_blocks_s1(3, z)
    folds = [(b3, 9, cin, cout), (b3, 9, cout, cout)]
    affines = 4
    if cin != cout:
        folds.append((z, 1, cin, cout))
        affines = 6
    flops = sum(2.0 * cells * blk * taps * ci * co
                for blk, taps, ci, co in folds)
    n = (BF16 * cells * z * cin + BOOL * cells * z
         + F32 * (affines * z * cout + eca_k)
         + sum(BF16 * blk * taps * ci * co for blk, taps, ci, co in folds)
         + BF16 * cells * z * cout)
    return Work(flops, n, PEAK["bfloat16"])


def eca_kernel_size(channels: int) -> int:
    import math

    t = int(abs((math.log2(channels) + 1.0) / 2.0))
    return t if t % 2 else t + 1


def mm_hand_work(batch: int, extent, planes, fuse_dim: int,
                 ode_steps: int) -> Dict[str, List[Work]]:
    """The hand kernels' work in one eval forward of the default MM (K1 on
    each of the three FCODE scales, K2 at the stage 0, K3 in each FPN
    stage's block and in the stage-2 voxel block), keyed by the K-number
    the profile's kernels are classed under."""
    x, y, z = extent
    c0 = planes[0]
    work = {"K1": [k1_work(batch, fuse_dim, ode_steps)] * 3,
            "K2": [k2_gemm_work(batch, x, y, z, c0, c0)], "K3": []}
    gx, gy, gz, c = x // 2, y // 2, me_down_align(z)[2], c0
    for i, cout in enumerate(planes):
        if i:
            gx, gy, gz = (me_down_align(gx)[2], me_down_align(gy)[2],
                          me_down_align(gz)[2])
        work["K3"].append(k3_block_work(batch, gx, gy, gz, c, cout,
                                        eca_kernel_size(cout)))
        c = cout
    work["K3"].append(k3_block_work(batch, gx, gy, gz, c, c,
                                    eca_kernel_size(c)))
    return work


def least_time_s(flops_by_precision: Dict[str, float]) -> float:
    """Sum over precision groups of their FLOPs at that precision's peak."""
    return sum(f / PEAK[p] for p, f in flops_by_precision.items())


def by_precision(counts, precisions: Dict[str, str]) -> Dict[str, float]:
    """FLOPs by the precision each group computes in, from the reference's
    ``FlopCounterMode`` counts; the groups in fp32 (or TF32 off) at the
    fp32 peak."""
    from portbench.reference.model import flops_by_group

    out: Dict[str, float] = {}
    for group, n in flops_by_group(counts).items():
        key = "bfloat16" if precisions[group] == "bfloat16" else "float32"
        out[key] = out.get(key, 0.0) + n
    return out
