#!/usr/bin/env python
"""A/B of the BEV stage 0 on one NVIDIA GPU: P2, the concat formulation
(``agplace_tpu_torch/ops/probe_down_v2.py``), against K2, the shipped
kernel (``agplace_tpu_torch/ops/bev_down.py``).  The port of
``scripts/probe_down_v2.py``.

    python3 scripts/probe_torch_down_v2.py

Inputs as the JAX probe makes them: ``kitti360_config()``, batch 32, 30,000
points per cloud uniform in [-100, 100]^3 (numpy seed 0), voxel cap 8192,
the host raster to the 128x128x4 grid; random weights from numpy seed 1
with the probe's shapes and scales, except conv0's 3-D kernel, which has
the model's five z taps, [5, 5, 5, 1, C1] (the JAX probe draws four, and
its fold reads the fifth past the end, which JAX clamps to the fourth).

It first holds v2 against v1 on the same inputs (largest difference, and
the share of the outputs either leaves non-zero on which they differ),
then times both: CUDA events around each call, the L2 flushed before each
(a cold-L2 regime: every call starts from HBM), v1 and v2 in turns, median
of 20 after 3 warm-ups.  Each time includes the wrapper's conv0 (one
full-resolution cuDNN conv for K2, four parity convs for P2), as the JAX
probe timed them.  Prints one JSON line: ``v1_shipped`` and ``v2_concat``
in ms, ``max_abs``, ``frac_differ``, ``card`` (name and power limit) and
``calls`` (how often each wrapper ran).  ``run(device)`` returns the same
record, plus ``device_ms`` on the card: each version's device time per call
by kernel (``torch.profiler``, L2 warm), which splits the wrappers' cuDNN
conv0 from the hand-written kernel.  On the CPU the wrappers take their
plain versions, the times are None (not measured) and ``device_ms`` is
left out.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import card, differ  # noqa: E402

BATCH = 32
N_POINTS = 30000
VOX_CAP = 8192
ITERS = 20
WARMUP = 3
L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def occupancy(cfg, batch: int, n_points: int, device):
    """The probes' clouds (uniform in [-100, 100]^3, numpy seed 0),
    voxelised and rastered on the host to the config's grid: a
    ``BEVGrid`` on ``device``."""
    from agplace_tpu_torch.data.voxels import (batched_from_pointclouds,
                                               rasterize_from_voxels_host)

    rng = np.random.default_rng(0)
    pts = rng.uniform(-100, 100, (batch, n_points, 3)).astype(np.float32)
    sv = batched_from_pointclouds(pts, cfg.data.quant_size, VOX_CAP)
    return rasterize_from_voxels_host(sv, cfg.model.mm.vox_grid_extent,
                                      device=device)


def ab_ms(fns: dict, device, iters: int = ITERS, warmup: int = WARMUP):
    """Median device time in ms of each function in ``fns`` (name -> fn),
    timed in turns: CUDA events around every call, each call after a read
    of L2_FLUSH_BYTES that evicts the L2.  None for each off the card."""
    if device.type != "cuda":
        return {k: None for k in fns}
    flush = torch.zeros(L2_FLUSH_BYTES // 4, device=device)
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    events = {k: [] for k in fns}
    for _ in range(iters):
        for k, fn in fns.items():
            flush.sum()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            events[k].append((s, e))
    torch.cuda.synchronize()
    return {k: statistics.median(s.elapsed_time(e) for s, e in ev)
            for k, ev in events.items()}


def device_ms(fns: dict, device, n: int = 5):
    """Device ms per call of each function in ``fns``, by kernel (the
    classes of ``scripts/profile_torch_mm.py``), from ``torch.profiler``
    over ``n`` back-to-back calls (L2 warm).  None off the card."""
    if device.type != "cuda":
        return None
    from profile_torch_mm import device_times

    return {k: {cls: ms for cls, (ms, _) in device_times(fn, n).items()}
            for k, fn in fns.items()}


def run(device, batch: int = BATCH, n_points: int = N_POINTS,
        iters: int = ITERS) -> dict:
    from agplace_tpu_torch import kitti360_config
    from agplace_tpu_torch.data.voxels import me_down_align
    from agplace_tpu_torch.ops.bev_down import fused_conv0_down0
    from agplace_tpu_torch.ops.probe_down_v2 import fused_down_concat
    from agplace_tpu_torch.sparse.bev_grid import (fold_w2_k2s2,
                                                   fold_w2_stride1)

    device = torch.device(device)
    cfg = kitti360_config()
    vox = occupancy(cfg, batch, n_points, device)
    feats, mask, z0 = vox.feats.to(torch.bfloat16), vox.mask, vox.z
    c1 = cfg.model.mm.voxfe_planes[0]
    zo = me_down_align(z0)[2]

    rngp = np.random.default_rng(1)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    k0 = t(rngp.standard_normal((5, 5, 5, 1, c1)) * 0.1)
    kd = t(rngp.standard_normal((2, 2, z0, c1, c1)) * 0.1)
    w0, wd = fold_w2_stride1(k0, z0), fold_w2_k2s2(kd, z0)
    s0 = t(rngp.uniform(0.5, 1.5, (z0 * c1,)))
    b0 = t(rngp.standard_normal((z0 * c1,)))
    sd = t(rngp.uniform(0.5, 1.5, (zo * c1,)))
    bd = t(rngp.standard_normal((zo * c1,)))
    args = (feats, mask, w0, s0, b0, wd, sd, bd)

    calls = {"v1": 0, "v2": 0}

    def v1():
        calls["v1"] += 1
        return fused_conv0_down0(*args, z=z0)

    def v2():
        calls["v2"] += 1
        return fused_down_concat(*args, z=z0)

    with torch.inference_mode():
        (o1, m1), (o2, m2) = v1(), v2()  # numerical parity first
        if not torch.equal(m1, m2):
            raise AssertionError("v1 and v2 output masks differ")
        fns = {"v1_shipped": v1, "v2_concat": v2}
        times = ab_ms(fns, device, iters)
        by_kernel = device_ms(fns, device)
    rec = dict(times, max_abs=float((o1.float() - o2.float()).abs().max()),
               frac_differ=differ(o2, o1),
               card=card() if device.type == "cuda" else "cpu", calls=calls)
    if by_kernel is not None:
        rec["device_ms"] = by_kernel
    return rec


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_down_v2: needs an NVIDIA GPU")
    rec = run(torch.device("cuda"))
    print(f"parity: max_abs={rec['max_abs']:.3e} "
          f"frac_differ={rec['frac_differ']:.3e}", file=sys.stderr)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
