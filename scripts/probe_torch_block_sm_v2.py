#!/usr/bin/env python
"""A/B of the eval ECA block on one NVIDIA GPU: P1, the im2col-concat
formulation (``agplace_tpu_torch/ops/probe_block_sm_v2.py``), against K3,
the shipped kernel (``agplace_tpu_torch/ops/bev_block_sm.py``), at block0's
shape ([32,64,64,128] -> 128, identity residual).  The port of
``scripts/probe_block_sm_v2.py``.

    python3 scripts/probe_torch_block_sm_v2.py [--chunk 1|3|9]

``--chunk`` is the number of taps per concatenated group (the JAX probe's
``CHUNK`` environment variable; default 3).  Inputs as the JAX probe makes
them: the stage-0 grid of ``probe_torch_down_v2.occupancy`` max-pooled
2x2x2 to the post-down0 grid, features from numpy seed 1 (standard normal,
masked), then the probe's dense folded 3x3 kernels (normal x 0.05), BN
affines and the 3-tap ECA kernel from the same generator.

It holds v2 against v1 on the same inputs, then times both in the
cold-L2 regime of ``probe_torch_down_v2.ab_ms`` (the 33.5 MB block input
would otherwise stay in the 50 MB L2 between calls).  Prints one JSON line:
``chunk``, ``v1_shipped`` and ``v2_concat`` in ms, ``max_abs``,
``frac_differ``, ``card``, ``calls`` and, on the card, ``device_ms`` (each
version's device time by kernel: P1's two conv phases, one halo box per
slab, against K3's two, one x box per tap).  ``run(device, chunk)``
returns the same record; on the CPU the times are None (not measured).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import card, differ  # noqa: E402
from probe_torch_down_v2 import (BATCH, ITERS, N_POINTS, ab_ms,  # noqa: E402
                                 device_ms, occupancy)


def run(device, chunk: int = 3, batch: int = BATCH,
        n_points: int = N_POINTS, iters: int = ITERS) -> dict:
    from agplace_tpu_torch import kitti360_config
    from agplace_tpu_torch.ops.bev_block_sm import fused_eca_block_sm
    from agplace_tpu_torch.ops.probe_block_sm_v2 import \
        fused_eca_block_concat
    from agplace_tpu_torch.sparse.bev_grid import mask_down

    device = torch.device(device)
    cfg = kitti360_config()
    vox = occupancy(cfg, batch, n_points, device)
    m1 = mask_down(vox.mask, (0, 0), (0, 0), (0, 0))  # block0's grid
    b, xo, yo, zo = m1.shape
    c1 = cfg.model.mm.voxfe_planes[0]
    zc = zo * c1

    rngp = np.random.default_rng(1)

    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a)).to(device, dtype)

    f1 = t(rngp.standard_normal((b, xo, yo, zc)), torch.bfloat16)
    f1 = f1 * m1.repeat_interleave(c1, dim=-1).to(torch.bfloat16)
    w1 = t(rngp.standard_normal((3, 3, zc, zc)) * 0.05)
    w2 = t(rngp.standard_normal((3, 3, zc, zc)) * 0.05)
    s1 = t(rngp.uniform(0.5, 1.5, (zc,)))
    b1 = t(rngp.standard_normal((zc,)))
    s2 = t(rngp.uniform(0.5, 1.5, (zc,)))
    b2 = t(rngp.standard_normal((zc,)))
    we = t(rngp.standard_normal((3,)))
    args = (f1, m1, w1, w2, s1, b1, s2, b2, we)

    calls = {"v1": 0, "v2": 0}

    def v1():
        calls["v1"] += 1
        return fused_eca_block_sm(*args, z=zo)

    def v2():
        calls["v2"] += 1
        return fused_eca_block_concat(*args, z=zo, chunk=chunk)

    with torch.inference_mode():
        o1, o2 = v1(), v2()  # numerical parity first
        fns = {"v1_shipped": v1, "v2_concat": v2}
        times = ab_ms(fns, device, iters)
        by_kernel = device_ms(fns, device)
    rec = dict({"chunk": chunk}, **times,
               max_abs=float((o1.float() - o2.float()).abs().max()),
               frac_differ=differ(o2, o1),
               card=card() if device.type == "cuda" else "cpu", calls=calls)
    if by_kernel is not None:
        rec["device_ms"] = by_kernel
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", type=int, default=3, choices=(1, 3, 9))
    chunk = ap.parse_args().chunk
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_block_sm_v2: needs an NVIDIA GPU")
    rec = run(torch.device("cuda"), chunk)
    print(f"parity: max_abs={rec['max_abs']:.3e} "
          f"frac_differ={rec['frac_differ']:.3e}", file=sys.stderr)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
