#!/usr/bin/env python
"""Device time of K5 and K6 at their main-path shapes, for one tree of the
port, on one NVIDIA GPU.

    python3 scripts/ab_torch_stem_block.py [--root DIR] [--label NAME]

Imports ``agplace_tpu_torch`` from ``--root`` (default: this checkout), so
one call can time a parent tree unpacked beside the change (run parent,
change, change, parent).  Inputs are made from fixed seeds, the same for
every tree:

* K5 (``fused_affine_relu_maxpool``) on the stem conv output of 256 px
  images, [32,128,128,64] and [128,128,128,64] bf16;
* K6 (``fused_eca_block``, z = 2) at [32,64,64,128] and [32,16,16,512]
  with bf16 folded weights, on occupancy masks of LiDAR-like clouds
  voxelized as ``chip_smoke.py`` does (KITTI-360 preset, mask_down to the
  stage-0 and stage-2 grids).

Each is timed by the profiler's device time per call (``device_ms``, 50
calls after a warm-up: every kernel of the call, K6's four phases and its
pool's fill) and by CUDA events around one synchronised call
(``cuda_ms``, median of 20: below ~0.05 ms the host's).  Prints one line
per measurement, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card, cuda_ms, device_ms, lidar  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="change")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_stem_block: needs an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(a.root))
    import dataclasses

    import agplace_tpu_torch
    from agplace_tpu_torch import kitti360_config
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.ops import bev_block, stem_pool
    from agplace_tpu_torch.sparse.bev_grid import fold_w2_stride1, mask_down

    name = card()
    print(name, a.label, os.path.dirname(agplace_tpu_torch.__file__),
          flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    rec = {"card": name, "label": a.label, "k5": {}, "k6": {}}
    with torch.inference_mode():
        for bsz in (32, 128):
            x = (torch.randn(bsz, 128, 128, 64, generator=g) * 2).to(
                dev, torch.bfloat16)
            sc = (torch.rand(64, generator=g) + 0.5).to(dev)
            bi = (torch.randn(64, generator=g) * 0.5).to(dev)

            def k5():
                stem_pool.fused_affine_relu_maxpool(x, sc, bi)

            r = {"device_ms": device_ms(k5), "cuda_ms": cuda_ms(k5)}
            rec["k5"][f"b{bsz}"] = r
            print(f"K5 [{bsz},128,128,64] {a.label}: {r['device_ms']:.4f} "
                  f"ms device, {r['cuda_ms']:.4f} ms synchronised",
                  flush=True)

        cfg = kitti360_config()
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    compute_dtype="bfloat16"))
        rng = np.random.default_rng(42)
        m = prepare_query_vox(cfg, lidar(rng, 32), dev).mask
        masks = [m]
        for pz in ((0, 0), (1, 1), (1, 1)):
            masks.append(mask_down(masks[-1], (0, 0), (0, 0), pz))
        z = 2
        for mask, c in ((masks[1], 64), (masks[3], 256)):
            bsz, xy = mask.shape[0], mask.shape[1]
            xin = torch.randn(bsz, xy, xy, z, c, generator=g).to(
                dev, torch.bfloat16)
            xin = torch.where(mask[..., None], xin, 0).reshape(
                bsz, xy, xy, z * c)
            ws = [fold_w2_stride1(torch.randn(3, 3, 3, c, c, generator=g)
                                  * (2 / (27 * c)) ** .5, z).to(
                dev, torch.bfloat16) for _ in range(2)]
            aff = [(torch.rand(c, generator=g) + 0.5).repeat(z).to(dev)
                   if i % 2 == 0 else
                   (torch.randn(c, generator=g) * 0.1).repeat(z).to(dev)
                   for i in range(4)]
            w_eca = torch.randn(3 if c == 64 else 5, generator=g).to(dev)
            args = (xin, mask, *ws, *aff, w_eca)

            def k6():
                bev_block.fused_eca_block(*args, z=z)

            shape = f"[{bsz},{xy},{xy},{z * c}]"
            r = {"device_ms": device_ms(k6), "cuda_ms": cuda_ms(k6)}
            rec["k6"][shape] = r
            print(f"K6 {shape} {a.label}: {r['device_ms']:.4f} ms device, "
                  f"{r['cuda_ms']:.4f} ms synchronised", flush=True)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
