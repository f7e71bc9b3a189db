#!/usr/bin/env python
"""Device time of the probe kernels P1 and P2 at their b32 shapes, for one
tree of the port, on one NVIDIA GPU.

    python3 scripts/ab_torch_probes.py [--root DIR] [--label NAME]

Imports ``agplace_tpu_torch`` from ``--root`` (default: this checkout), so
one call can time a parent tree unpacked beside the change (run parent,
change, change, parent).  It calls only the wrappers every tree has
(``fused_eca_block_concat``, ``fused_down_concat``) and splits their
device time by kernel with ``torch.profiler`` (50 calls after a warm-up):

* P1 at K3's four b32 block shapes (z = 2 after down0: [32,64,64,128] ->
  128, [32,32,32,128] -> 256 with the 1x1 residual, [32,16,16,256] -> 512
  with it, [32,16,16,512] -> 512) at chunks 1, 3 and 9: its two conv
  phases (the kernels named ``halo_conv3x3_kernel`` or ``p1_sm90_kernel``)
  and the whole block;
* P2 on KITTI-360's stage 0 at b32 ([32,128,128,4] -> [32,64,64,128]): its
  GEMM kernel (``down_concat_kernel`` or ``down_concat_sm90_kernel``;
  the four cuDNN parity convs it follows are not counted) and the whole
  wrapper.

Inputs come from fixed seeds, the same for every tree: occupancy of
LiDAR-like clouds voxelized as ``chip_smoke.py`` does, weights as its
[parity] phase draws them.  Prints one line per measurement, then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from collections import defaultdict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card, lidar  # noqa: E402

P1_CONV = re.compile(r"halo_conv3x3_kernel|p1_sm90_kernel")
P2_GEMM = re.compile(r"down_concat_(sm90_)?kernel")
CHUNKS = (1, 3, 9)


def by_kernel(fn, n: int = 50) -> dict:
    """{kernel name: device ms per call of fn} over n calls (profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.key] += e.self_device_time_total / 1e3 / n
    if not out:
        raise RuntimeError("the profiler recorded no device time")
    return dict(out)


def split(times: dict, pattern) -> tuple:
    """(ms of the kernels matching ``pattern``, ms of all)."""
    mine = sum(ms for k, ms in times.items() if pattern.search(k))
    if mine <= 0:
        raise RuntimeError(f"no kernel matching {pattern.pattern} ran: "
                           f"{sorted(times)}")
    return mine, sum(times.values())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--label", default="change")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_probes: needs an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(a.root))
    import dataclasses

    import agplace_tpu_torch
    from agplace_tpu_torch import kitti360_config
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.ops import probe_block_sm_v2, probe_down_v2
    from agplace_tpu_torch.sparse.bev_grid import (fold_w2_k2s2,
                                                   fold_w2_stride1, mask_down)

    name = card()
    print(name, a.label, os.path.dirname(agplace_tpu_torch.__file__),
          flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=g) * std).to(dev)

    def affine(c, z):
        return ((torch.rand(c, generator=g) + 0.5).repeat(z).to(dev),
                (torch.randn(c, generator=g) * 0.1).repeat(z).to(dev))

    cfg = kitti360_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    m0 = prepare_query_vox(cfg, lidar(np.random.default_rng(42), 32),
                           dev).mask
    masks = [m0]
    for pz in ((0, 0), (1, 1), (1, 1)):
        masks.append(mask_down(masks[-1], (0, 0), (0, 0), pz))
    rec = {"card": name, "label": a.label, "p1": {}, "p2": {}}
    with torch.inference_mode():
        # P2 on KITTI-360's stage 0
        z0, c1 = 4, 64
        args = (m0.to(torch.bfloat16), m0,
                fold_w2_stride1(randn(5, 5, 5, 1, c1, std=0.25), z0),
                *affine(c1, z0),
                fold_w2_k2s2(randn(2, 2, 2, c1, c1, std=0.09), z0),
                *affine(c1, 2))
        gemm, total = split(by_kernel(
            lambda: probe_down_v2.fused_down_concat(*args, z=z0)), P2_GEMM)
        rec["p2"] = {"gemm_device_ms": gemm, "device_ms": total}
        print(f"P2 [32,128,128,4] {a.label}: GEMM kernel {gemm:.4f} ms, "
              f"wrapper {total:.4f} ms of device time", flush=True)
        # P1 at K3's four b32 block shapes
        z = 2
        blocks = []
        for mask, cin, c in ((masks[1], 64, 64), (masks[2], 64, 128),
                             (masks[3], 128, 256), (masks[3], 256, 256)):
            bsz, xy = mask.shape[0], mask.shape[1]
            xin = randn(bsz, xy, xy, z, cin).to(torch.bfloat16)
            xin = torch.where(mask[..., None], xin, 0).reshape(
                bsz, xy, xy, z * cin)
            kw = {}
            if cin != c:
                sd, bd = affine(c, z)
                kw = dict(wd=fold_w2_stride1(randn(1, 1, 1, cin, c,
                                                   std=(2 / cin) ** .5), z),
                          scale_d=sd, bias_d=bd)
            blk = (xin, mask,
                   fold_w2_stride1(randn(3, 3, 3, cin, c,
                                         std=(2 / (27 * cin)) ** .5), z),
                   fold_w2_stride1(randn(3, 3, 3, c, c,
                                         std=(2 / (27 * c)) ** .5), z),
                   *affine(c, z), *affine(c, z), randn(3 if c == 64 else 5))
            blocks.append((f"[{bsz},{xy},{xy},{z * cin}]->{z * c}", blk, kw))
        for chunk in CHUNKS:
            r = {"conv_phases_device_ms": 0.0, "device_ms": 0.0,
                 "by_shape": {}}
            for shape, blk, kw in blocks:
                conv, total = split(by_kernel(
                    lambda: probe_block_sm_v2.fused_eca_block_concat(
                        *blk, z=z, chunk=chunk, **kw)), P1_CONV)
                r["conv_phases_device_ms"] += conv
                r["device_ms"] += total
                r["by_shape"][shape] = {"conv_phases_device_ms": conv,
                                        "device_ms": total}
                print(f"P1 chunk {chunk} {shape} {a.label}: conv phases "
                      f"{conv:.4f} ms, block {total:.4f} ms of device time",
                      flush=True)
            rec["p1"][chunk] = r
            print(f"P1 chunk {chunk} {a.label}, four shapes: conv phases "
                  f"{r['conv_phases_device_ms']:.4f} ms, block "
                  f"{r['device_ms']:.4f} ms", flush=True)
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
