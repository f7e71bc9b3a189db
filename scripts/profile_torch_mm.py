#!/usr/bin/env python
"""Device time of the PyTorch port's MM forward by kernel, on one NVIDIA GPU.

    python scripts/profile_torch_mm.py [--batches 32 128] [--forwards 5]
        [--configs default fused dense sparse midpoint rk4 dopri5 geoloc]

Builds the MM query tower of ``kitti360_config()`` in bf16 at full width
(seeded random weights with non-trivial BN statistics, LiDAR-like clouds as
``chip_smoke.py`` makes them) in each configuration of ``--configs``
(default: the default one and the fused-stem / fused-head one,
``bev_pallas_head`` and ``stem_pallas`` set; ``dense`` / ``sparse``: that
voxel backend; ``midpoint`` / ``rk4`` / ``dopri5``: that integrator;
``geoloc``: the GeoLoc query tower instead of the MM, ResNet-50 conv4 +
NetVLAD x 64, which runs fp32 as JAX builds it).
For each configuration and batch it profiles ``--forwards`` forwards
after warm-up with ``torch.profiler`` and prints the device ms per forward
of every hand-written kernel (by template: ``conv3x3_sm90_kernel<EPI>`` is
K3's conv1 for ``<0>`` and conv2 + pool for ``<1>``;
``conv_igemm_kernel<2>`` is K3's 1x1 + combine; ``down0_sm90_kernel`` is
K2, ``head_sm90_kernel`` K4), of each class of library kernels,
the device total and the launch count; beside it the unprofiled
back-to-back ms per forward (CUDA events, median of 5 runs of
``--forwards`` forwards), so total / back-to-back is the device's busy
share.  The tables of PERF.md section 5 come from this script.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (IMAGE, card, cuda_ms, lidar,  # noqa: E402
                        profile_calls, seed_bn)

_OWN = re.compile(r"(conv3x3_sm90_kernel<[^>]*>|conv_igemm_kernel<[^>]*>"
                  r"|ode_euler_kernel|head_sm90_kernel"
                  r"|down0_sm90_kernel"
                  r"|stem_pool_kernel|eca_kernel|combine_id_kernel"
                  r"|combine_kernel|p1_sm90_kernel<[^>]*>"
                  r"|down_concat_(?:sm90_)?kernel)")
# library kernels, first match wins
_CLASSES = (
    ("max-pools", ("max_pool",)),
    ("cuDNN / cuBLAS convs and GEMMs", ("cudnn", "xmma", "cutlass", "gemm",
                                        "conv", "sm90_", "implicit")),
    ("sorts / scatters / gathers", ("sort", "scatter", "gather",
                                    "indexselect", "index_select", "radix",
                                    "cub::")),
    ("elementwise / copies", ("elementwise", "copy", "memcpy", "memset",
                              "fill", "cat", "index")),
    ("reductions", ("reduce",)),
)


# --configs: overrides of kitti360_config().model.mm ("model": of .model,
# "db": of .model.db)
CONFIGS = {
    "default": {},
    "fused": {"bev_pallas_head": True, "stem_pallas": True},
    "dense": {"voxfe_backend": "dense"},
    "sparse": {"voxfe_backend": "sparse"},
    "midpoint": {"ode": {"method": "midpoint"}},
    "rk4": {"ode": {"method": "rk4"}},
    "dopri5": {"ode": {"method": "dopri5"}},
    "geoloc": {"model": {"modelq": "geoloc", "backbone": "resnet50conv4",
                         "aggregation": "netvlad", "netvlad_clusters": 64},
               "db": {"modeldb": "geoloc"}},
}


def classify(name: str) -> str:
    own = _OWN.search(name)
    if own:
        return own.group(1)
    low = name.lower()
    for label, keys in _CLASSES:
        if any(k in low for k in keys):
            return label
    return "other"


def device_times(fn, n: int):
    """{class: (ms per call of fn, launches per call)} over n calls."""
    ms, count = defaultdict(float), defaultdict(int)
    for evt in profile_calls(fn, n).key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        key = classify(evt.key)
        ms[key] += evt.self_device_time_total / 1e3 / n
        count[key] += evt.count
    return {k: (ms[k], count[k] / n) for k in ms}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[32, 128])
    ap.add_argument("--forwards", type=int, default=5)
    ap.add_argument("--configs", nargs="+", default=["default", "fused"],
                    choices=sorted(CONFIGS))
    args = ap.parse_args()

    from agplace_tpu_torch import kitti360_config
    from agplace_tpu_torch.data.voxels import prepare_query_vox
    from agplace_tpu_torch.infer import build_towers
    from agplace_tpu_torch.models.factory import query_apply
    from agplace_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_mm: needs an NVIDIA GPU")
    print(card(), flush=True)
    _build.lib()
    dev = torch.device("cuda")
    cfg = kitti360_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    configs, models = {}, {}
    for label in args.configs:
        over = dict(CONFIGS[label])
        model_over = over.pop("model", {})
        db_over = over.pop("db", {})
        if "ode" in over:
            over["ode"] = dataclasses.replace(cfg.model.mm.ode,
                                              **over["ode"])
        c = cfg.replace(model=dataclasses.replace(
            cfg.model, mm=dataclasses.replace(cfg.model.mm, **over),
            db=dataclasses.replace(cfg.model.db, **db_over), **model_over))
        mm, _ = build_towers(c, "cpu", torch.Generator().manual_seed(0))
        seed_bn(mm, np.random.default_rng(0))
        configs[label], models[label] = c, mm.to(dev)

    rng = np.random.default_rng(5)
    n = args.forwards
    for bsz in args.batches:
        images = torch.from_numpy(rng.standard_normal(
            (bsz, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
        points = lidar(rng, bsz)
        for label, mm in models.items():
            vox = prepare_query_vox(configs[label], points, dev)

            def forward(mm=mm, vox=vox):
                return query_apply(mm, images, vox)

            def forwards():
                for _ in range(n):
                    forward()

            with torch.inference_mode():
                wall = cuda_ms(forwards, warmup=1, iters=5) / n
                times = device_times(forward, n)
            total = sum(ms for ms, _ in times.values())
            launches = sum(c for _, c in times.values())
            print(f"\n== query-tower forward b{bsz} {label}: device "
                  f"{total:.3f} ms "
                  f"({launches:.0f} kernels) per forward; back-to-back "
                  f"{wall:.3f} ms per forward unprofiled; busy "
                  f"{100 * total / wall:.1f} %", flush=True)
            for key, (ms, cnt) in sorted(times.items(),
                                         key=lambda kv: -kv[1][0]):
                print(f"  {ms:8.3f} ms {100 * ms / total:5.1f} % "
                      f"{cnt:6.1f} x  {key}", flush=True)


if __name__ == "__main__":
    main()
