#!/usr/bin/env python
"""Ablation of K5 (``csrc/stem_pool.cu``) on one NVIDIA GPU: ring depth,
blocks per SM and band length.

    python3 scripts/ablate_torch_stem.py

Builds ``stem_pool.cu`` once per variant with the kernel's ``AGP_STEM_*``
switches (``-D``), all nvcc runs at once, into
``agplace_tpu_torch/_build/ablation/`` (git-ignored):

* ``shipped``: 4 ring slots of one input row, 2 blocks per SM;
* ``stages2``: 2 slots, 2 blocks per SM;
* ``stages8_1blk``: 8 slots, 1 block per SM (the grid one block per SM).

Each variant runs at the stem shapes [32,128,128,64] and [128,128,128,64]
with bands of 4, 8 and 16 output rows (the shipped tiling's other fields;
``stem_pool_tiling`` picks 16 at both on 132 SMs), every
result held bit-equal to ``stem_pool_plain``, and is timed by the
profiler's device time per call (``chip_smoke.device_ms``, 50 calls).
Prints one line per run, then one JSON line with every time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "agplace_tpu_torch", "_build", "ablation")
# variant -> (the kernel's switches, blocks per SM of its grid)
VARIANTS = {
    "shipped": ({}, 2),
    "stages2": ({"STAGES": 2}, 2),
    "stages8_1blk": ({"STAGES": 8, "MIN_BLOCKS": 1}, 1),
}
BANDS = (4, 8, 16)


def build_variants():
    from agplace_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(_build.SRC_DIR, "stem_pool.cu")
    sos = {name: os.path.join(OUT, f"stem_{name}.so") for name in VARIANTS}
    _build.run_all([_build.nvcc_cmd(
        "-shared", *[f"-DAGP_STEM_{k}={v}" for k, v in defs.items()],
        "-o", sos[name], src) for name, (defs, _) in VARIANTS.items()])
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        lib.agp_stem_pool.argtypes = _build._SIGNATURES["agp_stem_pool"]
        libs[name] = lib
    return libs


def with_band(t, b, h, band, blocks):
    """``t`` with bands of ``band`` output rows and ``blocks`` per SM."""
    nband = -(-(h // 2) // band)
    units = b * nband * t.ntw * t.nct
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dataclasses.replace(t, band=band, nband=nband, units=units,
                               grid=min(units, blocks * sms))


def main() -> None:
    from chip_smoke import card, device_ms
    from agplace_tpu_torch.ops import stem_pool

    if not torch.cuda.is_available():
        raise SystemExit("ablate_torch_stem: needs an NVIDIA GPU")
    name = card()
    print(name, flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    record = {"card": name, "ms": {}}
    for bsz in (32, 128):
        h = w = 128
        c = 64
        x = (torch.randn(bsz, h, w, c, generator=g) * 2).to(dev,
                                                            torch.bfloat16)
        sc = (torch.rand(c, generator=g) + 0.5).to(dev)
        bi = (torch.randn(c, generator=g) * 0.5).to(dev)
        want = stem_pool.stem_pool_plain(x, sc, bi)
        out = torch.empty_like(want)
        base = stem_pool.stem_pool_tiling(bsz, h, w, c, sms)
        shape = f"[{bsz},{h},{w},{c}]"
        record["ms"][shape] = {}
        for variant, lib in libs.items():
            for band in BANDS:
                t = with_band(base, bsz, h, band, VARIANTS[variant][1])

                def run():
                    err = lib.agp_stem_pool(
                        x.data_ptr(), sc.data_ptr(), bi.data_ptr(),
                        out.data_ptr(), bsz, h, w, c, *t.args(), stream)
                    if err != 0:
                        raise RuntimeError(f"{variant}: CUDA error {err}")

                out.zero_()
                run()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"{variant} band {band} {shape}: "
                                         f"not bit-equal to the plain version")
                ms = device_ms(run)
                record["ms"][shape][f"{variant}_band{band}"] = ms
                tbs = (x.numel() * 2 + out.numel() * 2) / ms / 1e9
                print(f"{shape} {variant:13s} band {band:2d} ({t.units} "
                      f"units, grid {t.grid}): {ms:.4f} ms = {tbs:.2f} TB/s "
                      f"of x in + out", flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
