#!/usr/bin/env python
"""Ablation of K3's conv phases on one NVIDIA GPU: where the time goes.

    python3 scripts/ablate_torch_conv3x3.py

Builds ``agplace_tpu_torch/csrc/conv3x3_sm90.cu`` once per variant with the
kernel's ``AGP_CONV3X3_*`` switches (``-D``), and times phase 1 (the conv +
BN + relu + mask) of each beside the shipped build at block shapes of the
KITTI-360 preset:

* ``no_A_load`` / ``no_B_load`` / ``no_loads``: the producer skips the
  input's TMA box, the weights' two boxes, or both (the barrier then
  expects only the bytes still loaded), so the MMAs read whatever the ring
  holds;
* ``no_mma``: the consumers wait and release each stage but issue no
  wgmma;
* ``stages2``: two ring stages per block (two blocks per SM, as shipped);
  ``stages6_1blk``: six stages, one block per SM.

The ablated builds compute wrong results on purpose: only their times are
read.  Each time is the median of 20 runs of 10 calls queued between two
CUDA events (device ms per call).  ``TMA TB/s`` is the bytes the TMA
boxes of the shipped kernel bring into shared memory (32 KB per K step and
block) over that time.  The variants are built with ``ops/_build``'s nvcc
flags, all at once, into ``agplace_tpu_torch/_build/ablation/``
(git-ignored).  Prints one line per shape and variant, then one JSON line
with every time.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "agplace_tpu_torch", "_build", "ablation")
# variant -> the kernel's switches: ring stages, blocks per SM, skip bits
# (1 the x box, 2 the weight boxes, 4 the MMAs)
VARIANTS = {
    "shipped": {},
    "no_A_load": {"SKIP": 1},
    "no_B_load": {"SKIP": 2},
    "no_loads": {"SKIP": 3},
    "no_mma": {"SKIP": 4},
    "stages2": {"STAGES": 2},
    "stages6_1blk": {"STAGES": 6, "MIN_BLOCKS": 1},
}
# (batch, map side, Zcin, Zcout): block0 at b128 and b32, ffn_vox at b32,
# block1's first conv at b128
SHAPES = ((128, 64, 128, 128), (32, 64, 128, 128), (32, 16, 512, 512),
          (128, 32, 128, 256))


def build_variants():
    """One shared library per variant, all nvcc runs started together."""
    from agplace_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(_build.SRC_DIR, "conv3x3_sm90.cu")
    sos = {name: os.path.join(OUT, f"{name}.so") for name in VARIANTS}
    _build.run_all([_build.nvcc_cmd(
        "-shared", *[f"-DAGP_CONV3X3_{k}={v}" for k, v in defs.items()],
        "-o", sos[name], src) for name, defs in VARIANTS.items()])
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        lib.agp_conv3x3.argtypes = _build._SIGNATURES["agp_conv3x3"]
        libs[name] = lib
    return libs


def main() -> None:
    from chip_smoke import card, queued_ms
    from agplace_tpu_torch.ops import bev_block_sm

    if not torch.cuda.is_available():
        raise SystemExit("ablate_torch_conv3x3: needs an NVIDIA GPU")
    name = card()
    print(name, flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    record = {"card": name, "ms": {}}
    for bsz, xy, zci, zco in SHAPES:
        z = 2
        mask = (torch.rand(bsz, xy, xy, z, generator=g) < 0.4).to(dev)
        x = torch.randn(bsz, xy, xy, zci, generator=g).to(dev,
                                                           torch.bfloat16)
        w = (torch.randn(3, 3, zci, zco, generator=g) * 0.02).to(
            dev, torch.bfloat16)
        s, b = torch.ones(zco, device=dev), torch.zeros(zco, device=dev)
        out = torch.empty(bsz, xy, xy, zco, dtype=torch.bfloat16,
                          device=dev)
        t = bev_block_sm.conv3x3_tiling(bsz, xy, xy, zci, zco)
        flops = 2.0 * bsz * xy * xy * 9 * zci * zco  # dense at z = 2
        shape = f"[{bsz},{xy},{xy},{zci}]->{zco}"
        record["ms"][shape] = {}
        for variant, lib in libs.items():
            def run():
                err = lib.agp_conv3x3(
                    x.data_ptr(), mask.data_ptr(), w.data_ptr(),
                    s.data_ptr(), b.data_ptr(), out.data_ptr(), None, 0, z,
                    *t.args(), stream)
                if err != 0:
                    raise RuntimeError(f"{variant}: CUDA error {err}")
            ms = queued_ms(run)
            record["ms"][shape][variant] = ms
            print(f"{shape} {variant:13s} {ms:.4f} ms "
                  f"{flops / ms / 1e9:6.1f} TFLOP/s, TMA "
                  f"{t.grid * t.steps * 32768 / ms / 1e9:.2f} TB/s",
                  flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
