#!/usr/bin/env python
"""Ablation of K2's down0 GEMM and K4 on one NVIDIA GPU: where the time goes.

    python3 scripts/ablate_torch_stage0.py

Builds ``agplace_tpu_torch/csrc/bev_down.cu`` once per variant with the
kernel's ``AGP_DOWN0_*`` switches (``-D``), and times each beside the
shipped build on conv0's output at the KITTI-360 stage-0 shapes
([B, 128, 128, 256] -> [B, 64, 64, 128], b32 and b128), on the shipped
persistent grid (every block slot of the SMs filled):

* ``no_g_load``: the producer skips the g box (the barrier then expects
  only the weight bytes), so the consumers read whatever the ring holds;
* ``no_prologue``: the A fragments go to the MMAs as loaded (no BN0, relu
  or mask);
* ``no_mma``: the consumers load and transform A but issue no wgmma;
* ``loads_only``: neither prologue nor MMAs;
* ``stages3_2blk``: three ring stages, two blocks per SM (the registers
  then capped near 96); ``stages6``: six stages (one block per SM, as
  shipped with four).

and ``csrc/bev_head.cu`` (K4) with its ``AGP_HEAD_SKIP`` bits on the
occupancy grid of the same shapes (conv0 5x5 over Z*C0 = 4, the resident
instance): ``no_im2col``
(the im2col copies), ``no_conv0_mma``, ``no_down0_mma``, ``no_epilogue``
(the BN0 arithmetic: the accumulator goes to down0 as it is),
``no_wd_load``, ``no_mma`` (both GEMMs).

The ablated builds compute wrong results on purpose: only their times are
read.  Each time is the median of 20 runs of 10 calls queued between two
CUDA events (device ms per call); ``TB/s`` is g's bytes read plus the
output's written over that time.  The variants are built with
``ops/_build``'s nvcc flags, all at once, into
``agplace_tpu_torch/_build/ablation/`` (git-ignored).  Prints one line per
shape and variant, then one JSON line with every time.
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
# (1 the g box, 2 the prologue, 4 the MMAs)
VARIANTS = {
    "shipped": {},
    "no_g_load": {"SKIP": 1},
    "no_prologue": {"SKIP": 2},
    "no_mma": {"SKIP": 4},
    "loads_only": {"SKIP": 6},
    "stages3_2blk": {"STAGES": 3, "MIN_BLOCKS": 2},
    "stages6": {"STAGES": 6},
}
HEAD_VARIANTS = {
    "shipped": 0, "no_im2col": 1, "no_conv0_mma": 2, "no_down0_mma": 4,
    "no_mma": 6, "no_epilogue": 8, "no_wd_load": 16,
}
BATCHES = (32, 128)


def build_variants():
    """One shared library per variant of each kernel, all nvcc runs started
    together."""
    from agplace_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    jobs = {f"down0_{name}": ("bev_down.cu", [f"-DAGP_DOWN0_{k}={v}"
                                              for k, v in defs.items()])
            for name, defs in VARIANTS.items()}
    jobs.update({f"head_{name}": ("bev_head.cu", [f"-DAGP_HEAD_SKIP={bits}"])
                 for name, bits in HEAD_VARIANTS.items()})
    sos = {name: os.path.join(OUT, f"{name}.so") for name in jobs}
    _build.run_all([_build.nvcc_cmd(
        "-shared", *defs, "-o", sos[name], os.path.join(_build.SRC_DIR, src))
        for name, (src, defs) in jobs.items()])
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(so)
        entry = "agp_bev_down" if name.startswith("down0_") else \
            "agp_bev_head"
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
        libs[name] = lib
    return libs


def main() -> None:
    from chip_smoke import card, queued_ms
    from agplace_tpu_torch.ops import bev_down

    if not torch.cuda.is_available():
        raise SystemExit("ablate_torch_stage0: needs an NVIDIA GPU")
    name = card()
    print(name, flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    record = {"card": name, "ms": {}}
    z, xy, zc1, zc2 = 4, 128, 256, 128
    for bsz in BATCHES:
        mask = (torch.rand(bsz, xy, xy, z, generator=g) < 0.3).to(dev)
        g0 = torch.randn(bsz, xy, xy, zc1, generator=g).to(dev,
                                                            torch.bfloat16)
        wd = (torch.randn(2, 2, zc1, zc2, generator=g) * 0.05).to(
            dev, torch.bfloat16)
        s0, b0 = torch.ones(zc1, device=dev), torch.zeros(zc1, device=dev)
        sd, bd = torch.ones(zc2, device=dev), torch.zeros(zc2, device=dev)
        m_out = torch.ones(bsz, xy // 2, xy // 2, 2, dtype=torch.bool,
                           device=dev)
        out = torch.empty(bsz, xy // 2, xy // 2, zc2, dtype=torch.bfloat16,
                          device=dev)
        n_bytes = (g0.numel() + out.numel()) * 2
        shape = f"[{bsz},{xy},{xy},{zc1}]->{zc2} persistent"
        record["ms"][shape] = {}
        for variant in VARIANTS:
            lib = libs[f"down0_{variant}"]
            per_sm = VARIANTS[variant].get("MIN_BLOCKS", 1)
            t = bev_down.down0_tiling(bsz, xy, xy, zc1, zc2, sms * per_sm)

            def run():
                err = lib.agp_bev_down(
                    g0.data_ptr(), mask.data_ptr(), s0.data_ptr(),
                    b0.data_ptr(), wd.data_ptr(), sd.data_ptr(),
                    bd.data_ptr(), m_out.data_ptr(), out.data_ptr(), z, 2,
                    *t.args(), stream)
                if err != 0:
                    raise RuntimeError(f"{variant}: CUDA error {err}")
            ms = queued_ms(run)
            record["ms"][shape][variant] = ms
            print(f"{shape} {variant:13s} {ms:.4f} ms "
                  f"{n_bytes / ms / 1e9:.2f} TB/s", flush=True)
        head_ms(libs, record, bsz, mask, sms, stream)
    print(json.dumps(record), flush=True)


def head_ms(libs, record, bsz, mask, sms, stream):
    """K4's variants on the occupancy grid ``mask`` (conv0 5x5 over Z*C0 =
    4, Z*C1 = 256 -> 128), persistent grid; TFLOP/s of the 3-D convs'
    products (chip_smoke.conv_flops, 40.7 GFLOP at b32)."""
    from chip_smoke import conv_flops, queued_ms
    from agplace_tpu_torch.ops import bev_head
    from agplace_tpu_torch.sparse.bev_grid import fold_w2_k2s2, \
        fold_w2_stride1

    g = torch.Generator().manual_seed(1)
    dev = mask.device
    xy, z, k0 = mask.shape[1], 4, 5
    feats = mask.to(torch.bfloat16).contiguous()
    w0 = fold_w2_stride1(torch.randn(k0, k0, k0, 1, 64, generator=g) * 0.25,
                         z)
    wdf = fold_w2_k2s2(torch.randn(2, 2, 2, 64, 64, generator=g) * 0.09, z)
    t = bev_head.head_tiling(bsz, xy, xy, k0, 4, 256, 128, sms)
    w0p = torch.zeros(t.w0_dims[1], 256, dtype=torch.bfloat16, device=dev)
    w0p[:k0 * k0 * 4] = w0.reshape(-1, 256).to(dev, torch.bfloat16)
    wdb = wdf.to(dev, torch.bfloat16).contiguous()
    ones, zeros = torch.ones(256, device=dev), torch.zeros(256, device=dev)
    m_out = torch.ones(bsz, xy // 2, xy // 2, 2, dtype=torch.bool, device=dev)
    out = torch.empty(bsz, xy // 2, xy // 2, 128, dtype=torch.bfloat16,
                      device=dev)
    cells = bsz * xy * xy
    flops = conv_flops(cells, w0, z, z) + conv_flops(cells // 4, wdf, z, 2)
    shape = f"K4 [{bsz},{xy},{xy},4]->128 persistent"
    record["ms"][shape] = {}
    for variant in HEAD_VARIANTS:
        lib = libs[f"head_{variant}"]

        def run():
            err = lib.agp_bev_head(
                feats.data_ptr(), mask.data_ptr(), w0p.data_ptr(),
                ones.data_ptr(), zeros.data_ptr(), wdb.data_ptr(),
                ones.data_ptr(), zeros.data_ptr(), m_out.data_ptr(),
                out.data_ptr(), z, 2, k0, 4, *t.args(), stream)
            if err != 0:
                raise RuntimeError(f"head {variant}: CUDA error {err}")
        ms = queued_ms(run)
        record["ms"][shape][variant] = ms
        print(f"{shape} {variant:13s} {ms:.4f} ms "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)


if __name__ == "__main__":
    main()
