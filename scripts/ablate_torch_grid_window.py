#!/usr/bin/env python
"""K1's grid instance and K4's window conv0 taken apart on one NVIDIA GPU.

    python3 scripts/ablate_torch_grid_window.py

Builds ``agplace_tpu_torch/csrc/ode_grid.cu`` and
``agplace_tpu_torch/csrc/head_conv0_sm90.cu`` once per variant with their
ablation switches (``-D``): K1's grid instance without the step's x
copies (``AGP_ODE_GRID_ABLATE=1``), its FMAs (2) or its grid barrier
(3); K4's window conv0 without its epilogue
(``AGP_HEAD_CONV0_ABLATE=1``), its MMAs (2), its weight boxes' loads
(3), its epilogue's TMA stores of h (4) or its staging of the affine and
the mask (5).  A switched-off part leaves the
results wrong, so only the shipped kernels are held to their plain
versions (``chip_smoke.K1_TOL``, ``KSTAGE0_TOL``).  Times are device ms
per call by ``torch.profiler`` (``chip_smoke.device_ms``), beside:

* K1 at x [32, D], D = 1024, 1536, 2048, and [128, 2048], 10 Euler steps,
  relu: the shipped kernel at 1, 2 and 10 steps (a step's cost: 10 steps
  less 2, over 8), each variant at 10, the wide instance
  (``csrc/ode_wide.cu``) at 1536 and 2048, the kernel and
  ``euler_ode_plain`` by CUDA events (median of 20);
* K4's conv0 at [widths]' W2 stage-0 widths (b32, 128 x 128 x 6, C1 =
  24) and W5's (b4, 128 x 128 x 40, C1 = 108 -> 112), k0 = 5, occupancy
  input: each variant, and cuDNN's ``F.conv2d`` of feats with the dense
  fold (bf16, channels_last; the conv alone).

The variants are built with ``ops/_build``'s nvcc flags, all at once,
into ``agplace_tpu_torch/_build/ablation/`` (git-ignored).  Prints one
line per shape, then one JSON line with every time and the card's name
and power limit.
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
VARIANTS = {
    "ode_grid.cu": {"no_x_copies": "AGP_ODE_GRID_ABLATE=1",
                    "no_fmas": "AGP_ODE_GRID_ABLATE=2",
                    "no_barrier": "AGP_ODE_GRID_ABLATE=3"},
    "head_conv0_sm90.cu": {"no_epilogue": "AGP_HEAD_CONV0_ABLATE=1",
                           "no_mmas": "AGP_HEAD_CONV0_ABLATE=2",
                           "no_weight_loads": "AGP_HEAD_CONV0_ABLATE=3",
                           "no_h_stores": "AGP_HEAD_CONV0_ABLATE=4",
                           "no_epilogue_staging":
                               "AGP_HEAD_CONV0_ABLATE=5"},
}
K1_SHAPES = ((32, 1024), (32, 1536), (32, 2048), (128, 2048))
# (label, batch, X = Y, z, C1, k0)
K4_SHAPES = (("W2", 32, 128, 6, 24, 5), ("W5", 4, 128, 40, 108, 5))


def build_variants():
    """One shared library per variant, all nvcc runs started together;
    each entry point with ``_build._SIGNATURES``' argument types."""
    from agplace_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    sos = {(src, name): os.path.join(OUT, f"{src[:-3]}_{name}.so")
           for src, vs in VARIANTS.items() for name in vs}
    _build.run_all([_build.nvcc_cmd(
        "-shared", f"-D{flag}", "-o", sos[(src, name)],
        os.path.join(_build.SRC_DIR, src))
        for src, vs in VARIANTS.items() for name, flag in vs.items()])
    entries = {}
    for (src, name), so in sos.items():
        fn = "agp_ode_grid" if src == "ode_grid.cu" else "agp_head_conv0"
        f = getattr(ctypes.CDLL(so), fn)
        f.argtypes = _build._SIGNATURES[fn]
        f.restype = ctypes.c_int
        entries[(src, name)] = f
    return entries


def launcher(f, *args):
    """A call of C entry ``f`` on the current stream; raises on an error."""
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def run():
        err = f(*conv, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA error {err}")
    return run


def k1_parts(entries, g, dev):
    import chip_smoke as cs
    from agplace_tpu_torch.ops import _build, ode_step

    rec = {}
    for bsz, d in K1_SHAPES:
        x = torch.randn(bsz, d, generator=g).to(dev)
        w = (torch.randn(d, d, generator=g) / d ** .5).to(dev)
        b = (torch.randn(d, generator=g) * 0.1).to(dev)
        a = (x, w, b, 10, 0.1, "relu")
        cs.compare(f"K1 grid [{bsz},{d}]", ode_step.fused_euler_ode(*a),
                   ode_step.euler_ode_plain(*a), cs.K1_TOL)
        t = ode_step.ode_tiling(bsz, d)
        scratch = torch.empty(t.scratch_floats(bsz), device=dev)
        out = torch.empty_like(x)
        r = {f"steps{n}": cs.device_ms(lambda: ode_step.fused_euler_ode(
            x, w, b, n, 0.1, "relu")) for n in (1, 2, 10)}
        r["step_ms"] = (r["steps10"] - r["steps2"]) / 8
        for name in VARIANTS["ode_grid.cu"]:
            r[name] = cs.device_ms(launcher(
                entries[("ode_grid.cu", name)], x, w, b, out, scratch, bsz,
                10, 0.1, 0, *t.args()))
        if d > 1024 and bsz == 32:
            rows = ode_step.wide_rows(d)
            tiles = -(-bsz // rows)
            tw = ode_step.OdeTiling(d, False, rows, ode_step.CLUSTER, tiles,
                                    tiles * ode_step.CLUSTER)
            r["wide"] = cs.device_ms(launcher(
                getattr(_build.lib(), "agp_ode_wide"), x, w, b, out, bsz, 10,
                0.1, 0, *tw.args()))
        r["events_ms"] = cs.cuda_ms(lambda: ode_step.fused_euler_ode(*a))
        r["plain_events_ms"] = cs.cuda_ms(
            lambda: ode_step.euler_ode_plain(*a))
        print(f"K1 grid [{bsz},{d}]: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items()), flush=True)
        rec[f"b{bsz}_D{d}"] = r
    return rec


def k4_parts(entries, g, dev):
    import torch.nn.functional as F

    import chip_smoke as cs
    from agplace_tpu_torch.data.voxels import me_down_align
    from agplace_tpu_torch.ops import bev_head
    from agplace_tpu_torch.sparse import bev_grid as bg

    rec = {}
    for label, bsz, xy, z, c1, k0 in K4_SHAPES:
        mask = torch.rand(bsz, xy, xy, z, generator=g) < 0.3
        w0 = bg.fold_w2_stride1(torch.randn(k0, k0, k0, 1, c1, generator=g)
                                * (2 / k0 ** 3) ** .5, z)
        s0 = (torch.rand(c1, generator=g) + 0.5).repeat(z)
        b0 = (torch.randn(c1, generator=g) * 0.1).repeat(z)
        mask, w0, s0, b0 = (v.to(dev) for v in (mask, w0, s0, b0))
        feats = mask.to(torch.bfloat16)
        zo = me_down_align(z)[2]
        wd = torch.zeros(2, 2, z * c1, zo * c1, device=dev)
        zs = torch.zeros(zo * c1, device=dev)
        w0p, s0p, b0p = bev_head.pad_head(w0, s0, b0, wd, zs, zs, z=z)[:3]
        t = bev_head.conv0_tiling(bsz, xy, xy, k0, 1, z,
                                  int(w0p.shape[3]) // z,
                                  torch.cuda.get_device_properties(
                                      dev).multi_processor_count)
        xp = F.pad(feats, (0, t.x_dims[0] - z))
        h = bev_head.head_conv0(feats, mask, w0p, s0p, b0p, z=z)
        want = bg.bev_conv2d(feats.float(), w0p.float(), 1, (k0 // 2,) * 2,
                             (k0 // 2,) * 2, torch.float32)
        want = bg.mask_bev(torch.relu(want * s0p + b0p), mask, z)
        cs.compare(f"K4 window conv0 {label}", h, want.to(torch.bfloat16),
                   cs.KSTAGE0_TOL)
        r = {"shipped": cs.device_ms(lambda: bev_head.head_conv0(
            feats, mask, w0p, s0p, b0p, z=z))}
        hv = torch.empty_like(h)
        for name in VARIANTS["head_conv0_sm90.cu"]:
            r[name] = cs.device_ms(launcher(
                entries[("head_conv0_sm90.cu", name)], xp, mask, w0p, s0p,
                b0p, hv, *t.args()))
        fc = feats.permute(0, 3, 1, 2)
        wc = w0.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        r["cudnn_dense_fold"] = cs.device_ms(
            lambda: F.conv2d(fc, wc, padding=k0 // 2))
        r["tiles"] = t.tiles
        print(f"K4 window conv0 {label}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in r.items()), flush=True)
        rec[label] = r
    return rec


def main():
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    entries = build_variants()
    g = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        rec = {"card": cs.card(), "k1_grid": k1_parts(entries, g, dev),
               "k4_window_conv0": k4_parts(entries, g, dev)}
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
