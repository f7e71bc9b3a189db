#!/usr/bin/env python
"""Ablation of the probe kernels P1 and P2 on one NVIDIA GPU.

    python3 scripts/ablate_torch_probes.py [--no-time]

Builds ``agplace_tpu_torch/csrc/probe_block_sm_v2.cu`` (P1's conv phases)
and ``csrc/probe_down_v2.cu`` (P2) once per variant with the kernels'
``-D`` switches, all nvcc runs started together, into
``agplace_tpu_torch/_build/ablation/`` (git-ignored):

* P1 as shipped (``ss``: wgmma reads each tap's rows from shared memory
  through a descriptor that starts dy rows into the halo, a 16 x 8 patch,
  two blocks per SM, one halo buffer and as many weight stages as fit: 5
  / 3 / 2 at chunk 1 / 3 / 9); ``ss_base`` with the descriptor's
  base-offset field set to ``(start >> 7) & 7`` (the probe of how the
  128-byte swizzle is read from a start that is not 1024-byte aligned);
  ``ss_hy16``: halo rows of 16 cells, so that every core group of a tap
  starts at the same swizzle phase; ``ss_2halos``: two halo buffers (the
  next slab's halo loads during the current one's taps) and fewer weight
  stages (3 / 2 / 2; at chunk 9 they leave room for one block per SM);
  ``ss_stages2``: two weight stages at every chunk; ``ss_1blk``: one
  block per SM with larger stages (KC 64 / 64 / 32, 11 / 3 / 2 stages);
  ``rs`` and ``rs_1blk``: the rows ldmatrix'ed into wgmma's register
  fragment instead (an 8 x 16 patch);
* P2's ring at 3 and 4 stages (``AGP_DOWN0_STAGES``).

Each P1 variant is first checked against the plain version
(``concat_conv_phase_plain``) tap by tap -- the weights zero but for one
tap, so a wrong shift of that tap's rows shows alone -- then with all nine
taps at chunk 1, 3 and 9 on ragged patches, two K slabs and two N tiles,
and at Z*C = 96 -> 96 (zero-filled channels and a ragged N tile).  A
variant that fails is reported and not timed.  Then (unless ``--no-time``)
both conv phases of each passing variant are timed at K3's four b32 block
shapes (z = 2: [32,64,64,128]->128, [32,32,32,128]->256,
[32,16,16,256]->512, [32,16,16,512]->512), and P2's kernel alone at
[32,64,64,256]->128 and b128: the device time of the variant's kernels
per call (``torch.profiler``, 50 calls after a warm-up; the host's work
around each call is not counted).  Prints one line per check and time,
then one JSON line with every result.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

OUT = os.path.join(ROOT, "agplace_tpu_torch", "_build", "ablation")
# P1 variant -> (route, halo y extent, blocks per SM, its AGP_P1_*
# switches); "ss" is the shipped build
P1_VARIANTS = {
    "ss": ("ss", 10, 2, {}),
    "ss_base": ("ss", 10, 2, {"BASE": 1}),
    "ss_hy16": ("ss", 16, 2, {"HY": 16}),
    "ss_2halos": ("ss", 10, 2, {"HALOS": 2}),
    "ss_stages2": ("ss", 10, 2, {"STAGES": 2}),
    "ss_1blk": ("ss", 10, 1, {"MIN_BLOCKS": 1}),
    "rs": ("rs", 18, 2, {"SS": 0}),
    "rs_1blk": ("rs", 18, 1, {"SS": 0, "MIN_BLOCKS": 1}),
}
P2_VARIANTS = {"stages3": 3, "stages4": 4}
CHUNKS = (1, 3, 9)
# K3's four b32 block shapes: (batch, map side, Zcin, Zcout)
SHAPES = ((32, 64, 128, 128), (32, 32, 128, 256), (32, 16, 256, 512),
          (32, 16, 512, 512))
SMEM_LIMIT = 232448


def build_variants():
    from agplace_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    jobs = {f"p1_{n}": ("probe_block_sm_v2.cu",
                        [f"-DAGP_P1_{k}={v}" for k, v in d.items()])
            for n, (_, _, _, d) in P1_VARIANTS.items()}
    jobs.update({f"p2_{n}": ("probe_down_v2.cu", [f"-DAGP_DOWN0_STAGES={s}"])
                 for n, s in P2_VARIANTS.items()})
    sos = {n: os.path.join(OUT, f"{n}.so") for n in jobs}
    _build.run_all([_build.nvcc_cmd("-shared", *defs, "-o", sos[n],
                                    os.path.join(_build.SRC_DIR, src))
                    for n, (src, defs) in jobs.items()])
    libs = {}
    for n, so in sos.items():
        lib = ctypes.CDLL(so)
        for entry in (("agp_p1_conv_sm90", "agp_p1_smem_bytes")
                      if n.startswith("p1_") else ("agp_down_concat_sm90",)):
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[n] = lib
    return libs


def p1_phase(variant, lib, x, mask, w, s, b, pool, chunk, z):
    """One P1 conv phase of a variant's library: the output (and sums)."""
    from agplace_tpu_torch.ops import probe_block_sm_v2 as p1

    route, hy, blocks, _ = P1_VARIANTS[variant]
    bsz, xd, yd, zci = x.shape
    zco = w.shape[3]
    t = p1.concat_conv_tiling(bsz, xd, yd, zci, zco, chunk,
                              torch.cuda.get_device_properties(x.device).
                              multi_processor_count, route=route, hy=hy,
                              blocks_per_sm=blocks)
    out = torch.empty(bsz, xd, yd, zco, dtype=torch.bfloat16,
                      device=x.device)
    sums = (torch.zeros(bsz, zco, device=x.device) if pool else None)
    err = lib.agp_p1_conv_sm90(
        x.data_ptr(), mask.data_ptr(), w.data_ptr(), s.data_ptr(),
        b.data_ptr(), out.data_ptr(), None if sums is None
        else sums.data_ptr(), int(pool), chunk, z, *t.args(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"agp_p1_conv_sm90: CUDA error {err}")
    return (out, sums) if pool else out


def inputs(g, dev, b, xy_x, xy_y, zci, zco, z=2, density=0.4):
    mask = (torch.rand(b, xy_x, xy_y, z, generator=g) < density).to(dev)
    x = torch.randn(b, xy_x, xy_y, zci, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(3, 3, zci, zco, generator=g) * (2 / (9 * zci)) ** .5
         ).to(dev, torch.bfloat16)
    s = (torch.rand(zco, generator=g) + 0.5).to(dev)
    bb = (torch.randn(zco, generator=g) * 0.1).to(dev)
    return x, mask, w, s, bb


def check_p1(name, lib, dev) -> dict:
    """Tap by tap, then all taps at each chunk (those whose stages fit a
    block), against the plain version; {check: max_abs_err or the
    failure}."""
    from chip_smoke import KCONV_TOL, KPOOL_TOL, compare
    from agplace_tpu_torch.ops import probe_block_sm_v2 as p1

    g = torch.Generator().manual_seed(0)
    res = {}

    def one(label, x, mask, w, s, b, chunk, pool):
        z = mask.shape[-1]
        try:
            got = p1_phase(name, lib, x, mask, w, s, b, pool, chunk, z)
            want = p1.concat_conv_phase_plain(
                x, mask, w.float(), s, b, z, pool, chunk)
            torch.cuda.synchronize()
            if pool:
                compare(f"{name} {label} pool", got[1], want[1], KPOOL_TOL)
                got, want = got[0], want[0]
            res[label] = compare(f"{name} {label}", got, want,
                                 KCONV_TOL)["max_abs_err"]
        except (AssertionError, RuntimeError) as e:
            res[label] = f"FAIL: {e}"[:200]
            print(f"  {name} {label}: {res[label]}", flush=True)

    # ragged patches (12 x 20 cells), two K slabs, two N tiles
    x, mask, w, s, b = inputs(g, dev, 2, 12, 20, 128, 256)
    for tap in range(9):
        wt = torch.zeros_like(w)
        wt[tap // 3, tap % 3] = w[tap // 3, tap % 3]
        one(f"tap {tap} alone chunk 1", x, mask, wt, s, b, 1, False)
    for chunk in CHUNKS:
        if lib.agp_p1_smem_bytes(chunk) > SMEM_LIMIT:
            continue
        one(f"all taps chunk {chunk}", x, mask, w, s, b, chunk, chunk == 3)
        x96, m96, w96, s96, b96 = inputs(g, dev, 2, 9, 18, 96, 96)
        one(f"Z*C 96 chunk {chunk}", x96, m96, w96, s96, b96, chunk, True)
    return res


def check_p2(name, lib, dev) -> bool:
    from chip_smoke import KSTAGE0_TOL, compare
    from agplace_tpu_torch.ops import probe_down_v2 as p2

    g = torch.Generator().manual_seed(1)
    planes, gemm_args = p2_inputs(g, dev, 3, 10, 10)
    want = p2.down_concat_gemm_plain(planes, *gemm_args, z=4)
    try:
        got = p2_gemm(lib, planes, *gemm_args)
        torch.cuda.synchronize()
        compare(f"{name} [3,20,20,4]", got, want, KSTAGE0_TOL)
        return True
    except (AssertionError, RuntimeError) as e:
        print(f"  {name}: FAIL {e}", flush=True)
        return False


def p2_inputs(g, dev, b, xo, yo, zc1=256, zc2=128, z=4):
    from agplace_tpu_torch.data.voxels import me_down_align
    from agplace_tpu_torch.sparse import bev_grid as bg

    mask = (torch.rand(b, 2 * xo, 2 * yo, z, generator=g) < 0.3).to(dev)
    planes = [torch.randn(b, xo, yo, zc1, generator=g).to(dev, torch.bfloat16)
              for _ in range(4)]
    wd = (torch.randn(2, 2, zc1, zc2, generator=g) * 0.05).to(
        dev, torch.bfloat16)
    s0, b0 = (torch.rand(zc1, generator=g) + .5).to(dev), \
        (torch.randn(zc1, generator=g) * .1).to(dev)
    sd, bd = (torch.rand(zc2, generator=g) + .5).to(dev), \
        (torch.randn(zc2, generator=g) * .1).to(dev)
    m_out = bg.mask_down(mask, (0, 0), (0, 0), me_down_align(z)[:2])
    return planes, (mask, s0, b0, wd, sd, bd, m_out)


def p2_gemm(lib, planes, mask, s0, b0, wd, sd, bd, m_out):
    from agplace_tpu_torch.ops import probe_down_v2 as p2

    b, xo, yo, zc1 = planes[0].shape
    zc2 = wd.shape[3]
    t = p2.down_concat_tiling(b, xo, yo, zc1, zc2, torch.cuda.
                              get_device_properties(mask.device).
                              multi_processor_count)
    out = torch.empty(b, xo, yo, zc2, dtype=torch.bfloat16,
                      device=mask.device)
    err = lib.agp_down_concat_sm90(
        *[p.data_ptr() for p in planes], mask.data_ptr(), s0.data_ptr(),
        b0.data_ptr(), wd.data_ptr(), sd.data_ptr(), bd.data_ptr(),
        m_out.data_ptr(), out.data_ptr(), mask.shape[-1], m_out.shape[-1],
        *t.args(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"agp_down_concat_sm90: CUDA error {err}")
    return out


def kernel_ms(fn, pattern) -> float:
    """Device ms per call of the kernels of ``fn`` whose names match
    ``pattern`` (the profiler, 50 calls)."""
    from ab_torch_probes import by_kernel, split

    return split(by_kernel(fn), pattern)[0]


def main() -> None:
    from ab_torch_probes import P1_CONV, P2_GEMM
    from chip_smoke import card

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-time", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ablate_torch_probes: needs an NVIDIA GPU")
    name = card()
    print(name, flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    record = {"card": name, "p1_checks": {}, "p1_ms": {}, "p2_ms": {}}
    passing = []
    with torch.inference_mode():
        for v in P1_VARIANTS:
            res = check_p1(v, libs[f"p1_{v}"], dev)
            record["p1_checks"][v] = res
            if all(not isinstance(r, str) for r in res.values()):
                passing.append(v)
        p2_ok = [v for v in P2_VARIANTS
                 if check_p2(f"P2 {v}", libs[f"p2_{v}"], dev)]
        print(f"P1 variants that agree with the plain version: {passing}; "
              f"P2: {p2_ok}", flush=True)
        if a.no_time:
            print(json.dumps(record), flush=True)
            return
        g = torch.Generator().manual_seed(2)
        shapes = [(bsz, xy, zci, zco, inputs(g, dev, bsz, xy, xy, zci, zco))
                  for bsz, xy, zci, zco in SHAPES]
        for v in passing:
            lib = libs[f"p1_{v}"]
            record["p1_ms"][v] = {}
            for chunk in CHUNKS:
                if lib.agp_p1_smem_bytes(chunk) > SMEM_LIMIT:
                    continue
                total = 0.0
                for bsz, xy, zci, zco, (x, mask, w, s, b) in shapes:
                    w2 = w if zci == zco else torch.zeros(
                        3, 3, zco, zco, dtype=w.dtype, device=dev)

                    def both():
                        h = p1_phase(v, lib, x, mask, w, s, b, False, chunk,
                                     2)
                        p1_phase(v, lib, h, mask, w2, s, b, True, chunk, 2)
                    ms = kernel_ms(both, P1_CONV)
                    total += ms
                    print(f"P1 {v:13s} chunk {chunk} [{bsz},{xy},{xy},{zci}]"
                          f"->{zco}: {ms:.4f} ms (both conv phases)",
                          flush=True)
                record["p1_ms"][v][chunk] = total
                print(f"P1 {v:13s} chunk {chunk}: {total:.4f} ms over the "
                      f"four shapes", flush=True)
        for v in p2_ok:
            record["p2_ms"][v] = {}
            for bsz in (32, 128):
                planes, gemm_args = p2_inputs(g, dev, bsz, 64, 64)
                ms = kernel_ms(lambda: p2_gemm(libs[f"p2_{v}"], planes,
                                               *gemm_args), P2_GEMM)
                record["p2_ms"][v][f"b{bsz}"] = ms
                print(f"P2 {v} b{bsz}: {ms:.4f} ms", flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
