#!/usr/bin/env python
"""K1's cluster size and row tile on one NVIDIA GPU: which design ships.

    python3 scripts/ablate_torch_ode.py

Builds ``agplace_tpu_torch/csrc/ode_step.cu`` once per variant with the
kernel's ``AGP_ODE_CLUSTER`` (blocks per cluster: 2, 4, 8 or 16; each block
holds W's D / CLUSTER columns), ``AGP_ODE_ROWS`` (rows of x per cluster)
and ``AGP_ODE_SPLIT`` (threads per output, each summing D / SPLIT of the k
range: 1, 2 or 4) switches (``-D``): every (cluster, rows, split) whose
block has at most 1024 threads ((256 / CLUSTER) x ROWS x SPLIT) and whose
warps hold 32 / SPLIT of a block's columns.  It times each on the FCODE
shapes of the MM forward:
x [B, 256] fp32, W [256, 256], 10 Euler steps, relu, at B = 32 and 128.
Each variant is first held to ``euler_ode_plain`` (``chip_smoke.K1_TOL``);
a variant the card refuses to launch (a cluster of 16 needs the
non-portable size) is reported as such.  Each variant's time is its
kernel's device time per call by ``torch.profiler``
(``chip_smoke.device_ms``, mean of 50 calls; a launch of 0.02 ms is as
short as the host's enqueue of one, so CUDA events around queued calls
would time the host), beside the median of 20 runs of 10 calls queued
between two CUDA events.  The
variants are built with ``ops/_build``'s nvcc flags, all at once, into
``agplace_tpu_torch/_build/ablation/`` (git-ignored).  Prints one line per
variant and batch, then one JSON line with every time.
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
VARIANTS = [(c, r, sp) for sp in (4, 2, 1) for c in (2, 4, 8, 16)
            for r in (4, 8, 16)
            if 256 // c * r * sp <= 1024 and (256 // c) % (32 // sp) == 0]
BATCHES = (32, 128)


def build_variants():
    """One shared library per (cluster, rows, split), all nvcc runs started
    together."""
    from agplace_tpu_torch.ops import _build

    os.makedirs(OUT, exist_ok=True)
    sos = {v: os.path.join(OUT, "ode_c{}_r{}_k{}.so".format(*v))
           for v in VARIANTS}
    _build.run_all([_build.nvcc_cmd(
        "-shared", f"-DAGP_ODE_CLUSTER={c}", f"-DAGP_ODE_ROWS={r}",
        f"-DAGP_ODE_SPLIT={sp}", "-o", sos[(c, r, sp)],
        os.path.join(_build.SRC_DIR, "ode_step.cu"))
        for c, r, sp in VARIANTS])
    libs = {}
    for v, so in sos.items():
        lib = ctypes.CDLL(so)
        lib.agp_ode_euler.argtypes = _build._SIGNATURES["agp_ode_euler"]
        libs[v] = lib
    return libs


def main() -> None:
    from chip_smoke import K1_TOL, card, compare, device_ms, queued_ms
    from agplace_tpu_torch.ops import ode_step

    if not torch.cuda.is_available():
        raise SystemExit("ablate_torch_ode: needs an NVIDIA GPU")
    name = card()
    print(name, flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    w = (torch.randn(256, 256, generator=g) / 16).to(dev)
    b = (torch.randn(256, generator=g) * 0.1).to(dev)
    record = {"card": name, "ms": {}}
    shipped = (ode_step.CLUSTER, ode_step.ROWS, 2)
    for bsz in BATCHES:
        x = torch.randn(bsz, 256, generator=g).to(dev)
        out = torch.empty_like(x)
        want = ode_step.euler_ode_plain(x, w, b, 10, 0.1, "relu")
        for (c, r, sp), lib in libs.items():
            tiles = -(-bsz // r)
            t = ode_step.OdeTiling(256, True, r, c, tiles, tiles * c)

            def run():
                err = lib.agp_ode_euler(x.data_ptr(), w.data_ptr(),
                                        b.data_ptr(), out.data_ptr(), bsz,
                                        10, 0.1, 0, *t.args(), stream)
                if err != 0:
                    raise RuntimeError(f"CUDA error {err}")
            label = f"b{bsz} cluster {c} rows {r} split {sp}"
            key = f"b{bsz}_c{c}_r{r}_k{sp}"
            try:
                run()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"{label}: not launched ({e})", flush=True)
                record["ms"][key] = None
                continue
            compare(label, out, want, K1_TOL)
            dms, qms = device_ms(run), queued_ms(run)
            record["ms"][key] = dms
            record["ms"][key + "_queued"] = qms
            print(f"{label}: {dms:.4f} ms device ({qms:.4f} ms queued)"
                  f"{' (shipped)' if (c, r, sp) == shipped else ''}",
                  flush=True)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
