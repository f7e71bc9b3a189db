#!/usr/bin/env python
"""Time and peak device memory of the exact L2 search
(``retrieval/knn.l2_topk_blocked``) of two trees of the port, on one
NVIDIA GPU.

    python3 scripts/ab_torch_search.py --root PARENT_DIR

Loads ``agplace_tpu_torch/retrieval/knn.py`` of this checkout and of
``--root`` by path (the module imports only torch and numpy), and runs both
on the same inputs in the order parent, change, change, parent: 1,024
queries (one query block) of 256 fp32 dimensions, k = 20, over galleries of
131,072 and 1,048,576 rows held on the card, all from numpy seed 0.  A
time is the median of 10 calls after one warm-up (CUDA events around the
call, the queries' upload and the results' fetch included); the peak is
``torch.cuda.max_memory_allocated`` over one call above what was allocated
before it.  Also counts the indices on which the trees differ.  Prints one
line per measurement, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import card  # noqa: E402

KNN = os.path.join("agplace_tpu_torch", "retrieval", "knn.py")
GALLERIES = (1 << 17, 1 << 20)
N_QUERIES, DIM, K = 1024, 256, 20


def load(root: str, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(root, KNN))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(knn, q: np.ndarray, gallery: torch.Tensor) -> dict:
    out = knn.l2_topk_blocked(q, gallery, K)
    torch.cuda.synchronize()
    times = []
    for _ in range(10):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        knn.l2_topk_blocked(q, gallery, K)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    knn.l2_topk_blocked(q, gallery, K)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return {"ms": statistics.median(times), "peak_mib": peak / 2 ** 20,
            "out": out}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="the parent tree, unpacked with git archive")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_torch_search: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    name = card()
    print(name, flush=True)
    trees = {"parent": load(os.path.abspath(args.root), "knn_parent"),
             "change": load(ROOT, "knn_change")}
    rng = np.random.default_rng(0)
    q = rng.standard_normal((N_QUERIES, DIM)).astype(np.float32)
    rows = []
    for n in GALLERIES:
        gallery = torch.from_numpy(
            rng.standard_normal((n, DIM)).astype(np.float32)).cuda()
        got = {}
        for label in ("parent", "change", "change", "parent"):
            r = measure(trees[label], q, gallery)
            got.setdefault(label, []).append(r)
            print(f"gallery {n}: {label} {r['ms']:.3f} ms, peak "
                  f"{r['peak_mib']:.1f} MiB", flush=True)
        (d0, i0), (d1, i1) = got["parent"][0]["out"], got["change"][0]["out"]
        row = {"gallery": n, "queries": N_QUERIES, "dim": DIM, "k": K,
               "indices_differ": int((i0 != i1).sum()),
               "max_distance_diff": float(np.abs(d0 - d1).max())}
        for label, rs in got.items():
            row[f"{label}_ms"] = [r["ms"] for r in rs]
            row[f"{label}_peak_mib"] = [r["peak_mib"] for r in rs]
        rows.append(row)
        del gallery
        torch.cuda.empty_cache()
    print(json.dumps({"card": name, "search": rows}), flush=True)


if __name__ == "__main__":
    main()
