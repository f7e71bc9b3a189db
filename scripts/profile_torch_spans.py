#!/usr/bin/env python
"""The port's spans (``agplace_tpu_torch/utils/spans.py``) read in the
benchmark's cells, on one NVIDIA GPU.

    python3 scripts/profile_torch_spans.py [--cells kitti360-embed-b128 ...]
        [--seconds 10] [--repeats 3] [--seed 3910000001] [--out DIR]

For each cell of ``BENCHMARK.json`` it builds the benchmark's session
(``portbench/mixes/``: the cell's seeded weights and inputs, set-up and
warm-up as in ``portbench/run.py``), then:

* the spans' cost: ``--repeats`` rounds of four unprofiled windows of
  ``--seconds``, spans off, on, on, off; each window's end-to-end rate,
  the median of the host's time around each call into the entry (what
  ``host_enqueue_ms.embed`` reads), and with spans on the median ms of
  each span and its calls a unit, from ``spans.drain()``;
* a profile of ``profile_units`` units with spans on, taken as the
  benchmark takes its traced runs' (``profiling.first_whole``), the
  fullest of ``FULLEST_OF`` such whole profiles (the profiler drops device
  events and never adds one, and the whole-profile check vouches for the
  hand kernels only): the device ms a unit charged to each span (each
  device operation to the innermost span's device row that holds it; the
  backward's kernels, which the autograd engine's thread launches, lie
  under no row), each span's host ms and rows, the waits for the device
  by span and op, the benchmark's breakdown, the steady window's idle time
  by the gaps' length, and its ten longest idle gaps, each with the
  innermost span and host op at its middle and, for a gap outside every
  span, the host ops it overlaps;
* the same profile with spans off, for its device total.

Each cell runs in a process of its own, as the benchmark runs it.  Its
result is written to ``{out}/{cell}.json``, and one summary line is
printed, after the card's name and power limit.  The script stands in for
the benchmark's span metrics until the benchmark reads the spans itself.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from agplace_tpu_torch.utils import spans  # noqa: E402

CELLS = ("kitti360-embed-b128", "nuscenes-embed-b128",
         "kitti360-train-16x12", "kitti360-gallery-b512")
PROFILE_TRIES = 8  # as portbench/run.py
FULLEST_OF = 3  # whole profiles taken; the one with most device events kept
# host calls that wait for the device
WAITS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
# idle gaps by length, us (upper bounds)
GAP_CLASSES = {"<5us": 5.0, "5-50us": 50.0, "50-500us": 500.0,
               ">=500us": float("inf")}
SPAN_CALLS = 20000  # calls of the span cost's loop

# (name, start, end) in us on the profiler's clock: a device operation, a
# span's device row, a host event (portbench's ``Trace`` rows)
Row = Tuple[str, float, float]


def split(trace) -> List[Row]:
    """Move the spans' device rows out of ``trace.device`` (portbench's
    ``Trace``) and return them: a row spans the kernels launched inside
    its span, so counted as device work it would double the device time."""
    rows = [d for d in trace.device if d[0] in spans.NAMES]
    trace.device = [d for d in trace.device if d[0] not in spans.NAMES]
    return rows


def _innermost(intervals: Sequence[Row], s: float, e: float
               ) -> Optional[str]:
    best = None
    for name, a, b in intervals:
        if a <= s and e <= b and (best is None or b - a < best[1]):
            best = (name, b - a)
    return best[0] if best else None


def _opened(host: Sequence[Row]) -> List[Row]:
    return [h for h in host if h[0] in spans.NAMES]


def charge(ops: Sequence[Row], rows: Sequence[Row]
           ) -> Dict[Optional[str], float]:
    """Device seconds by the innermost span row that holds each operation
    (None: under no row); the values add up to the operations' sum."""
    out: Dict[Optional[str], float] = defaultdict(float)
    for _, s, e in ops:
        out[_innermost(rows, s, e)] += (e - s) / 1e6
    return dict(out)


def gaps(trace, n: int = 10) -> List[dict]:
    """The ``n`` longest idle gaps of ``trace`` (steady window): each gap's
    ms, the innermost span and host op at its middle, and for a gap under
    no span the host ops that overlap it."""
    opened = _opened(trace.host)
    out = []
    for s, e in sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) / 2
        g = {"ms": (e - s) / 1e3, "span": _innermost(opened, mid, mid),
             "host_op": trace.host_op_at(mid)}
        if g["span"] is None:
            g["host_ops"] = sorted({nm for nm, a, b in trace.host
                                    if a < e and b > s
                                    and nm not in spans.NAMES})[:12]
        out.append(g)
    return out


def waits_ms(host: Sequence[Row], units: int) -> Dict[str, float]:
    """Host ms a unit in calls that wait for the device, by the span and
    the innermost op around each call ("<span> <op>")."""
    opened = _opened(host)
    ops = [h for h in host
           if h[0] not in spans.NAMES and not h[0].startswith("cuda")]
    out: Dict[str, float] = defaultdict(float)
    for n, s, e in host:
        if n in WAITS:
            key = f"{_innermost(opened, s, s)} {_innermost(ops, s, e)}"
            out[key] += (e - s) / 1e3 / units
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_by_length(trace) -> Dict[str, list]:
    """Idle ms and the number of gaps in the steady window, by the gap's
    length."""
    out = {k: [0.0, 0] for k in GAP_CLASSES}
    for s, e in trace.idle_gaps():
        for k, hi in GAP_CLASSES.items():
            if e - s < hi:
                out[k][0] += (e - s) / 1e3
                out[k][1] += 1
                break
    return out


def span_cost_us() -> Dict[str, float]:
    """Host us of one ``with span(...)`` off and on (no profiler)."""
    was = spans.enabled()
    out = {}
    for on in (False, True):
        spans.enable(on)
        t = time.perf_counter()
        for _ in range(SPAN_CALLS):
            with spans.span("mm.image"):
                pass
        out["on" if on else "off"] = (
            1e6 * (time.perf_counter() - t) / SPAN_CALLS)
    spans.enable(was)
    spans.drain()
    return out


def _per_unit_ms(drained, units: int) -> Dict[str, dict]:
    """The median ms of each span over its calls, and the calls a unit."""
    by = defaultdict(list)
    for r in drained.records:
        by[r.name].append((r.t1_ns - r.t0_ns) / 1e6)
    return {n: {"median_ms": statistics.median(v),
                "calls_per_unit": len(v) / units}
            for n, v in sorted(by.items())}


def windows(session, seconds: float, repeats: int) -> List[dict]:
    """Rounds of unprofiled windows: spans off, on, on, off."""
    out = []
    for _ in range(repeats):
        for on in (False, True, True, False):
            spans.drain()
            spans.enable(on)
            w = session.window(seconds)
            spans.enable(False)
            d = spans.drain()
            rec = {"spans": on, "units": len(w.units),
                   "seconds": w.seconds, **session.end_to_end(w),
                   "enqueue_ms": 1e3 * statistics.median(session.enqueued)}
            if on:
                rec["span_ms"] = _per_unit_ms(d, len(w.units))
                rec["dropped"] = d.dropped
            out.append(rec)
    return out


def fullest(session, units: int, on: bool):
    """The whole profile, spans ``on``, with the most device events of
    ``FULLEST_OF``, its span rows split off: (Trace, rows), or None."""
    from portbench.harness import profiling
    from portbench.run import _units

    best = None
    for _ in range(FULLEST_OF):
        spans.enable(on)
        t, _ = profiling.first_whole(lambda n: _units(session, n), units,
                                     session.counters, session.expect,
                                     PROFILE_TRIES)
        spans.enable(False)
        spans.drain()
        if t is not None:
            rows = split(t)
            if best is None or len(t.device) > len(best[0].device):
                best = (t, rows)
    return best


def measure(name: str, seed: int, seconds: float, repeats: int) -> dict:
    import torch

    from portbench.harness import cell as cells
    from portbench.harness import profiling

    cell = cells.load(name)
    session = cell.mix_module().Session(cell, seed, "cuda")
    t0 = time.perf_counter()
    session.setup()
    out = {"cell": name, "seed": seed, "setup_s": time.perf_counter() - t0,
           "span_cost_us": span_cost_us(),
           "windows": windows(session, seconds, repeats)}
    units = int(cell.params.get("profile_units", 3))
    got = fullest(session, units, True)
    if got is None:
        out["profile"] = None
    else:
        t, rows = got
        host_ms = defaultdict(list)
        for n, s, e in _opened(t.host):
            host_ms[n].append((e - s) / 1e3)
        out["profile"] = {
            "units": units, "device_events": len(t.device),
            "device_ms": 1e3 * t.device_s() / units,
            "rows_ms": sum(e - s for _, s, e in rows) / 1e3 / units,
            "charged_ms": {str(k): 1e3 * v / units for k, v in
                           sorted(charge(t.device, rows).items(),
                                  key=lambda kv: -kv[1])},
            "span_rows": {n: sum(1 for h in t.host if h[0] == n)
                          for n in sorted(spans.NAMES)},
            "device_rows": len(rows),
            "host_ms": {n: statistics.median(v)
                        for n, v in sorted(host_ms.items())},
            "waits_ms": waits_ms(t.host, units),
            "idle_by_length": idle_by_length(t),
            "idle_pct": 100.0 * (1 - t.busy_s() / t.window_s),
            "window_ms": 1e3 * t.window_s,
            "breakdown": profiling.breakdown(t),
            "gaps": gaps(t)}
    off = fullest(session, units, False)
    out["profile_off"] = None if off is None else {
        "device_events": len(off[0].device),
        "device_ms": 1e3 * off[0].device_s() / units}
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    session.free()
    return out


def summary(r: dict) -> str:
    enq = {on: statistics.median([x["enqueue_ms"] for x in r["windows"]
                                  if x["spans"] == on] or [float("nan")])
           for on in (0, 1)}
    p = r["profile"] or {}
    off = r["profile_off"] or {}
    ch = p.get("charged_ms", {})
    return (f"{r['cell']}: enqueue ms off {enq[0]:.3f} on {enq[1]:.3f}; "
            f"device ms {p.get('device_ms', float('nan')):.3f} "
            f"({p.get('device_events')} events; spans off "
            f"{off.get('device_ms', float('nan')):.3f}) = "
            + " + ".join(f"{k} {v:.3f}" for k, v in ch.items())
            + f"; idle {p.get('idle_pct', float('nan')):.2f} %")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=3910000001)
    ap.add_argument("--out", default=os.path.join(ROOT, "_runs", "spans"))
    args = ap.parse_args(argv)
    if len(args.cells) > 1:
        # a process a cell, as the benchmark runs it
        rc = 0
        for k, name in enumerate(args.cells):
            rc |= subprocess.call([
                sys.executable, os.path.abspath(__file__), "--cells", name,
                "--seconds", str(args.seconds), "--repeats",
                str(args.repeats), "--seed", str(args.seed + k),
                "--out", args.out])
        return rc
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
        ROOT, "portbench", "_cache", "torch_extensions"))
    import torch

    from chip_smoke import card

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_spans: no CUDA device")
    print(card(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    (name,) = args.cells
    r = measure(name, args.seed, args.seconds, args.repeats)
    with open(os.path.join(args.out, name + ".json"), "w") as f:
        json.dump(r, f, indent=1)
    print(summary(r), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
