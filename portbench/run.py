"""Run one cell of the benchmark once and print its result as the last line.

    python portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (imports, the kernels' build on a checkout's first run, the seeded
weights and inputs, every shape the cell uses warmed up) runs from process
start to the first timed unit and is ``setup_s``.  Then the window runs
for ``--seconds``.  ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` runs the same window unprofiled, then profiles short steady
sub-windows until one is whole, and reports the per-layer metrics.  After
the window, the program's state is freed and the plain reference
recomputes a sample of what the window produced; ``correct`` says whether
every number compared is within its limit, and those numbers come last, on
standard error and in the result's line.  Exits non-zero, with no result,
without the cards the cell asks for or with JAX loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "agplace_tpu")
PROFILE_TRIES = 8


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or its package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc build sits in agplace_tpu_torch/_build)."""
    base = os.path.join(ROOT, "portbench", "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


def device_of(session, chips: int) -> dict:
    import torch

    if session.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(args, device=None, extra=None, cell=None) -> dict:
    """One run of a cell; returns the result's dict.  ``device`` None takes
    the card (the benchmark's own runs); the tests pass "cpu", a tiny
    configuration (``extra``, dotted keys of the program's config) and a
    cell whose traffic they cut to size."""
    from portbench.harness import cell as cells
    from portbench.harness import profiling

    cell = cell or cells.load(args.workload)
    chips = int(cell.entry["chips"])
    if device is None:
        import torch

        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < chips):
            raise SystemExit(f"portbench: {args.workload} needs {chips} "
                             f"CUDA device(s); torch sees "
                             f"{torch.cuda.device_count()}")
        device = "cuda"
    session = cell.mix_module().Session(cell, args.seed, device, extra)
    session.setup()
    w = session.window(args.seconds)
    setup_s = w.start - T0
    trace = None
    if args.trace == 0:
        specs = cell.end_to_end
        names = {m["name"] for m in specs}
        metrics = {k: v for k, v in dict(session.end_to_end(w),
                                         setup_s=setup_s).items()
                   if k in names}
    else:
        specs = cell.per_layer
        trace, seen = profiling.first_whole(
            lambda n: _units(session, n),
            int(cell.params.get("profile_units", 3)), session.counters,
            session.expect, PROFILE_TRIES)
        if trace is None:
            print(f"portbench: no whole profile in {PROFILE_TRIES} tries "
                  f"(device events recorded: {seen})", file=sys.stderr)
        rec = session.layer_record(w, trace)
        metrics = {}
        for m in specs:
            v = cells.metric_reader(m["name"]).read(rec)
            if v is not None:
                metrics[m["name"]] = v
    dev = device_of(session, chips)
    if trace is not None:
        dev.update(busy_s=trace.busy_s(), window_s=trace.window_s)
    attempted, failed = session.attempted_failed(w)
    numbers = session.check(w)
    limits = cell.limits
    unit = {m["name"]: m["unit"] for m in specs}
    out = {"correct": failed == 0 and all(
               v == v and v <= limits[k] for k, v in numbers.items()),
           "attempted": attempted, "failed": failed,
           "metrics": {k: {"value": v, "unit": unit[k]}
                       for k, v in metrics.items()},
           "device": dev}
    if trace is not None:
        out["breakdown"] = profiling.breakdown(trace)
    out["checked"] = {k: {"value": v, "limit": limits[k]}
                      for k, v in numbers.items()}
    return out


def _units(session, n: int):
    """``n`` units back to back in the mix's closed loop (a profiled
    sub-window)."""
    from portbench.harness.window import closed_loop

    closed_loop(session.dispatch, int(session.p["depth"]), 0.0,
                first_index=0, max_units=n)


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    out = run(args)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or its package was loaded: {found}",
              file=sys.stderr)
        return 3
    for k, v in out["checked"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
