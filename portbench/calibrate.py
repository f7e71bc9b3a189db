"""Read the two ends of each limit of a cell's comparison, on the card.

    python portbench/calibrate.py --workload <name> --seeds <n> [<n> ...]
        [--seconds 2] [--out chiprun_out/calib]

For each seed, in one process: the cell's set-up and a short window at
its own load, then the numbers the benchmark compares (the program
against the reference: the lower readings), the control's (the reference
computed one precision step below what the configuration states, put in
the program's place: the upper readings), and for a training cell its
faults (the reference stepped on half of the batch; a state left
unchanged reads 1 on ``step_gap`` by construction).  One JSON line per
seed on standard output and in ``<out>/<workload>.jsonl``.  The
benchmark's own runs never run this.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, seconds: float, device="cuda",
             extra=None) -> dict:
    from portbench.harness import cell as cells

    t0 = time.perf_counter()
    session = cell.mix_module().Session(cell, seed, device, extra)
    session.setup()
    w = session.window(seconds)
    out = {"seed": seed, "setup_s": time.perf_counter() - t0 - w.seconds,
           "units": len(w.units), "program": session.check(w)}
    control = cells.control_precision(session.cfg)
    if session.kind == "embed":
        out["control"] = session.compare(w, control)
    else:
        out["control"] = session.compare(session.reference(control))
        ref = session.reference()
        half = session.reference(half_batch=True)
        out["faults"] = {
            "half_batch": session.compare(ref, half),
            "state_unchanged": session.compare(
                ref, (ref[0], ref[1], session.init))}
        ctrl = session.reference(control)
        out["look"] = {"program": look(session, ref),
                       "control": look(session, ref, ctrl)}
    return out


def look(session, ref, prog=None, top: int = 4) -> dict:
    """Where a training cell's gaps come from: each step's loss gap, and
    the worst leaves of the first gradient's and the change's gaps, split
    into the voxel branch and the rest."""
    import numpy as np

    losses, g_norm, last = prog or (session.losses, session.first_grad,
                                    session.after)
    r_losses, r_g, r_last = ref
    init = session.init
    med_g = float(np.median(list(r_g.values())))
    live = [n for n in r_g if r_g[n] >= 1e-3 * med_g]
    d_prog = {n: float((last[n].to(init[n].device) - init[n]).norm())
              for n in live}
    d_ref = {n: float((r_last[n] - init[n]).norm()) for n in live}
    med_d = float(np.median(list(d_ref.values())))
    grad = {n: abs(g_norm[n] - r_g[n]) / max(r_g[n], med_g) for n in r_g}
    step = {n: abs(d_prog[n] - d_ref[n]) / max(d_ref[n], med_d)
            for n in live}

    voxel_branch = sys.modules[type(session).__module__].voxel_branch

    def worst(gaps):
        out = {}
        for label, keep in (("vox", voxel_branch),
                            ("rest", lambda n: not voxel_branch(n))):
            part = sorted(((v, n) for n, v in gaps.items() if keep(n)),
                          reverse=True)[:top]
            out[label] = [[n, v] for v, n in part]
        return out

    return {"loss_gaps": [abs(a - b) / abs(b)
                          for a, b in zip(losses, r_losses)],
            "grad": worst(grad), "step": worst(step),
            "median_grad": med_g, "median_step": med_d,
            "left_out": sorted(set(r_g) - set(live))}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "calib"))
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.harness import cell as cells

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, args.workload + ".jsonl")
    for seed in args.seeds:
        rec = readings(cells.load(args.workload), seed, args.seconds)
        line = json.dumps(rec)
        print(line, flush=True)
        with open(path, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
