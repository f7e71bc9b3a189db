"""kernels_roofline_pct.embed: the hand-written kernels' roofline bound
(their work at the cell's shapes, ``harness.roofline``) over their device
time in a whole profile, summed over every hand kernel that ran, in %."""

from portbench.harness.profiling import k_of


def read(rec):
    t, work = rec["trace"], rec["hand_work"]
    if rec["kind"] != "embed" or t is None or not work:
        return None
    spent = sum(t.seconds_by(k_of).values())
    if spent <= 0:
        return None
    bound = t.units * sum(w.bound_s for ws in work.values() for w in ws)
    return 100.0 * bound / spent
