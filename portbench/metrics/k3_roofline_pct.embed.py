"""k3_roofline_pct.embed: K3's whole ECA blocks (both conv phases, ECA,
combine) at the cell's shapes, their roofline bound over their device time
in a whole profile, in %."""

from portbench.harness.profiling import k_of


def read(rec):
    t, work = rec["trace"], rec["hand_work"]
    if rec["kind"] != "embed" or t is None or not work.get("K3"):
        return None
    spent = t.seconds_by(k_of).get("K3", 0.0)
    if spent <= 0:
        return None
    return 100.0 * t.units * sum(w.bound_s for w in work["K3"]) / spent
