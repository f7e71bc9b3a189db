"""idle_pct.train: the share of the traced run's unprofiled window in which
the device had no work, in %: one less the device time per optimizer step
(every device operation of a whole profile, summed over the steps it
holds) over the window's time per step.  The step is paced by the host, so
the idle share inside a profile measures the profiler's own host cost, not
the program's."""


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "train" or t is None or not t.units or not rec["units"]:
        return None
    return 100.0 * (1.0 - (t.device_s() / t.units)
                    / (rec["window_s"] / rec["units"]))
