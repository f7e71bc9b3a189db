"""idle_pct.embed: the share of a whole profile's sub-window in which no
device operation ran (the union of their intervals), in %."""


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "embed" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
