"""mfu.train: the least time of one step's forward and backward FLOPs (the
reference's, counted by FlopCounterMode at the cell's shapes, each
precision group at its published peak) over the measured time per step of
the traced run's unprofiled window, in %."""

from portbench.harness.roofline import least_time_s


def read(rec):
    if rec["kind"] != "train" or not rec["units"]:
        return None
    return 100.0 * least_time_s(rec["flops"]) / (rec["window_s"]
                                                 / rec["units"])
