"""step_device_ms.train: device milliseconds per optimizer step, every
device operation of a whole profile summed over the steps it holds."""


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "train" or t is None or not t.units:
        return None
    return 1e3 * t.device_s() / t.units
