"""fwd_device_ms.embed: device milliseconds per batch, every device
operation of a whole profile summed (kernels, copies, fills) over the
batches it holds."""


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "embed" or t is None or not t.units:
        return None
    return 1e3 * t.device_s() / t.units
