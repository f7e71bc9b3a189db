"""encoder_device_ms.geoloc: device milliseconds per batch under the
program's ``geoloc.encoder`` span (CCT's positional add, its layers and its
final LayerNorm), the device operations inside the span's rows of a whole
profile summed over the batches it holds."""


def read(rec):
    t, spent = rec["trace"], rec.get("span_device_s") or {}
    if rec["kind"] != "embed" or t is None or not spent.get(
            "geoloc.encoder"):
        return None
    return 1e3 * spent["geoloc.encoder"] / t.units
