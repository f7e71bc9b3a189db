"""attn_device_ms.geoloc: device milliseconds per batch under the program's
``geoloc.attn`` spans (each CCT layer's scores, softmax and AV), the
device operations inside their rows of a whole profile summed over the
batches it holds."""


def read(rec):
    t, spent = rec["trace"], rec.get("span_device_s") or {}
    if rec["kind"] != "embed" or t is None or not spent.get("geoloc.attn"):
        return None
    return 1e3 * spent["geoloc.attn"] / t.units
