"""attn_roofline_pct.geoloc: the attention core's roofline bound (each
layer's 4 B h N^2 d FLOPs at the configuration's peak, or q, k and v read
and the output written once at the memory rate, the larger;
``harness.geoloc.attention_core_work``) over the device time under the
program's ``geoloc.attn`` spans in a whole profile, in %."""


def read(rec):
    t, spent = rec["trace"], rec.get("span_device_s") or {}
    if rec["kind"] != "embed" or t is None or not spent.get("geoloc.attn"):
        return None
    return 100.0 * t.units * rec["attn_bound_s"] / spent["geoloc.attn"]
