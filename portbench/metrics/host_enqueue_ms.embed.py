"""host_enqueue_ms.embed: the host's milliseconds per call into the entry
(``embed_queries`` / ``embed_db``), the median over the calls of the traced
run's unprofiled window, by the benchmark's clock around each call."""

import statistics


def read(rec):
    if rec["kind"] != "embed" or not rec["enqueue_s"]:
        return None
    return 1e3 * statistics.median(rec["enqueue_s"])
