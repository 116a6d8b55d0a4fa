"""search.evaluator_device_ms_per_gen: device milliseconds per GA
generation in the traced stretch (every device operation of a search is
the population evaluator's: its structural, cost and pass A + B work)."""


def read(rec, cell):
    t = rec.get("trace")
    if rec["kind"] != "search" or not t or rec["traced_calls"] == 0:
        return None
    return 1e3 * t["busy_s"] / rec["traced_calls"]
