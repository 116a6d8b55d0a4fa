"""search_device_us_per_eval: the device's busy time over the whole
window (the union of its operations' intervals in the trace), over the
population evaluations made while the trace ran, in microseconds."""


def read(rec, cell):
    t = rec.get("trace")
    if rec["kind"] != "search" or not t or rec.get("traced_evals", 0) == 0:
        return None
    return 1e6 * t["busy_s"] / rec["traced_evals"]
