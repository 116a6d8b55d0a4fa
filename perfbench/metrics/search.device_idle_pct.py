"""search.device_idle_pct: the share of the traced stretch of a search
window in which no operation ran on the device, in percent."""


def read(rec, cell):
    t = rec.get("trace")
    if rec["kind"] != "search" or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
