"""search.evals_per_s: population evaluations of every GA generation that
finished inside the window, over the window's seconds. Set by the host's
speed more than by the program (PERF.md, section 2), so a per-layer
reading beside the device time per evaluation."""


def read(rec, cell):
    if rec["kind"] != "search":
        return None
    return rec["evals"] / rec["window_s"]
