"""serve.launches_per_iter.chat: device operations (kernels, copies and
fills) the profiler saw in the traced stretch of a closed-loop window, per
decode iteration of the service in it."""


def read(rec, cell):
    t = rec.get("trace")
    if rec["kind"] != "serve" or not rec["closed_loop"] or not t \
            or rec["traced"]["iterations"] == 0:
        return None
    return t["launches"] / rec["traced"]["iterations"]
