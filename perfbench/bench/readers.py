"""Arithmetic that several metric readers share."""
from __future__ import annotations

from .common import F32_FLOPS_PER_S
from .counts import model_flops


def idle_pct(rec: dict, closed_loop: bool):
    """The traced stretch's share with no device operation running, in
    percent, for a serve run of the given loop."""
    t = rec.get("trace")
    if rec["kind"] != "serve" or rec["closed_loop"] != closed_loop or not t \
            or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(rec: dict, cell: dict, closed_loop: bool):
    """Model FLOPs of the traced stretch's tokens over its seconds and the
    float32 peak, in percent."""
    t = rec.get("trace")
    if rec["kind"] != "serve" or rec["closed_loop"] != closed_loop or not t \
            or t["window_s"] <= 0 or not rec["traced"]["contexts"]:
        return None
    tr = rec["traced"]
    flops = model_flops(cell["config_data"]["model"], tr["contexts"], tr["heads"])
    return 100.0 * flops / t["window_s"] / F32_FLOPS_PER_S
