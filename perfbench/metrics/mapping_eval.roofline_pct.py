"""mapping_eval.roofline_pct: the least time the card could take for the
pass A + B kernels' work in the traced stretch (the larger of bytes at
3.35 TB/s and float32 operations at 67 TFLOP/s, summed over the calls)
over the device time of the kernels, in percent."""
from bench.common import F32_FLOPS_PER_S, HBM_BYTES_PER_S
from bench.counts import mapping_eval_traffic
from bench.trace import device_seconds


def read(rec, cell):
    t = rec.get("trace")
    if rec["kind"] != "search" or not t:
        return None
    n, sec = device_seconds(t["ops"], "mapping_eval")
    if n == 0 or sec <= 0 or n != len(rec["traced_shapes"]):
        return None
    need = 0.0
    for b, p, rows, cols in rec["traced_shapes"]:
        nbytes, ops = mapping_eval_traffic(b, p, rows * cols, rows * cols,
                                           rec["pred_width"],
                                           rec["n_chips"])
        need += max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)
    return 100.0 * need / sec
