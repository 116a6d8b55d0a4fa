"""decode_attention.roofline_pct: the least time the card could take for
the decode-attention calls of the traced stretch (the live K and V rows
read once, at 3.35 TB/s, or the operations at 67 TFLOP/s, whichever is
larger, per layer and step) over the device time of the decode kernels
(the split kernel and its combine kernel), in percent."""
from bench.common import F32_FLOPS_PER_S, HBM_BYTES_PER_S
from bench.counts import decode_attention_traffic
from bench.trace import device_seconds


def read(rec, cell):
    t = rec.get("trace")
    if rec["kind"] != "serve" or not t or not rec["traced"]["decode"]:
        return None
    n, sec = device_seconds(t["ops"], "decode_attention")
    if n == 0 or sec <= 0:
        return None
    m = cell["config_data"]["model"]
    need = 0.0
    for lanes, lengths in rec["traced"]["decode"]:
        nbytes, ops = decode_attention_traffic(m, lengths, lanes)
        need += m["n_layers"] * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S)
    return 100.0 * need / sec
