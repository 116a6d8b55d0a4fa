"""serve.mfu_pct.chat: the model FLOPs of every token the service
processed in the traced stretch (2 per weight the token uses, the
attention at its context, the head where logits were taken) over the
stretch's seconds and the card's float32 peak (67 TFLOP/s), in percent."""
from bench.readers import mfu_pct


def read(rec, cell):
    return mfu_pct(rec, cell, closed_loop=True)
