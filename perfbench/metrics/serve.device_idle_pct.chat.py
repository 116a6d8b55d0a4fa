"""serve.device_idle_pct.chat: the share of the traced stretch of a
closed-loop serve window in which no operation ran on the device, in
percent."""
from bench.readers import idle_pct


def read(rec, cell):
    return idle_pct(rec, closed_loop=True)
