"""setup_s: seconds from the process's start to the window's: imports,
the device, weights or graphs, every kernel built and every shape warmed
(in a checkout's first run, the kernels' compilation too)."""


def read(rec, cell):
    return rec["setup_s"]
