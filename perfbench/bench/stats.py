"""Percentiles of a run's samples. A missing answer is an infinite
sample; each reading prints its sample count and how many samples lie
beyond it."""
from __future__ import annotations

import sys

import numpy as np


def percentile(name: str, values, q: float) -> float:
    """The q-th percentile (linear between closest ranks, as numpy's
    default) of every sample, infinite ones included."""
    x = np.sort(np.asarray(values, dtype=np.float64))
    if x.size == 0:
        return float("nan")
    pos = (x.size - 1) * q / 100.0
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    if not np.isfinite(x[hi]):
        v = float("inf")
    else:
        v = float(x[lo] + (x[hi] - x[lo]) * (pos - lo))
    beyond = int((x > v).sum())
    print(f"{name}: p{q:g} of {x.size} samples = {v!r} ({beyond} beyond it, "
          f"{int((~np.isfinite(x)).sum())} missing)", file=sys.stderr)
    return v
