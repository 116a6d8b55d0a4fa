"""Unified cache and dispatch observability for the port's evaluation
stack: :func:`cache_stats` merges

* the host-side execution-graph / cost-table LRUs
  (``timing.cost_cache_stats``) — rebuild misses dominate BO sweeps;
* the timing-path dispatch counters and the CUDA kernels' launch counters
  (``timing.timing_backend_stats``) — which pass-B path actually ran
  (``dense``, ``oracle``, ``mapping_eval[_fused]:cuda`` or ``:plain``);
* the device-resident stacked cost-table buffers
  (``torch_evaluator.device_table_cache_stats``) and their bytes per
  device;
* the process-wide serving counters (``serving.stats``): engine runs,
  iterations, prefill/decode tokens, peak slots and queue depth;
* under ``"spans"``, the summary of the latest span recording
  (``repro_torch.spans.summary()``: per span name its count, host seconds,
  summed counts and intervals on the profiler's clock; empty until
  ``spans.recording()`` has run).

The result is JSON-serialisable.
"""
from __future__ import annotations

from .. import spans
from ..serving import stats as serving_stats
from . import timing, torch_evaluator


def cache_stats() -> dict:
    per_device = torch_evaluator.device_table_resident_bytes()
    return {
        "cost_tables": timing.cost_cache_stats(),
        "timing_backend": timing.timing_backend_stats(),
        "device_tables": torch_evaluator.device_table_cache_stats(),
        "device_resident_bytes": per_device,
        "device_resident_bytes_total": sum(per_device.values()),
        "serving": serving_stats.snapshot(),
        "spans": spans.summary(),
    }
