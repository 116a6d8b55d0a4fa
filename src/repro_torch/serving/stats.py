"""Process-wide serving counters (pure python).

The async service, the paged allocator and the legacy engine all publish
into this registry so ``repro_torch.core.cache_stats()`` can carry engine
occupancy alongside the evaluation-stack cache metrics — one place to look
when "why is serving slow / fat" comes up. Counters are cumulative per
process; gauges (``peak_*``) are high-water marks. ``reset()`` exists for
tests and benchmark records that want per-run numbers.
"""
from __future__ import annotations

from threading import Lock

_LOCK = Lock()


def _zero() -> dict:
    return {
        # lifecycle
        "services_started": 0,
        "engine_runs": 0,
        "iterations": 0,
        # work
        "prefill_tokens": 0,
        "decode_tokens": 0,
        # paged-cache residency
        "blocks_reserved": 0,
        "blocks_freed": 0,
        "oom_events": 0,
        "blocked_admissions": 0,
        "peak_blocks_used": 0,
        "peak_slots_used": 0,
        "peak_queue_depth": 0,
        # host<->device staging
        "transfer_pool_hits": 0,
        "transfer_pool_misses": 0,
        # compiled entry points (SHARK-style prefill_bs{N}/decode_bs{N})
        "prefill_entrypoints": 0,
        "decode_entrypoints": 0,
        # truncation / fairness
        "truncated_runs": 0,
        "unfinished_requests": 0,
    }


_COUNTERS = _zero()


def bump(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def high_water(name: str, value: int) -> None:
    with _LOCK:
        if value > _COUNTERS.get(name, 0):
            _COUNTERS[name] = value


def snapshot() -> dict:
    with _LOCK:
        return dict(_COUNTERS)


def reset() -> None:
    with _LOCK:
        _COUNTERS.clear()
        _COUNTERS.update(_zero())
