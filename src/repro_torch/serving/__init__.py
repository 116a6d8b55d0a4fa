"""Serving: the iteration-level schedulers (the DSE layer's rollout
policies), the stepped serving engine over the port's model stack, and the
async paged service (its clocks, block allocator and paged KV pools)."""
from .scheduler import (  # noqa: F401
    SCHEDULERS,
    ChunkedPrefillScheduler,
    IterationPlan,
    OrcaScheduler,
    Scheduler,
    ServeRequest,
    VLLMScheduler,
    get_scheduler,
    plan_rollout,
)

# The engine and the service pull in the model stack; the DSE layer only
# needs the schedulers (and the core package imports them while it
# initialises), so the heavy modules are loaded on first access (PEP 562).
_ENGINE_EXPORTS = ("ServingEngine", "summarize", "IterationStats",
                   "RunResult")
_SERVICE_EXPORTS = ("AsyncLLMService", "ServiceConfig", "ServiceResult",
                    "golden_parity_stream", "service_requests")
_CLOCK_EXPORTS = ("IterationClock", "WallClock")
_CACHE_EXPORTS = ("BlockAllocator", "PagedKVCache", "TransferBufferPool")


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from . import engine

        return getattr(engine, name)
    if name in _SERVICE_EXPORTS:
        from . import service

        return getattr(service, name)
    if name in _CLOCK_EXPORTS:
        from . import clock

        return getattr(clock, name)
    if name in _CACHE_EXPORTS:
        from . import paged_cache

        return getattr(paged_cache, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
