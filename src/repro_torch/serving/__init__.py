"""Serving: the iteration-level schedulers (the DSE layer's rollout
policies) and the stepped serving engine over the port's model stack."""
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

# The engine pulls in the model stack; the DSE layer only needs the
# schedulers (and the core package imports them while it initialises), so
# the engine is loaded on first access (PEP 562).
_ENGINE_EXPORTS = ("ServingEngine", "summarize", "IterationStats",
                   "RunResult")


def __getattr__(name):
    if name in _ENGINE_EXPORTS:
        from . import engine

        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
