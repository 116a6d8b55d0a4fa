"""Iteration-level serving schedulers (the DSE layer's rollout policies)."""
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
