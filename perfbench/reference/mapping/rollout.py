"""A request list rolled out under an iteration-level scheduler into the
per-iteration batches the mapping search prices: the batch part of the
port's ``core/streams.rollout``, over the frozen scheduler copy.

Decode requests attend the prompt plus every token produced so far;
prefill chunks attend their prior context plus the chunk."""
from __future__ import annotations

from .scheduler import ServeRequest, get_scheduler, plan_rollout
from .workload import DECODE, PREFILL, Request


def rollout_batches(requests, scheduler: str, max_slots: int,
                    max_iters: int) -> "list[list[Request]]":
    """``requests``: dicts with ``prompt_len``, ``max_new_tokens``,
    ``arrival_iter`` and ``warm_context`` (0 for a cold request)."""
    serve = []
    for i, s in enumerate(requests):
        if s["warm_context"] > 0:
            serve.append(ServeRequest(i, [0] * s["warm_context"], s["max_new_tokens"],
                                      prefilled=s["warm_context"],
                                      arrived_iter=s["arrival_iter"]))
        else:
            serve.append(ServeRequest(i, [0] * max(s["prompt_len"], 1),
                                      s["max_new_tokens"],
                                      arrived_iter=s["arrival_iter"]))
    batches = []
    for _, plan in plan_rollout(serve, get_scheduler(scheduler), max_slots, max_iters):
        batch = [Request(PREFILL, n, req.prefilled + n) for req, n in plan.prefill]
        batch += [Request(DECODE, 1, r.prefilled + len(r.generated)) for r in plan.decode]
        batches.append(batch)
    return batches
