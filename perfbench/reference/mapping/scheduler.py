"""Frozen copy of the port's ``serving/scheduler.py`` (pure Python and numpy), kept
beside the benchmark so that the reference rebuilds what the port derives
(rollouts, execution graphs, cost tables) with code that later changes to
the port cannot move. The original docstring follows.

Iteration-level serving schedulers (paper §II, §VI-F, Fig. 9).

All three SOTA batch-composition policies over one request queue:

* ``VLLMScheduler``    — separated: an arriving prefill pauses decodes and
                         runs as a standalone batch;
* ``OrcaScheduler``    — mixed: arriving prefills are co-batched with the
                         running decodes in the same iteration;
* ``ChunkedPrefillScheduler`` — prefills are split into fixed-size chunks,
                         each co-scheduled with the running decodes.

The scheduler decides *composition*; an engine executes it. In this
package the policy objects drive ``plan_rollout`` — a *pure* rollout (no
engine, no computation) that replays the admission / slot / retirement
bookkeeping over synthetic tokens. ``repro_torch.core.streams`` uses it to turn a
  ``RequestStream`` into the per-iteration DSE batches Compass searches
  over, so a searched design is evaluated under exactly the policy it
  will be served with.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ServeRequest:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = field(default_factory=list)
    prefilled: int = 0          # tokens of prompt already processed
    slot: int | None = None     # engine cache slot once admitted
    arrived_iter: int = 0
    first_token_iter: int | None = None
    done_iter: int | None = None

    @property
    def prefill_done(self) -> bool:
        return self.prefilled >= len(self.prompt)

    @property
    def finished(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclass
class IterationPlan:
    """What the engine should run this iteration."""
    prefill: list[tuple[ServeRequest, int]]  # (request, chunk_len)
    decode: list[ServeRequest]


class Scheduler:
    name = "base"

    def plan(self, waiting: list[ServeRequest], running: list[ServeRequest],
             free_slots: int) -> IterationPlan:
        raise NotImplementedError


class VLLMScheduler(Scheduler):
    name = "vllm"

    def plan(self, waiting, running, free_slots):
        if waiting and free_slots > 0:
            req = waiting[0]
            return IterationPlan(
                prefill=[(req, len(req.prompt) - req.prefilled)], decode=[])
        return IterationPlan(prefill=[], decode=list(running))


class OrcaScheduler(Scheduler):
    name = "orca"

    def plan(self, waiting, running, free_slots):
        prefill = []
        if waiting and free_slots > 0:
            req = waiting[0]
            prefill = [(req, len(req.prompt) - req.prefilled)]
        return IterationPlan(prefill=prefill, decode=list(running))


class ChunkedPrefillScheduler(Scheduler):
    name = "chunked_prefill"

    def __init__(self, chunk: int = 512):
        self.chunk = chunk

    def plan(self, waiting, running, free_slots):
        prefill = []
        # continue a partially-prefilled request first
        partial = [r for r in waiting if 0 < r.prefilled < len(r.prompt)]
        cand = partial[0] if partial else (
            waiting[0] if waiting and free_slots > 0 else None)
        if cand is not None:
            remaining = len(cand.prompt) - cand.prefilled
            prefill = [(cand, min(self.chunk, remaining))]
        return IterationPlan(prefill=prefill, decode=list(running))


SCHEDULERS = {
    "vllm": VLLMScheduler,
    "orca": OrcaScheduler,
    "chunked_prefill": ChunkedPrefillScheduler,
}


def get_scheduler(sched: Scheduler | str) -> Scheduler:
    """Resolve a scheduler name (``SCHEDULERS`` key) or pass an instance
    through."""
    if isinstance(sched, Scheduler):
        return sched
    try:
        return SCHEDULERS[sched]()
    except KeyError:
        raise ValueError(
            f"unknown scheduler {sched!r}; choose from {sorted(SCHEDULERS)} "
            "or pass a Scheduler instance") from None


# --------------------------------------------------------------------------
# Shared scheduling-state transitions
#
# The engine's run loop and the pure rollout must agree exactly on
# admission, slot assignment, prefill completion and retirement — both call
# these helpers, so parity is structural rather than re-implemented.
# --------------------------------------------------------------------------


def try_admit(req: ServeRequest, free_slots: list[int]) -> bool:
    """Assign a cache slot if the request has none; False when full."""
    if req.slot is None:
        if not free_slots:
            return False
        req.slot = free_slots.pop()
    return True


def admit_arrivals(pending: list[ServeRequest], waiting: list[ServeRequest],
                   running: list[ServeRequest], free_slots: list[int],
                   it: int, admit=None) -> None:
    """Move requests whose ``arrived_iter`` has come into the scheduler's
    view. Cold requests join the waiting queue; warm (already-prefilled,
    decode-resident) requests go straight to running and take a slot — if
    none is free the warm arrival is retried next iteration, and warm
    arrivals behind it stay queued in FIFO order behind the blocked head.

    Cold arrivals are NOT held behind a slot-blocked warm head: they only
    need the slot-free ``waiting`` queue, so they pass it (the old ``break``
    stalled them head-of-line, delaying their arrival into the scheduler's
    view — and therefore their first prefill — for no resource reason).

    ``admit`` overrides the slot-assignment step (default
    :func:`try_admit`) so consumers with richer admission state — the
    async service reserves KV blocks and prefaults warm context — keep the
    loop's structure (and its engine/planner/service parity) intact.
    """
    admit = try_admit if admit is None else admit
    i = 0
    warm_blocked = False
    while i < len(pending) and pending[i].arrived_iter <= it:
        r = pending[i]
        if not r.prefill_done:
            waiting.append(pending.pop(i))
        elif not warm_blocked and admit(r, free_slots):
            running.append(pending.pop(i))
        else:
            warm_blocked = True
            i += 1


def complete_prefill(req: ServeRequest, it: int, waiting: list[ServeRequest],
                     running: list[ServeRequest]) -> None:
    req.first_token_iter = it
    waiting.remove(req)
    running.append(req)


def retire_finished(running: list[ServeRequest], finished: list[ServeRequest],
                    free_slots: list[int], it: int) -> None:
    for r in list(running):
        if r.finished:
            r.done_iter = it
            running.remove(r)
            finished.append(r)
            if r.slot is not None:
                free_slots.append(r.slot)
                r.slot = None


# --------------------------------------------------------------------------
# Pure plan-rollout (no engine)
# --------------------------------------------------------------------------


def plan_rollout(requests: list[ServeRequest], scheduler: Scheduler,
                 max_slots: int, max_iters: int = 100_000):
    """Drive ``scheduler.plan`` over a request set with the engine's exact
    bookkeeping but no computation — generated tokens are placeholders.

    Yields ``(it, plan)`` for every *non-empty* iteration, with the plan's
    prefill entries already admission-filtered; request state (``prefilled``
    / ``generated`` / ``first_token_iter`` / ``done_iter``) is advanced
    after the consumer resumes, so at yield time each request still shows
    its pre-iteration state. Idle gaps before future arrivals are skipped
    in O(1).

    ``max_slots`` must be >= 1: with zero slots nothing can ever be
    admitted, so the loop would spin empty iterations to ``max_iters`` and
    return a silently truncated (empty) rollout — that is a configuration
    error, raised loudly here. A rollout that legitimately runs out of
    ``max_iters`` with work in flight is reported by the consumer
    (``StreamRollout.truncated``), not hidden.
    """
    if max_slots < 1:
        raise ValueError(f"max_slots must be >= 1, got {max_slots}: with "
                         "no slots nothing can be admitted and the rollout "
                         "would silently truncate at max_iters")
    pending = sorted(requests, key=lambda r: r.arrived_iter)
    waiting: list[ServeRequest] = []
    running: list[ServeRequest] = []
    finished: list[ServeRequest] = []
    free = list(range(max_slots))
    it = 0
    while (pending or waiting or running) and it < max_iters:
        admit_arrivals(pending, waiting, running, free, it)
        plan = scheduler.plan(waiting, running, len(free))
        prefill = [(req, n) for req, n in plan.prefill
                   if try_admit(req, free)]
        plan = IterationPlan(prefill=prefill, decode=list(plan.decode))

        if not plan.prefill and not plan.decode:
            if not waiting and not running and pending:
                it = pending[0].arrived_iter  # fast-forward the idle gap
                continue
            it += 1
            continue

        yield it, plan

        for req, chunk_len in plan.prefill:
            req.prefilled += chunk_len
            if req.prefill_done:
                req.generated.append(0)
                complete_prefill(req, it, waiting, running)
        for r in plan.decode:
            r.generated.append(0)
        retire_finished(running, finished, free, it)
        it += 1
