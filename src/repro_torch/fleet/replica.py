"""Replica: one serving instance with its own searched hardware+mapping.

A replica serves one routed sub-stream and returns its schedule and
per-request timings plus the dollar cost of the hardware behind it —
everything the fleet accounting needs. Two modes, mirroring the repo's
sim-to-real split:

* :class:`PlannedReplica` — pure planning: the sub-stream is rolled out
  by ``plan_rollout`` under the replica's scheduler and priced by a
  ``pricer`` (rollout -> per-iteration latency seconds). The pricer is
  where the replica's searched hardware+mapping lives:
  :func:`compass_pricer` runs a full mapping (co-)search per rollout on a
  fixed hardware point — heterogeneous fleets are just replicas with
  different pricers; :func:`unit_pricer` is the deterministic analytic
  stand-in the fleet tests pin bit-identity with.
* :class:`MeasuredReplica` — the real thing: an
  :class:`~repro_torch.serving.service.AsyncLLMService` serves the
  sub-stream's materialised token requests (warm context prefaulted at
  admission) and the measured schedule is priced by its measured
  iteration seconds.

Both return a :class:`ReplicaResult`; ``Fleet`` merges them back into one
request-indexed view. The device work is the pricer's search (the
population evaluator on ``device``) and the service's model calls (on the
service's device); either defaults to CUDA and raises where there is none.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable

import numpy as np

from ..core.streams import RequestStream, RequestTimings, StreamRollout
from ..core.streams import rollout as roll_stream
from ..serving.scheduler import get_scheduler

__all__ = ["ReplicaResult", "Replica", "PlannedReplica", "MeasuredReplica",
           "unit_pricer", "compass_pricer"]


@dataclass
class ReplicaResult:
    """One replica's serve of its sub-stream."""

    replica: str
    rollout: StreamRollout
    timings: RequestTimings
    mc_total: float                   # dollars of hardware behind this serve
    meta: dict = field(default_factory=dict)

    @property
    def truncated(self) -> bool:
        return self.rollout.truncated


class Replica:
    """Interface: ``serve(substream, seed) -> ReplicaResult`` plus the
    hardware dollar cost and a scheduler-swap constructor (the scale-out
    policy search's "change the scheduler" action)."""

    name: str = "replica"
    mc_total: float = 1.0

    def serve(self, substream: RequestStream,
              seed: int | None = None) -> ReplicaResult:
        raise NotImplementedError

    def with_scheduler(self, scheduler) -> "Replica":
        raise NotImplementedError


@dataclass
class PlannedReplica(Replica):
    """Planning-mode replica: ``plan_rollout`` + a latency pricer.

    ``pricer(rollout)`` returns the per-executed-iteration latency vector
    (seconds, shape ``(B,)``) — optionally ``(latencies, meta)`` — for
    the replica's searched hardware+mapping. ``mc_total`` is the dollar
    cost of that hardware; a pricer whose meta carries ``mc_total``
    overrides the static field (the searched point knows its own cost).
    """

    pricer: Callable = None
    scheduler: object = "orca"
    max_slots: int | None = None
    max_iters: int = 512
    mc_total: float = 1.0
    name: str = "planned"

    def with_scheduler(self, scheduler) -> "PlannedReplica":
        return replace(self, scheduler=scheduler)

    def serve(self, substream: RequestStream,
              seed: int | None = None) -> ReplicaResult:
        if self.pricer is None:
            raise ValueError(f"replica {self.name!r} has no pricer")
        ro = roll_stream(substream, get_scheduler(self.scheduler),
                         max_slots=self.max_slots, max_iters=self.max_iters,
                         seed=seed)
        out = self.pricer(ro)
        lat, meta = out if isinstance(out, tuple) else (out, {})
        lat = np.asarray(lat, dtype=float)
        mc = float(meta.get("mc_total", self.mc_total))
        return ReplicaResult(
            replica=self.name, rollout=ro, timings=ro.timings(lat),
            mc_total=mc, meta=dict(meta))


@dataclass
class MeasuredReplica(Replica):
    """Measured-mode replica: a real :class:`AsyncLLMService` serves the
    sub-stream's materialised token requests. ``service`` is a factory
    (``() -> AsyncLLMService``) so each serve starts from fresh residency
    bookkeeping, or a service instance to reuse (its pools persist; stale
    blocks are masked by length). A factory's service goes out of scope
    when the serve returns, so its pools are freed before the next serve
    builds its own."""

    service: object = None
    vocab: int = 0
    scheduler: object = "orca"
    mc_total: float = 1.0
    name: str = "measured"
    token_seed: int = 0

    def with_scheduler(self, scheduler) -> "MeasuredReplica":
        return replace(self, scheduler=scheduler)

    def serve(self, substream: RequestStream,
              seed: int | None = None) -> ReplicaResult:
        from ..serving.service import service_requests
        svc = self.service() if callable(self.service) else self.service
        reqs = service_requests(substream, self.vocab, seed=self.token_seed)
        res = svc.serve_sync(reqs, get_scheduler(self.scheduler),
                             stream_name=substream.name)
        return ReplicaResult(
            replica=self.name, rollout=res.rollout, timings=res.timings(),
            mc_total=float(self.mc_total),
            meta={"counters": res.counters,
                  "iterations": len(res.stats),
                  "unfinished": len(res.unfinished)})


def unit_pricer(per_token_s: float = 1e-3, per_batch_s: float = 0.0,
                ) -> Callable[[StreamRollout], np.ndarray]:
    """Analytic pricer: each iteration costs ``per_batch_s`` plus
    ``per_token_s`` per query token in the batch. Deterministic and
    hardware-free — the fleet parity/regression tests' stand-in."""

    def price(ro: StreamRollout) -> np.ndarray:
        return np.asarray(
            [per_batch_s + per_token_s * sum(r.q_len for r in b)
             for b in ro.batches], dtype=float)

    return price


def compass_pricer(spec, hw, ga_config=None, objective="latency",
                   n_blocks: int | None = None, timing_backend=None,
                   co_search=None, warm_from=None, micro_batch=None,
                   device=None) -> Callable[[StreamRollout], tuple]:
    """Pricer backed by a full per-rollout mapping search on a fixed
    hardware config — the replica's "own searched hardware+mapping".
    Heterogeneous fleets pass different ``hw`` (or ``co_search`` /
    ``objective``) per replica. ``warm_from`` threads the co-search's
    cross-mode warm start into the search (the scale-out policy's
    "re-search the mapping" action); ``meta`` carries ``mc_total`` from
    the searched point plus the search diagnostics. Every search runs on
    ``device`` (``None`` = CUDA, raising where there is none)."""
    from ..core.compass import CoSearchConfig, get_co_search, search_mapping
    from ..core.workload import DECODE

    def default_micro_batch(batch):
        if any(r.kind == DECODE for r in batch):
            return hw.micro_batch_decode
        return hw.micro_batch_prefill

    mb = micro_batch or default_micro_batch

    def price(ro: StreamRollout) -> tuple[np.ndarray, dict]:
        cs = get_co_search(co_search)
        if warm_from is not None:
            cs = CoSearchConfig(mode="joint", warm_from=warm_from,
                                warm_fraction=cs.warm_fraction,
                                violation_bias=cs.violation_bias)
        out = search_mapping(
            spec, ro.batches, hw, [mb(b) for b in ro.batches], ga_config,
            objective=objective, n_blocks=n_blocks, stream_rollout=ro,
            timing_backend=timing_backend, co_search=cs, device=device)
        return out.batch_latencies, {
            "mc_total": out.mc_total,
            "score": out.score,
            "mode": out.mode,
            "rounds": out.rounds,
            "converged": out.converged,
            "ga_evaluations": out.ga_evaluations,
            "search_output": out,
        }

    return price
