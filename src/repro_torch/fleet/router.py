"""Deterministic request routing: one high-rate stream across N replicas.

The router/gateway splits a :class:`~repro_torch.core.streams.RequestStream`'s
sampled population into per-replica sub-streams *before* any serving
happens — routing is a pure function of the request population in sample
order, never of arrival times or serving state. That design choice is
what preserves the streams' rate-invariance contract through the split: a
``with_rate`` re-rating changes only arrival iterations, so every policy
here produces the *same assignment and the same per-replica populations
at every offered load* (regression-tested), and fleet frontier points
compare goodput-per-dollar on identical per-replica request sets.

Three policies:

* ``round_robin``   — request ``i`` goes to replica ``i % N`` (sample
  order == arrival order: arrivals are a cumulative sum, so this is also
  arrival-order round-robin);
* ``least_loaded``  — greedy worst-case-work balancing: each request (in
  order) goes to the replica with the least accumulated token work
  (warm requests count only their remaining decode work; ties break to
  the lowest replica index);
* ``slo_class``     — SLO-class-aware: requests are classified (default:
  cold "interactive" vs warm "resident"), each class owns a disjoint
  replica subset (classes round-robin over ``range(n)`` by class index)
  and round-robins within it — class isolation, so a long-context batch
  class cannot head-of-line-block the interactive class's replicas.

The mechanics of the split (and of merging per-replica timings back into
one request-indexed view) live in ``repro_torch.core.streams``
(:func:`~repro_torch.core.streams.split_stream` /
:func:`~repro_torch.core.streams.merge_timings`); this module owns only the
assignment policies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from ..core.streams import RequestStream, StreamRequest, split_stream

__all__ = ["POLICIES", "RouteAssignment", "assign", "route_stream",
           "default_classify"]

POLICIES = ("round_robin", "least_loaded", "slo_class")


@dataclass(frozen=True)
class RouteAssignment:
    """A routed stream: the per-request replica assignment (sample order)
    plus the materialised per-replica sub-streams and the index sets that
    map each sub-stream's request order back to the original sample order
    (the input of :func:`~repro_torch.core.streams.merge_timings`)."""

    stream_name: str
    policy: str
    n_replicas: int
    assignment: np.ndarray                     # (R,) replica per request
    substreams: tuple[RequestStream, ...]      # explicit-request streams
    indices: tuple[np.ndarray, ...]            # per replica, sample indices

    @property
    def n_requests(self) -> int:
        return len(self.assignment)

    def loads(self) -> np.ndarray:
        """Requests per replica."""
        return np.bincount(self.assignment, minlength=self.n_replicas)


def _work(req: StreamRequest) -> int:
    """Worst-case token work a request brings to a replica. Warm requests
    arrive decode-resident: their context is already materialised, so only
    the remaining decode work counts."""
    if req.warm:
        return req.max_new_tokens
    return req.prompt_len + req.max_new_tokens


def default_classify(req: StreamRequest) -> int:
    """Default SLO classes: 0 = interactive (cold — TTFT-bound), 1 =
    resident (warm decode — TPOT-bound only)."""
    return 1 if req.warm else 0


def assign(requests: Sequence[StreamRequest], n_replicas: int,
           policy: str = "round_robin",
           classify: Callable[[StreamRequest], int] | None = None,
           ) -> np.ndarray:
    """Per-request replica assignment (sample order) under a policy.

    Deterministic, and a function of the request *population* only —
    lengths, warm mix, order — never of arrival iterations, so the
    assignment is invariant under ``with_rate`` by construction.
    """
    if n_replicas < 1:
        raise ValueError(f"need at least one replica, got {n_replicas}")
    if policy not in POLICIES:
        raise ValueError(f"unknown routing policy {policy!r}; choose from "
                         f"{POLICIES}")
    n = len(requests)
    out = np.zeros(n, dtype=int)
    if policy == "round_robin":
        out = np.arange(n, dtype=int) % n_replicas
    elif policy == "least_loaded":
        load = np.zeros(n_replicas, dtype=np.int64)
        for i, r in enumerate(requests):
            p = int(np.argmin(load))          # ties -> lowest replica index
            out[i] = p
            load[p] += _work(r)
    else:                                      # slo_class
        classify = default_classify if classify is None else classify
        cls = np.asarray([int(classify(r)) for r in requests], dtype=int)
        classes = sorted(set(cls.tolist()))
        nc = len(classes)
        # each class owns the replicas congruent to its rank; with fewer
        # replicas than classes, classes wrap onto shared replicas
        if n_replicas >= nc:
            owners = {c: [p for p in range(n_replicas) if p % nc == rank]
                      for rank, c in enumerate(classes)}
        else:
            owners = {c: [rank % n_replicas]
                      for rank, c in enumerate(classes)}
        seen: dict[int, int] = {}
        for i, _r in enumerate(requests):
            c = int(cls[i])
            k = seen.get(c, 0)
            own = owners[c]
            out[i] = own[k % len(own)]
            seen[c] = k + 1
    return out


def route_stream(stream: RequestStream, n_replicas: int,
                 policy: str = "round_robin", seed: int | None = None,
                 classify: Callable[[StreamRequest], int] | None = None,
                 ) -> RouteAssignment:
    """Sample a stream once and split it across ``n_replicas`` under a
    routing policy. A 1-replica route is the identity split: its single
    sub-stream rolls out bit-identically to the unsplit stream (the fleet
    keystone invariant, pinned in tests/test_torch_fleet.py)."""
    reqs = stream.sample(seed) if not stream.is_fixed else None
    if reqs is None:
        raise ValueError(f"stream {stream.name!r} is fixed-batch: the "
                         "router needs a request population")
    a = assign(reqs, n_replicas, policy, classify=classify)
    subs, indices = split_stream(stream, a, n_replicas, seed=seed)
    return RouteAssignment(
        stream_name=stream.name, policy=policy, n_replicas=n_replicas,
        assignment=a, substreams=subs, indices=indices)
