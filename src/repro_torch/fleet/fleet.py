"""Fleet: N replicas behind one router, with request-indexed accounting.

``Fleet.serve`` routes a stream (``repro_torch.fleet.router``), serves each
sub-stream on its replica, and merges the per-replica
:class:`~repro_torch.core.streams.RequestTimings` back into ONE request-indexed
view (:func:`~repro_torch.core.streams.merge_timings`) — so every stream
objective (goodput under SLO, TTFT/TPOT percentiles) scores a fleet
exactly as it scores a single server, and the fleet-level co-design
metric is just ``goodput_per_dollar`` with ``mc`` = the summed hardware
cost of the replicas.

Keystone invariant (pinned in tests/test_torch_fleet.py): a 1-replica fleet is
bit-identical to serving the unsplit stream — same rollout, same merged
timings, same score. The router is the identity split, ``merge_timings``
is a bit-copying scatter, and the fleet makespan is the max over one
part. Everything the fleet layer adds must vanish at N=1.

Fleet makespan is the MAX over replica makespans: replicas serve
concurrently on separate hardware, against one shared arrival clock
(sub-streams keep global arrival iterations), so the fleet is done when
its slowest replica is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from ..core.objectives import Objective, get_objective
from ..core.streams import RequestStream, RequestTimings, merge_timings
from .replica import Replica, ReplicaResult
from .router import RouteAssignment, route_stream

__all__ = ["Fleet", "FleetResult"]


@dataclass
class FleetResult:
    """One fleet serve: the route, every replica's result, and the merged
    request-indexed timings."""

    route: RouteAssignment
    replica_results: list[ReplicaResult]
    timings: RequestTimings
    mc_total: float                    # summed hardware dollars
    meta: dict = field(default_factory=dict)

    @property
    def n_replicas(self) -> int:
        return self.route.n_replicas

    @property
    def truncated(self) -> bool:
        """Any replica ran out of horizon with requests in flight — the
        merged timings then under-report load, so policy comparisons must
        refuse (not reward) truncated options."""
        return self.timings.truncated

    def goodput(self, objective: "Objective | str" = "goodput") -> float:
        """Fleet goodput (requests/s within SLO, positive) under a stream
        objective. Scored on the merged request-indexed timings, so
        straggler replicas drag the shared makespan exactly as a
        straggler batch drags a single server."""
        obj = get_objective(objective)
        inner = obj.inner()           # MC-free factor; timings-only score
        return -float(inner.score(0.0, 0.0, timings=self.timings))

    def goodput_per_dollar(self,
                           objective: "Objective | str" = "goodput",
                           ) -> float:
        """Fleet goodput divided by the fleet's summed hardware cost —
        the scale-out policy search's comparison metric (positive;
        maximise)."""
        if self.mc_total <= 0:
            raise ValueError(
                f"fleet monetary cost must be positive, got {self.mc_total}")
        return self.goodput(objective) / self.mc_total

    def slo_percentiles(self, pcts=(50.0, 90.0, 99.0)) -> dict:
        """Fleet-level TTFT/TPOT percentiles (seconds) over the merged
        request view. TTFT is over cold requests only (warm decode-
        resident requests have none)."""
        t = self.timings
        out = {"cold_requests": int((~t.warm).sum()),
               "warm_requests": int(t.warm.sum()),
               "finished": int(t.finished.sum())}
        for p in pcts:
            if t.cold_ttft_s.shape[-1]:
                out[f"ttft_p{p:g}_s"] = float(
                    np.percentile(t.cold_ttft_s, p, method="higher"))
            out[f"tpot_p{p:g}_s"] = float(
                np.percentile(t.tpot_s, p, method="higher"))
        return out

    def summary(self) -> dict:
        """JSON-ready fleet record (the benchmark's per-point payload)."""
        return {
            "n_replicas": self.n_replicas,
            "policy": self.route.policy,
            "loads": self.route.loads().tolist(),
            "mc_total": self.mc_total,
            "makespan_s": float(self.timings.makespan_s),
            "truncated": self.truncated,
            "replicas": [
                {"name": r.replica, "mc_total": r.mc_total,
                 "n_requests": int(len(self.route.indices[i])),
                 "makespan_s": float(r.timings.makespan_s),
                 "truncated": r.truncated}
                for i, r in enumerate(self.replica_results)],
            **self.slo_percentiles(),
        }


@dataclass
class Fleet:
    """N replicas (heterogeneous allowed — each carries its own searched
    hardware+mapping via its pricer/service) behind one routing policy."""

    replicas: Sequence[Replica]
    policy: str = "round_robin"
    classify: Callable | None = None

    def __post_init__(self):
        if not self.replicas:
            raise ValueError("a fleet needs at least one replica")

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    def serve(self, stream: RequestStream,
              seed: int | None = None) -> FleetResult:
        route = route_stream(stream, self.n_replicas, self.policy,
                             seed=seed, classify=self.classify)
        results = [rep.serve(sub, seed=seed)
                   for rep, sub in zip(self.replicas, route.substreams)]
        merged = merge_timings([r.timings for r in results], route.indices,
                               route.n_requests)
        return FleetResult(
            route=route,
            replica_results=results,
            timings=merged,
            mc_total=float(sum(r.mc_total for r in results)),
        )
