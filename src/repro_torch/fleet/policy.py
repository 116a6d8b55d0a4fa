"""Scale-out policy search: what to do when offered load rises.

Given a fleet and a target offered load, compare the operator's real
choices by fleet **goodput-per-dollar** at that load:

* ``keep``             — serve the re-rated stream on the fleet as-is;
* ``add_replica``      — scale OUT: one more replica (a clone of the
  last, or whatever ``add_replica`` builds — possibly different hardware,
  a heterogeneous fleet). More goodput, but the dollar denominator grows
  by the new replica's cost, so it only wins when the capacity is needed;
* ``scheduler:<name>`` — scale SMARTER: swap every replica's batching
  scheduler (free: same hardware dollars);
* ``re_search``        — re-search each replica's mapping for the new
  load, warm-started from its previous search (the co-search
  ``CoSearchConfig(warm_from=...)`` cross-mode carrier — the ``keep``
  serve's search output seeds the new one). Same dollars, new mapping.

Options whose serve is *truncated* (the horizon ran out with requests in
flight) score ``-inf`` and can never win: a truncated rollout
under-reports load, so pricing it as healthy would systematically reward
the option that drops the most work — exactly the failure the
``StreamRollout.truncated`` flag exists to refuse.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..core.streams import RequestStream
from .fleet import Fleet, FleetResult
from .replica import Replica

__all__ = ["ScaleOutOption", "ScaleOutDecision", "plan_scale_out"]


@dataclass
class ScaleOutOption:
    """One evaluated policy option."""

    action: str
    fleet: Fleet
    result: FleetResult | None = None
    score: float = float("-inf")      # goodput per dollar; maximised
    note: str = ""

    def record(self) -> dict:
        out = {"action": self.action, "score": self.score,
               "n_replicas": self.fleet.n_replicas, "note": self.note}
        if self.result is not None:
            out["mc_total"] = self.result.mc_total
            out["goodput"] = self.result.goodput()
            out["truncated"] = self.result.truncated
        return out


@dataclass
class ScaleOutDecision:
    """The ranked option list at one offered load; ``best`` is the
    highest-scoring non-truncated option (ties keep the cheaper action
    order: keep < scheduler swap < re-search < add replica)."""

    rate: float
    options: list[ScaleOutOption] = field(default_factory=list)

    @property
    def best(self) -> ScaleOutOption:
        return max(self.options, key=lambda o: o.score)

    def record(self) -> dict:
        return {"rate": self.rate, "best": self.best.action,
                "options": [o.record() for o in self.options]}


def _clone_replica(rep: Replica, name: str) -> Replica:
    if not dataclasses.is_dataclass(rep):
        raise TypeError(
            f"cannot auto-clone replica {rep.name!r} ({type(rep).__name__} "
            "is not a dataclass); pass add_replica= explicitly")
    return dataclasses.replace(rep, name=name)


def plan_scale_out(
    fleet: Fleet,
    stream: RequestStream,
    rate: float,
    objective: "str | object" = "goodput",
    add_replica: Callable[[Fleet], Replica] | None = None,
    schedulers: Sequence[str] = (),
    re_search: Callable[[Replica, object], Replica] | None = None,
    seed: int | None = None,
) -> ScaleOutDecision:
    """Evaluate keep / add-replica / scheduler-swap / re-search at
    ``stream.with_rate(rate)`` and rank by fleet goodput-per-dollar.

    ``add_replica(fleet)`` builds the extra replica (default: clone the
    last one); ``schedulers`` lists alternative scheduler names to try
    fleet-wide; ``re_search(replica, replica_result)`` rebuilds a replica
    warm-started from its ``keep``-serve result (the result's ``meta``
    carries the compass ``search_output`` when the replica prices via
    :func:`~repro_torch.fleet.replica.compass_pricer`) — omitted options are
    simply not evaluated. The ``keep`` option always runs first: it is
    both the baseline and the warm-start donor.
    """
    rated = stream.with_rate(rate)

    def evaluate(opt: ScaleOutOption) -> ScaleOutOption:
        opt.result = opt.fleet.serve(rated, seed=seed)
        if opt.result.truncated:
            opt.score = float("-inf")
            opt.note = ("truncated: horizon ran out with requests in "
                        "flight; refusing to price a shortened schedule")
        else:
            opt.score = opt.result.goodput_per_dollar(objective)
        return opt

    keep = evaluate(ScaleOutOption("keep", fleet))
    decision = ScaleOutDecision(rate=float(rate), options=[keep])

    for name in schedulers:
        swapped = Fleet([r.with_scheduler(name) for r in fleet.replicas],
                        policy=fleet.policy, classify=fleet.classify)
        decision.options.append(
            evaluate(ScaleOutOption(f"scheduler:{name}", swapped)))

    if re_search is not None:
        searched = Fleet(
            [re_search(r, keep.result.replica_results[i])
             for i, r in enumerate(fleet.replicas)],
            policy=fleet.policy, classify=fleet.classify)
        decision.options.append(
            evaluate(ScaleOutOption("re_search", searched)))

    extra = add_replica(fleet) if add_replica is not None else \
        _clone_replica(fleet.replicas[-1],
                       f"{fleet.replicas[-1].name}+{fleet.n_replicas}")
    grown = Fleet(list(fleet.replicas) + [extra], policy=fleet.policy,
                  classify=fleet.classify)
    decision.options.append(evaluate(ScaleOutOption("add_replica", grown)))
    return decision
