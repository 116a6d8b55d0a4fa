"""Pluggable DSE objectives (paper Eq. 1 cost C, §VI-A metrics).

Replaces the stringly-typed ``_objective_value(lat, en, mc, "edp_mc")``
dispatch with first-class :class:`Objective` values threaded through
``search_mapping`` / ``hardware_objective`` / ``explore`` and the
baselines. Two capability flags drive where an objective may be used:

* ``uses_mc`` — the score includes monetary cost. MC is constant for a
  fixed hardware point, so the *mapping* search rejects such objectives
  loudly (it used to silently drop MC): pass ``objective.inner()`` (the
  MC-free factor, e.g. EDP for EDP·MC) to the inner GA and apply the full
  objective at the hardware level.
* ``requires_stream`` — the score is computed from per-request timing of a
  scheduler rollout (:class:`~repro_torch.core.streams.RequestTimings`): TTFT /
  TPOT percentiles and goodput-under-SLO. These refuse fixed-batch shim
  scenarios, whose timing is synthetic.

Scores are always minimised; goodput (a maximised rate) is returned
negated. SLO objectives are scored on *true* per-request timings inside
the mapping GA as well: ``score_timings`` is vectorised over leading axes,
so a whole population's rollout pricing — (P, R) TTFT/TPOT folded from the
evaluator's timing matrix by ``repro_torch.core.timing.fold_request_timings`` —
scores in one call. (The old within-group total-latency surrogate is gone:
it could not trade prefill vs decode iterations, the paper's central
mixed-request-types claim.)
"""
# Objective subclasses implement one uniform score()/ga_fitness()
# signature; which inputs an objective consumes is the point of the subclass
# ruff: noqa: ARG002
from __future__ import annotations

import re

import numpy as np

from .streams import RequestTimings


class Objective:
    """Minimised DSE score. Subclasses define ``score`` (scalar, from
    totals) and ``ga_fitness`` (vectorised (B, P) per-batch latency/energy
    -> (P,) population fitness for the mapping GA)."""

    name: str = "objective"
    uses_mc: bool = False
    requires_stream: bool = False

    def inner(self) -> "Objective":
        """The MC-free objective the per-hardware mapping search minimises."""
        return self

    def score(self, latency_s: float, energy_j: float, mc: float = 1.0,
              timings: RequestTimings | None = None) -> float:
        raise NotImplementedError

    def ga_fitness(self, lat: np.ndarray, en: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    @staticmethod
    def improved(new: float, old: float, rel_tol: float = 0.0) -> bool:
        """``new`` is a strict improvement over ``old`` (both minimised
        scores) beyond a relative tolerance scaled by ``|old|`` — correct
        for negated maximised scores (goodput) as well as positive EDP /
        latency scores. The co-search fixed-point loop uses this for both
        adoption and convergence."""
        new, old = float(new), float(old)
        if not np.isfinite(old):
            return bool(np.isfinite(new) or new < old)
        return bool(new < old - rel_tol * abs(old))

    def _timings(self, timings: RequestTimings | None) -> RequestTimings:
        if timings is None:
            raise ValueError(
                f"objective {self.name!r} needs per-request timing; give "
                "the Scenario a RequestStream + scheduler (requires_stream)")
        if timings.synthetic:
            raise ValueError(
                f"objective {self.name!r} cannot be scored on a fixed-batch "
                "(legacy phase/trace/workload) scenario: its per-request "
                "timing is synthetic. Use a RequestStream + scheduler.")
        return timings

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class EDP(Objective):
    name = "edp"

    def score(self, latency_s, energy_j, mc=1.0, timings=None):
        return float(latency_s * energy_j)

    def ga_fitness(self, lat, en):
        return (lat * en).mean(axis=0)


class EDPxMC(Objective):
    """EDP x monetary cost — the paper's headline co-design metric."""

    name = "edp_mc"
    uses_mc = True

    def inner(self):
        return EDP()

    def score(self, latency_s, energy_j, mc=1.0, timings=None):
        return float(latency_s * energy_j * mc)

    def ga_fitness(self, lat, en):
        raise RuntimeError(
            "edp_mc cannot drive the mapping GA (MC is constant per "
            "hardware point); use inner() == EDP")


class Latency(Objective):
    name = "latency"

    def score(self, latency_s, energy_j, mc=1.0, timings=None):
        return float(latency_s)

    def ga_fitness(self, lat, en):
        return lat.mean(axis=0)


class Energy(Objective):
    name = "energy"

    def score(self, latency_s, energy_j, mc=1.0, timings=None):
        return float(energy_j)

    def ga_fitness(self, lat, en):
        return en.mean(axis=0)


class _StreamObjective(Objective):
    """SLO-aware base: scored from rollout timings. ``score_timings`` is
    the vectorised core — the request axis is last, leading axes (a GA
    population) broadcast through — and ``score`` is its scalar wrapper.
    There is deliberately no latency/energy ``ga_fitness``: the mapping GA
    prices every candidate's rollout and ranks on true timings."""

    requires_stream = True

    def ga_fitness(self, lat, en):
        raise RuntimeError(
            f"objective {self.name!r} has no latency/energy GA fitness — "
            "it is scored on true per-request timings: fold the evaluator's"
            " timing matrix into RequestTimings (timing.fold_request_"
            "timings) and call score_timings (search_mapping does this)")

    def score_timings(self, timings: RequestTimings) -> np.ndarray:
        raise NotImplementedError

    def violations(self, timings: RequestTimings) -> np.ndarray:
        """(..., R) bool mask of requests violating the objective — the
        input of per-group violation attribution
        (``timing.attribute_group_violations``), which biases the joint
        co-search's mutation toward the structure group whose latencies
        dominate the violations. Default: unfinished requests."""
        return ~np.asarray(timings.finished, dtype=bool)

    def score(self, latency_s, energy_j, mc=1.0, timings=None):
        return float(self.score_timings(self._timings(timings)))


class TTFTPercentile(_StreamObjective):
    """p-th percentile time-to-first-token over cold requests (seconds);
    requests unserved within the horizon count as +inf, so the search is
    pushed to actually serve first tokens."""

    def __init__(self, pct: float = 99.0):
        self.pct = float(pct)
        self.name = f"ttft_p{pct:g}"

    def score_timings(self, timings):
        ttft = timings.cold_ttft_s
        if ttft.shape[-1] == 0:
            raise ValueError("stream has no cold requests: TTFT undefined")
        # method="higher": no interpolation, so +inf (unserved) stays +inf
        # instead of poisoning the estimate with nan
        return np.percentile(ttft, self.pct, axis=-1, method="higher")

    def violations(self, timings):
        # cold requests at/above the percentile drive the score
        s = np.asarray(self.score_timings(timings))[..., None]
        return (~timings.warm) & (timings.ttft_s >= s)


class TPOTPercentile(_StreamObjective):
    """p-th percentile time-per-output-token over all requests (seconds);
    unfinished requests count as +inf."""

    def __init__(self, pct: float = 99.0):
        self.pct = float(pct)
        self.name = f"tpot_p{pct:g}"

    def score_timings(self, timings):
        return np.percentile(timings.tpot_s, self.pct, axis=-1,
                             method="higher")

    def violations(self, timings):
        s = np.asarray(self.score_timings(timings))[..., None]
        return timings.tpot_s >= s


class GoodputUnderSLO(_StreamObjective):
    """Negated goodput: -(requests finished within both SLOs) / makespan.
    Warm requests have no TTFT and are held to the TPOT SLO only."""

    def __init__(self, ttft_slo_s: float = 0.5, tpot_slo_s: float = 0.1):
        self.ttft_slo_s = float(ttft_slo_s)
        self.tpot_slo_s = float(tpot_slo_s)
        self.name = f"goodput@ttft{ttft_slo_s:g}s/tpot{tpot_slo_s:g}s"

    def _ok(self, t):
        ttft_ok = t.warm | (t.ttft_s <= self.ttft_slo_s)
        return t.finished & ttft_ok & (t.tpot_s <= self.tpot_slo_s)

    def score_timings(self, timings):
        t = timings
        mk = np.asarray(t.makespan_s, dtype=float)
        good = self._ok(t).sum(axis=-1)
        return -np.where(mk > 0.0, good / np.maximum(mk, 1e-300), 0.0)

    def violations(self, timings):
        return ~self._ok(timings)


class GoodputPerDollar(GoodputUnderSLO):
    """Negated goodput per dollar of hardware: -(good requests / makespan)
    / MC. The fleet-level co-design metric — "add a replica" doubles the
    denominator, so it only wins when the extra replica at least doubles
    the goodput the SLOs let through. Like EDP·MC, the MC factor is
    constant per hardware point, so the mapping search runs on the
    MC-free ``inner()`` (plain goodput-under-SLO) and the full objective
    applies at the hardware/fleet level."""

    uses_mc = True

    def __init__(self, ttft_slo_s: float = 0.5, tpot_slo_s: float = 0.1):
        super().__init__(ttft_slo_s, tpot_slo_s)
        self.name = f"goodput_per_dollar@ttft{ttft_slo_s:g}s" \
                    f"/tpot{tpot_slo_s:g}s"

    def inner(self):
        return GoodputUnderSLO(self.ttft_slo_s, self.tpot_slo_s)

    def score(self, latency_s, energy_j, mc=1.0, timings=None):
        if mc <= 0:
            raise ValueError(f"monetary cost must be positive, got {mc}")
        return float(self.score_timings(self._timings(timings))) / mc


_NAMED = {
    "edp": EDP,
    "edp_mc": EDPxMC,
    "latency": Latency,
    "energy": Energy,
    "goodput": GoodputUnderSLO,
    "goodput_per_dollar": GoodputPerDollar,
}
_PCTL = re.compile(r"^(ttft|tpot)_p(\d+(?:\.\d+)?)$")

OBJECTIVES = tuple(sorted(_NAMED)) + ("ttft_p<P>", "tpot_p<P>")


def get_objective(obj: "Objective | str") -> Objective:
    """Resolve an objective name ('edp', 'edp_mc', 'latency', 'energy',
    'goodput', 'ttft_p99', 'tpot_p50', ...) or pass an instance through."""
    if isinstance(obj, Objective):
        return obj
    if isinstance(obj, str):
        if obj in _NAMED:
            return _NAMED[obj]()
        m = _PCTL.match(obj)
        if m:
            cls = TTFTPercentile if m.group(1) == "ttft" else TPOTPercentile
            return cls(float(m.group(2)))
    raise ValueError(f"unknown objective {obj!r}; choose from "
                     f"{OBJECTIVES} or pass an Objective instance")
