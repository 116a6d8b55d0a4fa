"""Adaptive goodput-frontier refinement (saturation-knee bracketing).

A goodput-vs-load frontier rises with the offered rate until the serving
system saturates, then falls — the *saturation knee* (the rate of peak
goodput) is the number the paper's serving comparison turns on. A fixed
coarse rate grid localises the knee no better than the grid spacing and,
worse, silently reports a *boundary* point as the knee whenever peak
goodput sits at the last swept rate (the curve may still be rising).

:func:`refine_knee` replaces the fixed grid with adaptive refinement:

* the coarse grid is priced once, then the knee is re-estimated after
  every probe — ties on a goodput plateau break toward the **highest**
  rate, so a plateau never hides capacity;
* a knee on either grid boundary means "extend the grid" (geometric
  rate extension upward, division downward), not "done" — only when the
  budget runs out with the peak still on a boundary is the curve
  flagged ``knee_saturated`` (the true knee may lie beyond the sweep);
* an interior knee is bracketed by its grid neighbours and the wider
  flank is bisected until the bracket is within ``rel_tol`` of the knee
  rate (one refinement step already halves the coarse spacing).

The evaluator is an arbitrary ``rate -> (goodput, meta)`` callable (the
serving benchmark runs a full mapping co-search per probe); results are
memoised per rate, and the refinement loop terminates under any evaluator
within ``max_probes`` extra evaluations (property-tested in
tests/test_frontier.py; this copy, the port's, in
tests/test_torch_search_extras.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

__all__ = ["FrontierPoint", "FrontierResult", "knee_index", "refine_knee",
           "sweep_knee"]


@dataclass
class FrontierPoint:
    """One priced frontier probe."""

    rate: float
    goodput: float
    meta: dict = field(default_factory=dict)


@dataclass
class FrontierResult:
    """A refined frontier curve.

    ``points`` holds every priced probe (coarse grid + refinement),
    sorted by rate. ``bracket`` is the (lo, hi) rate interval known to
    contain the knee; ``converged`` means the bracket is within
    ``rel_tol`` of the knee rate; ``knee_saturated`` means the budget ran
    out with peak goodput still on a grid boundary — high OR low — so
    the true knee may lie beyond the sweep and neither the knee nor the
    bracket should be trusted."""

    points: list[FrontierPoint]
    knee_rate: float
    peak_goodput: float
    knee_saturated: bool
    bracket: tuple[float, float]
    probes: int                       # refinement probes beyond the grid
    converged: bool


def knee_index(points: Sequence[FrontierPoint],
               rel_tie_tol: float = 1e-9) -> int:
    """Index of the saturation knee in a rate-sorted curve: the point of
    peak goodput, with ties (a goodput plateau) broken toward the
    HIGHEST rate. ``max(curve, key=goodput)`` tie-breaks to the lowest
    rate, under-reporting the knee whenever the curve plateaus —
    regression-tested."""
    if not points:
        raise ValueError("empty frontier curve")
    peak = max(p.goodput for p in points)
    tol = rel_tie_tol * max(abs(peak), 1.0)
    best = 0
    for i, p in enumerate(points):
        if p.goodput >= peak - tol:
            best = i                  # sorted by rate: last tie wins
    return best


def sweep_knee(
    evaluate: Callable[[float], "tuple[float, dict] | float"],
    rates: Sequence[float],
) -> FrontierResult:
    """Price a fixed rate grid once — no refinement — and report its knee.

    The fleet frontier's sweep primitive: each probe there is N replica
    mapping searches plus a scale-out policy search, so adaptive
    bisection around the knee is not worth its probe budget — but the
    knee bookkeeping (plateau ties break to the highest rate, a peak on
    either grid boundary is flagged ``knee_saturated``, the bracket is
    the grid neighbours) must match :func:`refine_knee` so fixed-grid and
    refined curves are comparable records. ``converged`` is always False:
    an unrefined bracket is grid-spacing wide by construction.
    """
    uniq = sorted(dict.fromkeys(float(r) for r in rates))
    if not uniq:
        raise ValueError("need at least one rate")
    if any(r <= 0 for r in uniq):
        raise ValueError("rates must be positive")
    pts = []
    for r in uniq:
        out = evaluate(r)
        goodput, meta = out if isinstance(out, tuple) else (out, {})
        pts.append(FrontierPoint(r, float(goodput), dict(meta)))
    k = knee_index(pts)
    lo = pts[k - 1].rate if k > 0 else pts[k].rate
    hi = pts[k + 1].rate if k + 1 < len(pts) else pts[k].rate
    return FrontierResult(
        points=pts,
        knee_rate=pts[k].rate,
        peak_goodput=pts[k].goodput,
        knee_saturated=k == len(pts) - 1 or k == 0,
        bracket=(lo, hi),
        probes=0,
        converged=False,
    )


def refine_knee(
    evaluate: Callable[[float], "tuple[float, dict] | float"],
    coarse_rates: Sequence[float],
    rel_tol: float = 0.25,
    max_probes: int = 8,
    extend_factor: float = 2.0,
    max_rate: float | None = None,
) -> FrontierResult:
    """Adaptively refine a goodput curve around its saturation knee.

    ``evaluate(rate)`` returns ``(goodput, meta)`` (or a bare goodput);
    it is called once per distinct rate (memoised). The coarse grid is
    priced first and does not count against ``max_probes``; refinement
    stops when the knee bracket ``(lo, hi)`` satisfies
    ``hi - lo <= rel_tol * knee_rate``, when a probe would repeat an
    already-priced rate (the bracket is numerically exhausted), or when
    ``max_probes`` refinement evaluations have been spent.

    A knee on a grid boundary triggers geometric grid extension —
    ``knee_rate * extend_factor`` upward (capped at ``max_rate``),
    ``knee_rate / extend_factor`` downward — instead of terminating: a
    boundary peak is "the sweep was too short", not an answer, on either
    edge. Only if the budget (or ``max_rate``) runs out with the peak
    still on a boundary is the result flagged ``knee_saturated``.
    """
    rates = sorted(dict.fromkeys(float(r) for r in coarse_rates))
    if not rates:
        raise ValueError("need at least one coarse rate")
    if any(r <= 0 for r in rates):
        raise ValueError("rates must be positive")

    seen: dict[float, FrontierPoint] = {}

    def probe(rate: float) -> FrontierPoint:
        rate = float(rate)
        if rate not in seen:
            out = evaluate(rate)
            goodput, meta = out if isinstance(out, tuple) else (out, {})
            seen[rate] = FrontierPoint(rate, float(goodput), dict(meta))
        return seen[rate]

    for r in rates:
        probe(r)
    probes = 0

    def curve() -> list[FrontierPoint]:
        return [seen[r] for r in sorted(seen)]

    def bracket_of(pts: list[FrontierPoint], k: int) -> tuple[float, float]:
        lo = pts[k - 1].rate if k > 0 else pts[k].rate
        hi = pts[k + 1].rate if k + 1 < len(pts) else pts[k].rate
        return lo, hi

    while probes < max_probes:
        pts = curve()
        k = knee_index(pts)
        if k == len(pts) - 1:         # peak on the high boundary: extend up
            if pts[k].goodput <= 0.0:
                # the whole grid serves NOTHING within SLO (all-zero
                # plateau ties to the high edge): rising load cannot
                # help — the only place goodput can exist is below the
                # grid, so extend down instead
                probe(pts[0].rate / extend_factor)
                probes += 1
                continue
            new_rate = pts[k].rate * extend_factor
            if max_rate is not None and new_rate > max_rate:
                break                 # rate ceiling: stays knee_saturated
            probe(new_rate)
            probes += 1
            continue
        if k == 0:                    # peak on the LOW boundary: extend down
            probe(pts[k].rate / extend_factor)
            probes += 1
            continue
        lo, hi = bracket_of(pts, k)
        knee_rate = pts[k].rate
        if hi - lo <= rel_tol * knee_rate:
            break                     # bracketed within tolerance
        # bisect the wider flank of the bracket
        left_w = knee_rate - lo
        right_w = hi - knee_rate
        mid = (lo + knee_rate) / 2.0 if left_w >= right_w and k > 0 \
            else (knee_rate + hi) / 2.0
        if float(mid) in seen:        # bracket numerically exhausted
            break
        probe(mid)
        probes += 1

    pts = curve()
    k = knee_index(pts)
    lo, hi = bracket_of(pts, k)
    saturated = k == len(pts) - 1 or k == 0
    converged = (not saturated) and (hi - lo <= rel_tol * pts[k].rate)
    return FrontierResult(
        points=pts,
        knee_rate=pts[k].rate,
        peak_goodput=pts[k].goodput,
        knee_saturated=saturated,
        bracket=(lo, hi),
        probes=probes,
        converged=converged,
    )
