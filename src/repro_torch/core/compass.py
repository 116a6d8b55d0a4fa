"""Compass top-level co-exploration loop (paper §V, Eq. 1):

    (H*, M*) = argmin_{H, M}  E_{lambda ~ D} [ C(lambda, H, M) ]

The hardware sampling engine (BO) proposes hardware points; for each, the
mapping generation engine (GA) searches the best mapping over the
per-iteration batches of the scenario's workload; the evaluation engine
scores each (workload, hardware, mapping) triplet. The best mapping's score
is the hardware's fitness.

The scenario API is stream-first: a :class:`Scenario` carries a
``RequestStream`` (arrival process + length distribution + request mix), a
``Scheduler`` (the *same* iteration-level policy objects the serving
engine runs), and an ``Objective`` (EDP / EDP·MC / latency / energy /
SLO-aware TTFT/TPOT percentiles and goodput). The stream is rolled out
once per scenario into the batch sequence the searched design will
actually serve; legacy ``phase``/``trace``/``workload`` fields still work
as thin deprecation shims that build a fixed-batch stream internally.

Batches sharing an execution-graph structure (same rows x M) share one
mapping — the mapping must serve the *distribution*, not a single batch
(this is what Gemini's fixed-length assumption cannot do).

Every entry point takes a ``device`` knob
(:func:`~repro_torch.core.timing.resolve_devices`): ``None`` means one
CUDA device and raises when CUDA is missing; several devices (an int or a
list) split each GA population into chunks, one per device, with results
equal bit for bit to one device's; tests pass ``device="cpu"`` (or a list
of them). The population evaluators are built from
:mod:`repro_torch.core.torch_evaluator`; a failure to build one raises
(there is no slower path to fall back to).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field, replace
from typing import Sequence

import numpy as np
import torch

from .. import spans
from ..serving.scheduler import Scheduler, get_scheduler
from .bo import BOResult, HardwarePoint, bo_search
from .encoding import (
    MappingEncoding,
    StackedPopulation,
    as_stacked,
    pipeline_parallel,
)
from .evaluator import EvalResult, evaluate
from .ga import GAConfig, GAResult, ga_search, joint_ga_search
from .hardware import HardwareConfig, monetary_cost
from .objectives import Objective, get_objective
from .streams import RequestStream, StreamRollout, rollout as roll_stream
from .timing import (
    OracleTimingBackend,
    TimingBackend,
    fold_request_timings,
    get_graph_and_tables,
    get_timing_backend,
    resolve_devices,
    splice_latencies,
)
from .torch_evaluator import GroupPopulationEvaluator, JointStreamEvaluator
from .traces import ServingWorkload, TraceDistribution, sample_batches
from .workload import DECODE, PREFILL, LLMSpec, Request

CO_SEARCH_MODES = ("one_sweep", "fixed_point", "joint")


@dataclass(frozen=True)
class CoSearchConfig:
    """Cross-group co-search policy for :func:`search_mapping`.

    SLO-aware (stream) fitness couples the structure groups of a scenario:
    each candidate is scored on the *full* rollout, with batches owned by
    other groups priced at their best-known latencies. How those
    best-known values are refined is the co-search mode:

    * ``one_sweep`` — the historical behaviour: one coordinate-descent
      sweep over the groups in discovery order; groups searched early are
      scored against stale (pipeline-parallel-seeded) neighbours.
    * ``fixed_point`` — iterate sweeps until no group improves the
      scenario objective (or ``max_rounds`` / ``max_evals`` is hit).
      Rounds after the first warm-start each group's GA with the previous
      round's elites (re-validated and re-scored — see
      ``ga.validate_warm_start``) and only adopt a group's new mapping if
      it improves the oracle-priced scenario score, so the per-round score
      sequence is non-increasing.
    * ``joint`` — one GA population spans all groups (one encoding per
      group per individual, ``ga.joint_ga_search``); fitness needs no
      best-known splicing at all. ``warm_from`` seeds part of the joint
      population from a completed run's adopted per-group elites
      (cross-mode warm start — typically a ``fixed_point``
      ``MappingSearchOutput``), and ``violation_bias`` steers the
      per-group mutation mask toward the group whose latencies dominate
      the current SLO violations (see ``ga.joint_ga_search``).

    Objectives without stream coupling (EDP / latency / energy) make the
    groups independent, so non-``one_sweep`` modes fall back with a
    warning."""

    mode: str = "one_sweep"
    max_rounds: int = 6          # fixed_point: sweep budget (incl. round 1)
    rel_tol: float = 1e-4        # min relative improvement to keep iterating
    max_evals: int | None = None  # total GA evaluations across rounds
    warm_start: bool = True      # carry elites into later rounds
    warm_elites: int = 8         # how many elites re-seed each group's GA
    # joint-mode cross-mode warm start: a completed MappingSearchOutput
    # (or {group key -> encoding list}) whose adopted per-group elites
    # seed up to warm_fraction of the joint population (validated via
    # ga.validate_warm_start; 0.0 is bit-identical to a cold start)
    warm_from: object = None
    warm_fraction: float = 0.5
    # joint-mode mutation bias toward the SLO-violating group: 0 = uniform
    # group draw, 1 = pure violation attribution (mixed, so every group
    # keeps a mutation floor)
    violation_bias: float = 0.5

    def __post_init__(self):
        if self.mode not in CO_SEARCH_MODES:
            raise ValueError(f"unknown co-search mode {self.mode!r}; "
                             f"choose from {CO_SEARCH_MODES}")
        if not 0.0 <= self.warm_fraction <= 1.0:
            raise ValueError(
                f"warm_fraction must be in [0, 1], got {self.warm_fraction}")
        if not 0.0 <= self.violation_bias <= 1.0:
            raise ValueError(
                f"violation_bias must be in [0, 1], "
                f"got {self.violation_bias}")


def get_co_search(spec: "CoSearchConfig | str | None") -> CoSearchConfig:
    """Resolve a co-search mode name or config; ``None`` -> one_sweep."""
    if isinstance(spec, CoSearchConfig):
        return spec
    if spec is None:
        return CoSearchConfig()
    if isinstance(spec, str):
        return CoSearchConfig(mode=spec)
    raise ValueError(f"expected CoSearchConfig, mode name or None, "
                     f"got {spec!r}")


@dataclass
class Scenario:
    """A DSE scenario: model x workload x compute target (§VI-A).

    Stream-first form::

        Scenario("mix", spec, target_tops=512,
                 stream=RequestStream("sharegpt", trace=SHAREGPT, rate=0.5),
                 scheduler="chunked_prefill", objective="ttft_p99")

    ``stream`` is rolled out under ``scheduler`` (an instance or a
    ``repro_torch.serving.SCHEDULERS`` name) into the per-iteration batches the
    search evaluates; ``objective`` (an ``Objective`` or name) is the
    default score for ``explore``. The legacy ``phase``/``trace`` /
    ``workload`` fields are deprecation shims that construct a fixed-batch
    stream internally — identical batches, synthetic per-request timing
    (SLO-aware objectives refuse them).
    """

    name: str
    spec: LLMSpec
    target_tops: float
    phase: str = PREFILL                      # prefill | decode | workload
    trace: TraceDistribution | None = None
    batch_size: int = 4
    n_batches: int = 3                        # sampled batches averaged over
    workload: ServingWorkload | None = None   # deprecated (§VI-F shim)
    n_blocks: int | None = None               # evaluated block window
    seed: int = 0
    stream: RequestStream | None = None
    scheduler: Scheduler | str = "orca"
    objective: Objective | str | None = None  # default for explore()
    timing_backend: "TimingBackend | str | None" = None  # oracle|dense|kernel|fused
    co_search: "CoSearchConfig | str | None" = None  # one_sweep|fixed_point|joint
    device: object = None                     # devices; None = one card
    max_slots: int | None = None              # engine slots for the rollout
    max_stream_iters: int = 128               # rollout horizon (iterations)
    _rollout: StreamRollout | None = field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.stream is None and (self.trace is not None
                                    or self.workload is not None):
            warnings.warn(
                "Scenario(phase=/trace=/workload=) is deprecated: pass a "
                "RequestStream via stream= (and a scheduler=) instead. The "
                "legacy fields are evaluated as a fixed-batch stream with "
                "synthetic per-request timing.",
                DeprecationWarning, stacklevel=3)

    def resolved_stream(self) -> RequestStream:
        if self.stream is not None:
            return self.stream
        if self.workload is not None:
            return RequestStream.fixed_batches(self.workload.batches,
                                               name=self.workload.name)
        if self.trace is not None:
            return RequestStream.fixed_batches(
                sample_batches(self.trace, self.phase, self.batch_size,
                               self.n_batches, seed=self.seed),
                name=f"{self.trace.name}-{self.phase}")
        raise ValueError(f"scenario {self.name!r} has neither stream= nor "
                         "trace=/workload=")

    def resolved_scheduler(self) -> Scheduler:
        return get_scheduler(self.scheduler)

    def resolved_objective(self, default: Objective | str = "edp_mc"
                           ) -> Objective:
        return get_objective(self.objective if self.objective is not None
                             else default)

    def resolved_backend(self) -> "TimingBackend":
        """The scenario's timing backend (``timing_backend=`` field >
        ``REPRO_TORCH_TIMING_BACKEND`` env > ``fused``)."""
        return get_timing_backend(self.timing_backend)

    def resolved_co_search(self) -> CoSearchConfig:
        return get_co_search(self.co_search)

    def rollout(self) -> StreamRollout:
        """The scenario's workload as per-iteration batches (cached: the
        rollout is hardware-independent)."""
        if self._rollout is None:
            # the stream's own seed is authoritative (the scenario seed
            # drives the legacy sample_batches shim, not stream sampling)
            self._rollout = roll_stream(
                self.resolved_stream(), self.resolved_scheduler(),
                max_slots=self.max_slots, max_iters=self.max_stream_iters)
        return self._rollout

    # hw kept for call-site compatibility (hardware-dependent batching may
    # return once micro_batch moves into the rollout)
    def batches(self, hw: HardwareConfig | None = None) -> list[list[Request]]:  # noqa: ARG002
        return self.rollout().batches

    def micro_batch(self, hw: HardwareConfig, batch: list[Request]) -> int:
        if any(r.kind == DECODE for r in batch):
            return hw.micro_batch_decode
        return hw.micro_batch_prefill


@dataclass
class MappingSearchOutput:
    """Result of :func:`search_mapping`. ``ga_results`` holds one entry
    per GA run per group (one_sweep: one sweep; fixed_point: one per
    group per round; joint: per-group *views* of the single joint run —
    shared history/score, with the run's evaluations attributed to the
    first entry so the list sums to ``ga_evaluations``, the authoritative
    total)."""

    encodings: dict[tuple, MappingEncoding]
    latency_s: float
    energy_j: float
    mc_total: float
    score: float                      # the search objective's own score
    ga_results: list[GAResult] = field(default_factory=list)
    per_batch: list[EvalResult] = field(default_factory=list)
    mode: str = "one_sweep"           # co-search mode actually run
    rounds: int = 1                   # sweeps executed (joint: 1)
    round_scores: list[float] = field(default_factory=list)
    converged: bool = True            # fixed point reached (no group improved)
    ga_evaluations: int = 0           # total GA evaluations across rounds
    # adopted encoding + final-round elites per group: the cross-mode warm
    # start carrier (CoSearchConfig(mode="joint", warm_from=this_output))
    group_elites: "dict[tuple, list[MappingEncoding]]" = field(
        default_factory=dict)

    @property
    def edp(self) -> float:
        return self.latency_s * self.energy_j

    @property
    def batch_latencies(self) -> np.ndarray:
        return np.asarray([r.latency_s for r in self.per_batch])


def search_mapping(
    spec: LLMSpec,
    batches: Sequence[list[Request]],
    hw: HardwareConfig,
    micro_batches: Sequence[int],
    ga_config: GAConfig | None = None,
    objective: Objective | str = "edp",
    n_blocks: int | None = None,
    stream_rollout: StreamRollout | None = None,
    timing_backend: "TimingBackend | str | None" = None,
    co_search: "CoSearchConfig | str | None" = None,
    device: object = None,
) -> MappingSearchOutput:
    """GA mapping search shared across structurally-identical batches. The
    population evaluators split each generation over ``device``
    (:func:`~repro_torch.core.timing.resolve_devices`; ``None`` = one
    CUDA device, raising when CUDA is missing); the fold
    runs on the first device.

    ``objective`` must be MC-free (``uses_mc=False``): monetary cost is
    constant for a fixed hardware config, so an MC-bearing objective here
    would silently degenerate — pass ``objective.inner()`` and apply the
    full objective at the hardware level.

    SLO-aware (``requires_stream``) objectives need ``stream_rollout``
    (whose ``batches`` must be the ones passed in) and are ranked on TRUE
    per-request timings inside the GA: each candidate's per-batch
    latencies are spliced into the rollout's full latency vector (batches
    owned by *other* structure groups use the best latency known so far —
    seeded from a pipeline-parallel mapping) and folded into per-request
    TTFT/TPOT on device, so the GA can trade prefill vs decode iterations
    instead of minimising a total-latency surrogate. ``co_search``
    controls how the cross-group coupling is resolved: one coordinate-
    descent sweep (default, the historical behaviour), a fixed-point
    iteration of sweeps with warm-started populations, or one joint GA
    population over all groups — see :class:`CoSearchConfig`.

    Execution graphs and cost tables come from the persistent
    ``repro_torch.core.timing`` cache — a second search on the same scenario
    rebuilds neither, and the device-resident stacked table buffers are
    reused across generations and calls.
    """
    devs = resolve_devices(device)
    dev = devs[0]
    obj = get_objective(objective)
    if obj.uses_mc:
        raise ValueError(
            f"objective {obj.name!r} includes monetary cost, which is "
            "constant for a fixed hardware config and cannot drive the "
            f"mapping search; pass its MC-free factor "
            f"{obj.inner().name!r} (objective.inner()) instead")
    if obj.requires_stream and stream_rollout is None:
        raise ValueError(
            f"objective {obj.name!r} needs the scenario's StreamRollout to "
            "price per-request timing; pass stream_rollout=")
    if obj.requires_stream and stream_rollout.synthetic:
        raise ValueError(
            f"objective {obj.name!r} cannot drive the mapping GA on a "
            "fixed-batch (synthetic) rollout; use a RequestStream + "
            "scheduler")
    cs = get_co_search(co_search)
    if cs.mode != "one_sweep" and not obj.requires_stream:
        warnings.warn(
            f"co-search mode {cs.mode!r} has no effect under objective "
            f"{obj.name!r}: without per-request stream timing the structure "
            "groups are independent (no cross-group coupling to iterate); "
            "falling back to one_sweep", RuntimeWarning, stacklevel=2)
        cs = replace(cs, mode="one_sweep")
    ga_config = ga_config or GAConfig()
    # group batches by execution-graph structure
    groups: dict[tuple, list[int]] = {}
    graphs, tables = [], []
    with spans.span("search.graphs_tables"):
        for i, (batch, mb) in enumerate(zip(batches, micro_batches)):
            g, t = get_graph_and_tables(spec, batch, hw, mb, n_blocks)
            graphs.append(g)
            tables.append(t)
            key = (g.rows, g.n_cols)
            groups.setdefault(key, []).append(i)

    # all structurally-identical batches of a group are evaluated in ONE
    # device call per generation (batches x population)
    group_evals = {
        key: _make_population_eval([graphs[i] for i in idxs],
                                   [tables[i] for i in idxs], hw,
                                   timing_backend, devs)
        for key, idxs in groups.items()
    }

    stream_fitness = obj.requires_stream
    base_lat = None
    if stream_fitness:
        # best-known per-batch latencies for splicing: seeded from the
        # pipeline-parallel paradigm, updated after each group's search
        base_lat = np.zeros(len(batches))
        for key, idxs in groups.items():
            rows, m_cols = key
            seed_lat, _ = group_evals[key]([
                pipeline_parallel(rows, m_cols, hw.n_chiplets)])
            base_lat[idxs] = np.asarray(seed_lat)[:, 0]

    ctx = _SearchContext(
        graphs=graphs, tables=tables, groups=groups,
        group_evals=group_evals, hw=hw, obj=obj, ga_config=ga_config,
        stream_rollout=stream_rollout, base_lat=base_lat, cs=cs,
        device=dev)
    if cs.mode == "joint":
        return _search_joint(ctx)
    return _search_rounds(ctx)


@dataclass
class _SearchContext:
    """Everything the co-search modes share (built once per
    ``search_mapping`` call)."""

    graphs: list
    tables: list
    groups: "dict[tuple, list[int]]"
    group_evals: "dict[tuple, object]"
    hw: HardwareConfig
    obj: Objective
    ga_config: GAConfig
    stream_rollout: StreamRollout | None
    base_lat: np.ndarray | None
    cs: CoSearchConfig
    device: object = None

    def stream_eval_fn(self, key):
        """SLO fitness closure for one group: candidate latencies spliced
        into the LIVE best-known vector (``base_lat`` is read at call
        time, so within-round coordinate descent sees earlier groups'
        updates) and folded into per-request timings on device."""
        group_eval, idxs = self.group_evals[key], self.groups[key]

        def eval_fn(pop):
            lat, _ = group_eval(pop)                        # (B, P)
            full = splice_latencies(self.base_lat, idxs,
                                    np.asarray(lat).T)      # (P, n_batches)
            timings = fold_request_timings(self.stream_rollout, full,
                                           device=self.device)
            return np.asarray(self.obj.score_timings(timings), dtype=float)

        eval_fn.accepts_stacked = True
        return eval_fn

    def total_eval_fn(self, key):
        group_eval = self.group_evals[key]

        def eval_fn(pop):
            lat, en = group_eval(pop)                       # (B, P)
            return self.obj.ga_fitness(np.asarray(lat), np.asarray(en))

        eval_fn.accepts_stacked = True
        return eval_fn

    def oracle_latencies(self, key, enc) -> "list[EvalResult]":
        """Reference-price one group's encoding per batch (the numbers
        ``base_lat`` and the final output are built from)."""
        return [evaluate(self.graphs[i], enc, self.hw, self.tables[i])
                for i in self.groups[key]]

    def rollout_score(self, lat_vec: np.ndarray) -> float:
        """Scenario objective of a full per-batch latency vector."""
        return float(self.obj.score_timings(
            fold_request_timings(self.stream_rollout, lat_vec,
                                 device=self.device)))


def _finalise(ctx: _SearchContext, encodings, ga_results, per_batch, *,
              mode: str, rounds: int, round_scores, converged: bool,
              ga_evaluations: int, group_elites=None) -> MappingSearchOutput:
    lat = float(sum(r.latency_s for r in per_batch))
    en = float(sum(r.energy_j for r in per_batch))
    mc = monetary_cost(ctx.hw)["mc_total"]
    timings = None
    if ctx.stream_rollout is not None and not ctx.stream_rollout.synthetic:
        timings = ctx.stream_rollout.timings(
            np.asarray([r.latency_s for r in per_batch]))
    return MappingSearchOutput(
        encodings=encodings, latency_s=lat, energy_j=en, mc_total=mc,
        score=ctx.obj.score(lat, en, timings=timings),
        ga_results=ga_results, per_batch=per_batch,
        mode=mode, rounds=rounds, round_scores=list(round_scores),
        converged=converged, ga_evaluations=ga_evaluations,
        group_elites=dict(group_elites or {}),
    )


def _same_encoding(a: MappingEncoding, b: MappingEncoding) -> bool:
    return np.array_equal(a.segmentation, b.segmentation) \
        and np.array_equal(a.layer_to_chip, b.layer_to_chip)


def _warm_group_encodings(source, key) -> "list[MappingEncoding]":
    """Per-group warm-start candidates from a cross-mode warm source: a
    completed :class:`MappingSearchOutput` (adopted encoding + final-round
    elites) or a raw ``{group key -> encodings}`` dict. Unknown groups
    yield ``[]`` — ``joint_ga_search`` then disables the warm start
    entirely (every group must contribute a seed to every warm slot).

    Note on coherence: only warm individual 0 — the tuple of ADOPTED
    encodings — is a co-evaluated whole-scenario mapping. Later slots
    pair each group's independently-ranked elites by list position;
    they are strong per-group seeds, not jointly-scored solutions."""
    if isinstance(source, MappingSearchOutput):
        encs = list(source.group_elites.get(key, []))
        if not encs and key in source.encodings:
            encs = [source.encodings[key]]
        return encs
    if isinstance(source, dict):
        v = source.get(key, [])
        if isinstance(v, StackedPopulation):
            return v.to_encodings()
        return list(v)
    raise ValueError(
        "co-search warm_from must be a MappingSearchOutput or a "
        f"{{group key -> encodings}} dict, got {type(source).__name__}")


def _search_rounds(ctx: _SearchContext) -> MappingSearchOutput:
    """Coordinate-descent co-search: ``one_sweep`` runs the historical
    single pass (round 1 of ``fixed_point`` is bit-for-bit identical to
    it — tested); ``fixed_point`` iterates sweeps until no group improves
    the oracle-priced scenario score, warm-starting each group's GA with
    the previous round's elites."""
    cs, groups, obj = ctx.cs, ctx.groups, ctx.obj
    stream_fitness = obj.requires_stream
    n_rounds = 1 if cs.mode == "one_sweep" else max(int(cs.max_rounds), 1)

    encodings: dict[tuple, MappingEncoding] = {}
    ga_results: list[GAResult] = []
    per_batch: list[EvalResult | None] = [None] * len(ctx.graphs)
    warm: dict[tuple, object] = {}
    round_scores: list[float] = []
    evals = 0
    rounds_done = 0
    converged = cs.mode == "one_sweep"   # trivially: nothing to iterate
    budget_hit = False

    for rnd in range(n_rounds):
        # the eval budget never truncates round 1: every group must be
        # searched once for the output to cover the whole rollout
        if rnd > 0 and cs.max_evals is not None and evals >= cs.max_evals:
            budget_hit = True
            break
        improved_any = False
        cfg = ctx.ga_config if rnd == 0 else \
            replace(ctx.ga_config, seed=ctx.ga_config.seed + 7919 * rnd)
        for key, idxs in groups.items():
            rows, m_cols = key
            eval_fn = ctx.stream_eval_fn(key) if stream_fitness \
                else ctx.total_eval_fn(key)
            ws = warm.get(key) if (rnd > 0 and cs.warm_start) else None
            res = ga_search(eval_fn, rows, m_cols, ctx.hw.n_chiplets, cfg,
                            warm_start=ws)
            evals += res.evaluations
            ga_results.append(res)
            if cs.warm_start and res.final_population is not None:
                warm[key] = res.final_population.top_k(res.final_scores,
                                                       cs.warm_elites)
            if rnd == 0:
                adopt = True
            else:
                # guarded adoption: both sides priced consistently on the
                # full rollout, so the round-score sequence is
                # non-increasing by construction (property-tested)
                cand = ctx.oracle_latencies(key, res.best)
                trial = ctx.base_lat.copy()
                trial[idxs] = [r.latency_s for r in cand]
                adopt = obj.improved(ctx.rollout_score(trial),
                                     ctx.rollout_score(ctx.base_lat),
                                     cs.rel_tol)
            if adopt:
                encodings[key] = res.best
                if rnd == 0:
                    with spans.span("search.finalise"):
                        results = ctx.oracle_latencies(key, res.best)
                else:
                    results = cand
                for i, r in zip(idxs, results):
                    per_batch[i] = r
                if stream_fitness:
                    ctx.base_lat[idxs] = [r.latency_s for r in results]
                if rnd > 0:
                    improved_any = True
            if rnd > 0 and cs.max_evals is not None \
                    and evals >= cs.max_evals:
                budget_hit = True
                break
        rounds_done = rnd + 1
        if stream_fitness:
            round_scores.append(ctx.rollout_score(ctx.base_lat))
        if budget_hit:
            break
        if rnd > 0 and not improved_any:
            converged = True
            break

    # cross-mode warm-start carrier: the adopted encoding first, then the
    # final searched round's elites for each group (validated + re-scored
    # by any consumer via ga.validate_warm_start)
    group_elites: dict[tuple, list[MappingEncoding]] = {}
    for key in groups:
        adopted = encodings.get(key)
        es = [adopted.copy()] if adopted is not None else []
        carried = warm.get(key)
        if carried is not None:
            es.extend(e.copy() for e in carried.to_encodings()
                      if adopted is None or not _same_encoding(e, adopted))
        group_elites[key] = es

    with spans.span("search.finalise"):
        return _finalise(
            ctx, encodings, ga_results, per_batch,
            mode=cs.mode, rounds=rounds_done,
            round_scores=round_scores, converged=converged,
            ga_evaluations=evals, group_elites=group_elites)


def _search_joint(ctx: _SearchContext) -> MappingSearchOutput:
    """Joint co-search: one GA population spans every structure group —
    each individual is a whole-scenario mapping, scored on its own full
    latency vector (no best-known splicing). ``cs.warm_from`` seeds up to
    ``cs.warm_fraction`` of the population from a completed run's adopted
    per-group elites (cross-mode warm start), and the per-group mutation
    mask is biased by the SLO violation attribution of each generation's
    best candidate (``cs.violation_bias``)."""
    cs = ctx.cs
    jse = JointStreamEvaluator(ctx.group_evals, ctx.groups,
                               ctx.stream_rollout, ctx.obj,
                               track_bias=cs.violation_bias > 0,
                               device=ctx.device)
    warm = None
    if cs.warm_from is not None and cs.warm_fraction > 0:
        cap = int(round(cs.warm_fraction * ctx.ga_config.population))
        if cap > 0:
            warm = {key: _warm_group_encodings(cs.warm_from, key)[:cap]
                    for key in ctx.groups}
    res = joint_ga_search(jse.scores, {k: k for k in ctx.groups},
                          ctx.hw.n_chiplets, ctx.ga_config,
                          warm_start=warm,
                          mutation_bias=jse.group_bias,
                          violation_bias=cs.violation_bias)

    encodings: dict[tuple, MappingEncoding] = {}
    ga_results: list[GAResult] = []
    per_batch: list[EvalResult | None] = [None] * len(ctx.graphs)
    group_elites: dict[tuple, list[MappingEncoding]] = {}
    for gi, (key, idxs) in enumerate(ctx.groups.items()):
        enc = res.best[key]
        encodings[key] = enc
        for i, r in zip(idxs, ctx.oracle_latencies(key, enc)):
            per_batch[i] = r
        # per-group views of ONE joint run: evaluations attributed to the
        # first view so sum(r.evaluations) == ga_evaluations
        ga_results.append(GAResult(
            best=enc, best_score=res.best_score, history=res.history,
            evaluations=res.evaluations if gi == 0 else 0))
        es = [enc.copy()]
        if res.final_populations is not None:
            top = res.final_populations[key].top_k(res.final_scores,
                                                   cs.warm_elites)
            # the joint best IS the top elite — skip the exact duplicate
            # so every seeded warm slot is a distinct individual
            es.extend(e.copy() for e in top.to_encodings()
                      if not _same_encoding(e, enc))
        group_elites[key] = es
    final = ctx.rollout_score(
        np.asarray([r.latency_s for r in per_batch]))
    return _finalise(
        ctx, encodings, ga_results, per_batch,
        mode="joint", rounds=1, round_scores=[final], converged=True,
        ga_evaluations=res.evaluations, group_elites=group_elites)


def _make_population_eval(graphs, tables, hw, timing_backend, device):
    """Returns eval(population) -> ((B, P) latency_s, (B, P) energy_j) over
    the group's batches.

    ``timing_backend`` selects the pass-B engine: ``oracle`` routes to the
    pure-numpy evaluator (an explicit choice); every other backend runs the
    torch group evaluator on ``device`` — one device call per GA generation
    and device for ALL batches of the group, the population split over the
    devices. Building it raises on failure."""
    backend = get_timing_backend(timing_backend)
    if not isinstance(backend, OracleTimingBackend):
        return GroupPopulationEvaluator(graphs, tables, hw, backend=backend,
                                        device=device).evaluate_population

    def eval_np(population):
        pop = as_stacked(population).to_encodings()
        lat = np.zeros((len(graphs), len(pop)))
        en = np.zeros((len(graphs), len(pop)))
        for bi, (g, t) in enumerate(zip(graphs, tables)):
            for pi, enc in enumerate(pop):
                r = evaluate(g, enc, hw, t)
                lat[bi, pi] = r.latency_s
                en[bi, pi] = r.energy_j
        return lat, en

    return eval_np


@dataclass
class CompassResult:
    hardware: HardwareConfig
    point: HardwarePoint
    mapping: MappingSearchOutput
    bo: BOResult


def scenario_score(scenario: Scenario, objective: Objective | str,
                   latency_s: float, energy_j: float, mc: float,
                   batch_latencies=None) -> float:
    """Score totals under an objective, pricing the scenario's rollout for
    SLO-aware objectives (``batch_latencies``: per-iteration latencies
    aligned with ``scenario.rollout().batches``)."""
    obj = get_objective(objective)
    timings = None
    if obj.requires_stream:
        ro = scenario.rollout()
        if batch_latencies is None:
            raise ValueError(f"objective {obj.name!r} needs per-iteration "
                             "batch latencies")
        timings = ro.timings(np.asarray(batch_latencies))
    return obj.score(latency_s, energy_j, mc, timings)


def hardware_objective(
    scenario: Scenario,
    point: HardwarePoint,
    ga_config: GAConfig | None = None,
    objective: Objective | str | None = None,
    timing_backend: "TimingBackend | str | None" = None,
    co_search: "CoSearchConfig | str | None" = None,
    device: object = None,
) -> tuple[float, MappingSearchOutput]:
    """Fitness of one hardware point: mapping search under the scenario's
    rollout, scored by ``objective`` (default: the scenario's, else
    EDP·MC). ``timing_backend`` / ``co_search`` / ``device`` override the
    scenario's (batched BO uses the ``device`` override to pin each
    concurrently-priced hardware point to its own card)."""
    obj = scenario.resolved_objective() if objective is None \
        else get_objective(objective)
    hw = point.to_config(scenario.target_tops)
    ro = scenario.rollout()
    if obj.requires_stream and ro.synthetic:
        raise ValueError(
            f"objective {obj.name!r} needs per-request timing from a "
            "scheduler rollout; give the Scenario a stream= RequestStream "
            "(the legacy phase/trace/workload shim has synthetic timing)")
    batches = ro.batches
    mbs = [scenario.micro_batch(hw, b) for b in batches]
    backend = scenario.resolved_backend() if timing_backend is None \
        else get_timing_backend(timing_backend)
    cs = scenario.resolved_co_search() if co_search is None \
        else get_co_search(co_search)
    dev = scenario.device if device is None else device
    out = search_mapping(scenario.spec, batches, hw, mbs, ga_config,
                         objective=obj.inner(), n_blocks=scenario.n_blocks,
                         stream_rollout=None if ro.synthetic else ro,
                         timing_backend=backend, co_search=cs,
                         device=dev)
    score = scenario_score(scenario, obj, out.latency_s, out.energy_j,
                           out.mc_total, out.batch_latencies)
    return score, out


def explore(
    scenario: Scenario,
    bo_iters: int = 12,
    bo_init: int = 6,
    ga_config: GAConfig | None = None,
    objective: Objective | str | None = None,
    seed: int = 0,
    timing_backend: "TimingBackend | str | None" = None,
    co_search: "CoSearchConfig | str | None" = None,
    device: object = None,
    bo_batch: int = 1,
    bo_workers: int | None = None,
) -> CompassResult:
    """Full Compass loop (Eq. 1): BO over hardware, GA over mappings, the
    scenario's stream rolled out under its scheduler as the workload.

    The single declarative entry point: everything workload-related lives
    on the ``Scenario`` (``stream=``, ``scheduler=``, ``objective=``,
    ``timing_backend=``, ``co_search=``); ``objective`` /
    ``timing_backend`` / ``co_search`` / ``device`` here override the
    scenario's defaults when given.

    ``bo_batch`` batches the hardware axis: K candidates are proposed per
    BO round (``bo.propose_next_batch``). On a host with several CUDA
    devices and an unpinned CUDA ``device``, a batch is priced
    concurrently — one mapping search per hardware point, pinned to one
    card, round-robin over the cards, up to ``bo_workers`` threads
    (default: min(batch, device count)); under any other ``device`` the
    points are priced serially, each search split over its devices. The
    total evaluation budget is unchanged. ``bo_batch=1`` is the serial loop
    (each search split over the devices).
    """
    devs = resolve_devices(scenario.device if device is None else device)
    cache: dict[tuple, tuple[float, MappingSearchOutput]] = {}

    def price(point: HardwarePoint, on) -> tuple[float, MappingSearchOutput]:
        return hardware_objective(scenario, point, ga_config, objective,
                                  timing_backend, co_search, device=on)

    def obj(point: HardwarePoint) -> float:
        key = point.key()
        if key not in cache:
            cache[key] = price(point, devs)
        return cache[key][0]

    evaluate_batch = None
    if bo_batch > 1:
        def evaluate_batch(points):
            # dedup by key before spending searches; BO never re-proposes
            # a seen key, but init sampling may
            todo = {p.key(): p for p in points if p.key() not in cache}
            pts = list(todo.values())
            # an unpinned CUDA knob prices each point on a card of its own;
            # any other knob prices the points one after another on it
            unpinned = devs == [torch.device("cuda")]
            n_cards = torch.cuda.device_count() if unpinned else 1
            if len(pts) > 1 and n_cards > 1:
                from concurrent.futures import ThreadPoolExecutor

                workers = bo_workers or min(len(pts), n_cards)
                with ThreadPoolExecutor(max_workers=workers) as ex:
                    futs = [
                        ex.submit(price, p,
                                  torch.device("cuda", i % n_cards))
                        for i, p in enumerate(pts)
                    ]
                    for p, f in zip(pts, futs):
                        cache[p.key()] = f.result()
            else:
                for p in pts:
                    cache[p.key()] = price(p, devs)
            return [cache[p.key()][0] for p in points]

    bo = bo_search(obj, scenario.target_tops, iters=bo_iters,
                   init_points=bo_init, seed=seed, batch=bo_batch,
                   evaluate_batch=evaluate_batch)
    best = bo.best_point
    _, mapping = cache[best.key()]
    return CompassResult(
        hardware=best.to_config(scenario.target_tops),
        point=best, mapping=mapping, bo=bo,
    )


# historical name for ``explore`` (paper §V "co-exploration")
co_explore = explore
