"""Mapping generation engine — genetic algorithm (paper §V-A).

Explores ``segmentation`` and ``layer_to_chip`` for a fixed hardware config
(``micro_batch_size`` / ``tensor_parallel`` belong to the hardware sampling
engine because changing them re-fuses the graph).

* Selection: tournament (fitness-rank within a random k-subset).
* Crossover: bitwise on segmentation; subgraph-level on layer_to_chip (child
  subgraphs determined by the child's segmentation, each inherited intact
  from one parent).
* Mutation: Table III operators 1-7 on layer_to_chip plus bit-flip/bit-swap
  on segmentation, with probabilities annealed from graph-level-heavy
  (exploration) to layer-level-heavy (fine-tuning) over generations.
"""
# GA operators are positionally dispatched through _L2C_OPS/_SEG_OPS
# tables: every operator takes (rng, enc, n_chips) even when n_chips is
# irrelevant
# ruff: noqa: ARG001
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from .. import spans
from .encoding import (
    MappingEncoding,
    StackedPopulation,
    model_parallel,
    pipeline_parallel,
    random_encoding,
)


@dataclass
class GAConfig:
    # Defaults from the (population, generations) sweep in
    # benchmarks/bench_search_throughput.py --sweep (recorded under
    # pop_gen_sweep in BENCH_search.json): at the paper's fixed evaluation
    # budget the annealed operator schedule monotonically favours more
    # generations over larger populations, and per-generation device
    # overhead makes deeper runs nearly wall-free; the sweep's
    # defaults_check measures this shape head-to-head against the previous
    # (64, 40) default at the default budget class.
    population: int = 48
    generations: int = 96
    tournament_k: int = 3
    crossover_rate: float = 0.7
    mutation_rate: float = 0.9
    elite: int = 2
    seed: int = 0
    # pre-filter offspring through the static legality analyzer
    # (repro_torch.analysis.population_legal_mask) before pricing: an illegal
    # child is replaced by a copy of its first parent (already scored
    # legal), consuming no rng draws — with zero rejections the search is
    # bit-identical to verify=False. Off by default: the GA's own
    # operators are closed over the legal space (property-tested in
    # tests/test_analysis.py), so the filter is a guard for custom /
    # warm-started operator stacks, priced in BENCH_search.json.
    verify: bool = False


@dataclass
class GAResult:
    best: MappingEncoding
    best_score: float
    history: list[float] = field(default_factory=list)
    evaluations: int = 0
    # final generation, for elite re-seeding across co-search rounds
    # (compass fixed-point loop); None for the non-GA searchers below
    final_population: StackedPopulation | None = None
    final_scores: np.ndarray | None = None
    # offspring replaced by the GAConfig(verify=True) legality pre-filter
    rejected: int = 0


@dataclass
class JointGAResult:
    """Result of :func:`joint_ga_search` — one best encoding per structure
    group (index-aligned: they came from the same joint individual)."""

    best: "dict[tuple, MappingEncoding]"
    best_score: float
    history: list[float] = field(default_factory=list)
    evaluations: int = 0
    final_populations: "dict[tuple, StackedPopulation] | None" = None
    final_scores: np.ndarray | None = None
    # joint offspring replaced by the legality pre-filter (an individual
    # illegal in ANY group is rejected whole, keeping groups index-aligned)
    rejected: int = 0


# --- Table III mutation operators --------------------------------------------


def _op1_replace_one(rng, enc: MappingEncoding, n_chips: int):
    b = rng.integers(enc.rows)
    l = rng.integers(enc.n_cols)
    enc.layer_to_chip[b, l] = rng.integers(n_chips)


def _op2_swap_adjacent_layer(rng, enc: MappingEncoding, n_chips: int):
    if enc.n_cols < 2:
        return
    b = rng.integers(enc.rows)
    l = rng.integers(enc.n_cols - 1)
    lc = enc.layer_to_chip
    lc[b, l], lc[b, l + 1] = lc[b, l + 1], lc[b, l]


def _op3_swap_adjacent_batch(rng, enc: MappingEncoding, n_chips: int):
    if enc.rows < 2:
        return
    b = rng.integers(enc.rows - 1)
    l = rng.integers(enc.n_cols)
    lc = enc.layer_to_chip
    lc[b, l], lc[b + 1, l] = lc[b + 1, l], lc[b, l]


def _pick_subgraph(rng, enc: MappingEncoding) -> tuple[int, int, int]:
    segs = enc.segments()
    lo, hi = segs[rng.integers(len(segs))]
    return rng.integers(enc.rows), lo, hi


def _op4_permute_subgraph(rng, enc: MappingEncoding, n_chips: int):
    b, lo, hi = _pick_subgraph(rng, enc)
    seg = enc.layer_to_chip[b, lo:hi]
    enc.layer_to_chip[b, lo:hi] = rng.permutation(seg)


def _op5_randomise_subgraph(rng, enc: MappingEncoding, n_chips: int):
    b, lo, hi = _pick_subgraph(rng, enc)
    enc.layer_to_chip[b, lo:hi] = rng.integers(n_chips, size=hi - lo)


def _op6_swap_segment_columns(rng, enc: MappingEncoding, n_chips: int):
    segs = enc.segments()
    if len(segs) < 2:
        return
    i, j = rng.choice(len(segs), size=2, replace=False)
    (lo1, hi1), (lo2, hi2) = segs[i], segs[j]
    w = min(hi1 - lo1, hi2 - lo2)
    lc = enc.layer_to_chip
    tmp = lc[:, lo1:lo1 + w].copy()
    lc[:, lo1:lo1 + w] = lc[:, lo2:lo2 + w]
    lc[:, lo2:lo2 + w] = tmp


def _op7_swap_batches(rng, enc: MappingEncoding, n_chips: int):
    if enc.rows < 2:
        return
    i, j = rng.choice(enc.rows, size=2, replace=False)
    lc = enc.layer_to_chip
    tmp = lc[i].copy()
    lc[i] = lc[j]
    lc[j] = tmp


_L2C_OPS = [_op1_replace_one, _op2_swap_adjacent_layer, _op3_swap_adjacent_batch,
            _op4_permute_subgraph, _op5_randomise_subgraph,
            _op6_swap_segment_columns, _op7_swap_batches]

# impact class per operator: 0 = layer-level, 1 = subgraph-level, 2 = graph-level
_OP_IMPACT = [0, 0, 0, 1, 1, 2, 2]


def _seg_mutate(rng, enc: MappingEncoding):
    if len(enc.segmentation) == 0:
        return
    if rng.random() < 0.5:  # bit-flip
        i = rng.integers(len(enc.segmentation))
        enc.segmentation[i] ^= 1
    else:                   # bit-swap with a neighbour
        if len(enc.segmentation) < 2:
            return
        i = rng.integers(len(enc.segmentation) - 1)
        s = enc.segmentation
        s[i], s[i + 1] = s[i + 1], s[i]


def _op_weights(progress: float) -> np.ndarray:
    """Phase-adaptive operator weights: early generations favour graph-level
    operators, late generations layer-level ones (paper §V-A)."""
    w_layer = 0.2 + 0.6 * progress
    w_sub = 0.3
    w_graph = max(0.05, 0.5 - 0.5 * progress)
    class_w = np.array([w_layer, w_sub, w_graph])
    op_w = np.array([class_w[_OP_IMPACT[i]] for i in range(len(_L2C_OPS))])
    return op_w / op_w.sum()


def mutate(rng, enc: MappingEncoding, n_chips: int, progress: float):
    """Per-individual mutation (the reference/boundary API; the GA inner
    loop uses the vectorised ``mutate_population``)."""
    op = rng.choice(len(_L2C_OPS), p=_op_weights(progress))
    _L2C_OPS[op](rng, enc, n_chips)
    if rng.random() < 0.3:
        _seg_mutate(rng, enc)


def crossover(rng, a: MappingEncoding, b: MappingEncoding) -> MappingEncoding:
    """Bitwise segmentation crossover + subgraph-level layer_to_chip
    inheritance (paper §V-A)."""
    if len(a.segmentation):
        mask = rng.integers(0, 2, size=len(a.segmentation)).astype(bool)
        seg = np.where(mask, a.segmentation, b.segmentation).astype(np.uint8)
    else:
        seg = a.segmentation.copy()
    child = MappingEncoding(seg, a.layer_to_chip.copy())
    for lo, hi in child.segments():
        for row in range(child.rows):
            src = a if rng.random() < 0.5 else b
            child.layer_to_chip[row, lo:hi] = src.layer_to_chip[row, lo:hi]
    return child


# --- vectorised population operators -----------------------------------------
#
# The GA inner loop operates on the stacked (P, rows, M) layer_to_chip
# tensor and (P, M-1) segmentation matrix; per-individual objects are only
# materialised at the API boundary. Semantics match the per-individual
# operators above (same operator set, same probabilities); the subgraph /
# segment-aware operators (4-6) dispatch to the per-individual functions on
# array *views* of their (typically small) subsets, everything else is pure
# array code.


def _k_distinct(rng, n: int, k: int, size: int) -> np.ndarray:
    """(size, k) row-wise distinct draws from [0, n) — vectorised
    without-replacement sampling via argpartition of uniforms."""
    k = min(k, n)
    u = rng.random((size, n))
    return np.argpartition(u, k - 1, axis=1)[:, :k]


def tournament_select(rng, scores: np.ndarray, k: int, n: int) -> np.ndarray:
    """(n,) winner indices of n independent k-tournaments (lower = better)."""
    cand = _k_distinct(rng, len(scores), k, n)
    return cand[np.arange(n), np.argmin(scores[cand], axis=1)]


def crossover_population(rng, seg_a, l2c_a, seg_b,
                         l2c_b) -> tuple[np.ndarray, np.ndarray]:
    """Vectorised crossover of parent-array pairs: bitwise segmentation
    crossover + subgraph-level layer_to_chip inheritance (each child's
    (row, segment) slice comes intact from one parent)."""
    n, m_sub = seg_a.shape
    _, rows, m_cols = l2c_a.shape
    if m_sub:
        mask = rng.integers(0, 2, size=(n, m_sub)).astype(bool)
        seg = np.where(mask, seg_a, seg_b).astype(np.uint8)
    else:
        seg = seg_a.copy()
    # child's segment id per column from its own segmentation bits
    seg_id = np.zeros((n, m_cols), dtype=np.int64)
    if m_cols > 1:
        np.cumsum(seg[:, : m_cols - 1], axis=1, out=seg_id[:, 1:])
    # one parent choice per (child, row, segment-slot)
    choose_a = rng.random((n, rows, m_cols)) < 0.5
    ch = choose_a[np.arange(n)[:, None, None],
                  np.arange(rows)[None, :, None],
                  seg_id[:, None, :]]
    l2c = np.where(ch, l2c_a, l2c_b).astype(np.int32)
    return seg, l2c


def mutate_population(rng, pop: StackedPopulation, n_chips: int,
                      progress: float, rate: float = 1.0,
                      mask: np.ndarray | None = None) -> None:
    """Vectorised phase-adaptive mutation, in place on the stacked arrays.
    Each individual mutates with probability ``rate``; operator and
    segmentation-mutation probabilities match ``mutate``. ``mask`` (a (P,)
    bool array) overrides the ``rate`` draw — joint cross-group search uses
    it to mutate each individual in exactly one structure group."""
    seg, l2c = pop.segmentation, pop.layer_to_chip
    p, rows, m_cols = l2c.shape
    do = np.asarray(mask, dtype=bool) if mask is not None \
        else rng.random(p) < rate
    ops = rng.choice(len(_L2C_OPS), size=p, p=_op_weights(progress))

    idx = np.nonzero(do & (ops == 0))[0]                  # op1: replace one
    if idx.size:
        b = rng.integers(rows, size=idx.size)
        l = rng.integers(m_cols, size=idx.size)
        l2c[idx, b, l] = rng.integers(n_chips, size=idx.size)

    idx = np.nonzero(do & (ops == 1))[0]                  # op2: swap adj layer
    if idx.size and m_cols >= 2:
        b = rng.integers(rows, size=idx.size)
        l = rng.integers(m_cols - 1, size=idx.size)
        tmp = l2c[idx, b, l]
        l2c[idx, b, l] = l2c[idx, b, l + 1]
        l2c[idx, b, l + 1] = tmp

    idx = np.nonzero(do & (ops == 2))[0]                  # op3: swap adj batch
    if idx.size and rows >= 2:
        b = rng.integers(rows - 1, size=idx.size)
        l = rng.integers(m_cols, size=idx.size)
        tmp = l2c[idx, b, l]
        l2c[idx, b, l] = l2c[idx, b + 1, l]
        l2c[idx, b + 1, l] = tmp

    idx = np.nonzero(do & (ops == 6))[0]                  # op7: swap batches
    if idx.size and rows >= 2:
        pair = _k_distinct(rng, rows, 2, idx.size)
        i, j = pair[:, 0], pair[:, 1]
        tmp = l2c[idx, i].copy()
        l2c[idx, i] = l2c[idx, j]
        l2c[idx, j] = tmp

    # segment-aware operators: per-individual on array views of the subset
    for i in np.nonzero(do & np.isin(ops, (3, 4, 5)))[0]:
        _L2C_OPS[ops[i]](rng, MappingEncoding(seg[i], l2c[i]), n_chips)

    # segmentation mutation (bit-flip / neighbour bit-swap, p=0.3)
    if m_cols > 1:
        idx = np.nonzero(do & (rng.random(p) < 0.3))[0]
        if idx.size:
            flip = rng.random(idx.size) < 0.5
            fi = idx[flip]
            if fi.size:
                pos = rng.integers(m_cols - 1, size=fi.size)
                seg[fi, pos] ^= 1
            si = idx[~flip]
            if si.size and m_cols >= 3:
                pos = rng.integers(m_cols - 2, size=si.size)
                tmp = seg[si, pos]
                seg[si, pos] = seg[si, pos + 1]
                seg[si, pos + 1] = tmp


def score_population(eval_fn: Callable, pop: StackedPopulation) -> np.ndarray:
    """Calls ``eval_fn`` with the stacked population when it advertises
    ``accepts_stacked`` (the device-resident path), else with a list of
    ``MappingEncoding`` views (the boundary API)."""
    if getattr(eval_fn, "accepts_stacked", False):
        return np.asarray(eval_fn(pop), dtype=float)
    return np.asarray(eval_fn(pop.to_encodings()), dtype=float)


def seed_population(rng, rows: int, m_cols: int, n_chips: int,
                    size: int) -> list[MappingEncoding]:
    """Initial population: the Algorithm-1 paradigms + random encodings."""
    pop = [
        pipeline_parallel(rows, m_cols, n_chips),
        model_parallel(rows, m_cols, n_chips),
    ]
    while len(pop) < size:
        pop.append(random_encoding(rng, rows, m_cols, n_chips))
    return pop[:size]


def validate_warm_start(encodings, rows: int, m_cols: int,
                        n_chips: int) -> list[MappingEncoding]:
    """Filter warm-start encodings before re-seeding a GA population:
    wrong-shape or out-of-bounds individuals (a group whose shape or chip
    count differs from the carrier's) are dropped, and survivors are
    copied so the new search cannot alias the previous round's arrays.

    Validity is structural only — carried elites carry NO score: the
    best-known latency vector of other structure groups may have changed
    since they were ranked, so ``ga_search`` always re-scores the warm
    population against the current fitness (stale-elite contamination is
    tested in tests/test_ga.py)."""
    from ..analysis.diagnostics import is_legal
    from ..analysis.mapping import verify_encoding

    if isinstance(encodings, StackedPopulation):
        encodings = encodings.to_encodings()
    out = []
    dropped_rules: set[str] = set()
    for enc in encodings:
        if enc.layer_to_chip.shape != (rows, m_cols):
            continue  # other structure group — routine in co-search
        diags = verify_encoding(enc, n_chips)
        if is_legal(diags):
            out.append(enc.copy())
        else:
            dropped_rules.update(d.rule for d in diags)
    if dropped_rules:
        # a shape mismatch is expected across groups; an *illegal* warm
        # encoding means something upstream bred out of contract — say so
        # instead of silently shrinking the warm set
        warnings.warn(
            "validate_warm_start dropped illegal warm-start encodings "
            f"(rules: {', '.join(sorted(dropped_rules))})", stacklevel=2)
    return out


def ga_search(
    eval_fn: Callable[[Sequence[MappingEncoding]], np.ndarray],
    rows: int,
    m_cols: int,
    n_chips: int,
    config: GAConfig | None = None,
    warm_start=None,
) -> GAResult:
    """Minimise ``eval_fn`` (vectorised over a population) over the mapping
    space. Lower score = better.

    The loop is population-batched end to end: selection / crossover /
    mutation operate on the stacked arrays, and ``eval_fn`` receives the
    whole ``StackedPopulation`` when it advertises ``accepts_stacked``
    (one device call per generation), else a list of encodings.
    Device placement lives entirely inside ``eval_fn`` (the torch
    population evaluators) — scores come back in population order either
    way, so the GA itself is placement-agnostic.

    ``warm_start`` (a ``StackedPopulation`` or encoding list, typically the
    previous co-search round's elites) seeds the front of the initial
    population after :func:`validate_warm_start`; the remainder is the
    usual paradigm + random seeding. Warm individuals are re-scored by the
    initial ``score_population`` call — their previous-round scores are
    stale whenever the cross-group best-known latency vector moved."""
    cfg = config or GAConfig()
    rng = np.random.default_rng(cfg.seed)
    init: list[MappingEncoding] = []
    if warm_start is not None:
        init = validate_warm_start(warm_start, rows, m_cols,
                                   n_chips)[: cfg.population]
    if len(init) < cfg.population:
        init += seed_population(rng, rows, m_cols, n_chips,
                                cfg.population - len(init))
    pop = StackedPopulation.from_encodings(init)
    scores = score_population(eval_fn, pop)
    n_eval = len(pop)
    n_rejected = 0
    history = [float(scores.min())]

    for gen in range(cfg.generations):
        with spans.span("ga.breed"):
            progress = gen / max(cfg.generations - 1, 1)
            order = np.argsort(scores)
            elite_seg = pop.segmentation[order[: cfg.elite]].copy()
            elite_l2c = pop.layer_to_chip[order[: cfg.elite]].copy()

            n_child = max(0, cfg.population - cfg.elite)
            with spans.span("ga.select"):
                p1 = tournament_select(rng, scores, cfg.tournament_k, n_child)
                p2 = tournament_select(rng, scores, cfg.tournament_k, n_child)
            with spans.span("ga.crossover"):
                c_seg, c_l2c = crossover_population(
                    rng, pop.segmentation[p1], pop.layer_to_chip[p1],
                    pop.segmentation[p2], pop.layer_to_chip[p2])
                do_cx = rng.random(n_child) < cfg.crossover_rate
                c_seg = np.where(do_cx[:, None], c_seg, pop.segmentation[p1])
                c_l2c = np.where(do_cx[:, None, None], c_l2c,
                                 pop.layer_to_chip[p1])
            children = StackedPopulation(c_seg, c_l2c)
            with spans.span("ga.mutate"):
                mutate_population(rng, children, n_chips, progress,
                                  rate=cfg.mutation_rate)
            if cfg.verify:
                # legality pre-filter: replace illegal offspring with their
                # first parent (legal by induction) BEFORE pricing; no rng
                # is consumed, so a zero-rejection run is bit-identical to
                # verify=False
                from ..analysis.mapping import population_legal_mask
                bad = np.flatnonzero(~population_legal_mask(children,
                                                            n_chips))
                if bad.size:
                    children.segmentation[bad] = pop.segmentation[p1[bad]]
                    children.layer_to_chip[bad] = pop.layer_to_chip[p1[bad]]
                    n_rejected += int(bad.size)

            pop = StackedPopulation(
                np.concatenate([elite_seg, children.segmentation]),
                np.concatenate([elite_l2c, children.layer_to_chip]))
        scores = score_population(eval_fn, pop)
        n_eval += len(pop)
        history.append(float(scores.min()))

    best_i = int(np.argmin(scores))
    return GAResult(best=pop.individual(best_i),
                    best_score=float(scores[best_i]),
                    history=history, evaluations=n_eval,
                    final_population=pop,
                    final_scores=np.asarray(scores, dtype=float),
                    rejected=n_rejected)


def _group_bias_probs(mutation_bias, n_groups: int,
                      violation_bias: float) -> "np.ndarray | None":
    """Resolve the per-group mutation-choice distribution: the violation
    attribution (from ``mutation_bias()``) mixed with uniform by
    ``violation_bias`` — full bias would starve non-violating groups of
    mutation attention entirely, so the uniform floor keeps every group
    explored. Returns ``None`` (uniform draw) when no usable signal."""
    if mutation_bias is None or violation_bias <= 0.0 or n_groups < 2:
        return None
    w = mutation_bias() if callable(mutation_bias) else mutation_bias
    if w is None:
        return None
    w = np.asarray(w, dtype=float)
    if w.shape != (n_groups,) or not np.all(np.isfinite(w)) \
            or np.any(w < 0) or w.sum() <= 0:
        return None
    w = w / w.sum()
    return (1.0 - violation_bias) / n_groups + violation_bias * w


def joint_ga_search(
    eval_fn: Callable,
    shapes: "dict[tuple, tuple[int, int]]",
    n_chips: int,
    config: GAConfig | None = None,
    warm_start: "dict[tuple, Sequence[MappingEncoding]] | None" = None,
    mutation_bias: "Callable | np.ndarray | None" = None,
    violation_bias: float = 0.0,
) -> JointGAResult:
    """One GA population spanning every structure group of a scenario
    (joint cross-group co-search). Individual ``i`` is the tuple of group
    encodings ``(pops[key][i] for key in shapes)`` — the concatenated
    segment encoding of the whole scenario. Like :func:`ga_search`, the
    GA loop never sees device placement: the ``JointStreamEvaluator``
    scores each group's population on its device and the joint loop
    consumes the merged (P,) scores unchanged.

    Selection and crossover act on *shared* parent indices and a shared
    crossover mask, so a child's cross-group genotype stays coupled; each
    mutated individual mutates in exactly one drawn group (the per-group
    mutation mask of ``mutate_population``), keeping per-step mutation
    strength comparable to the per-group GA. The group draw is uniform
    unless ``mutation_bias`` (an (n_groups,) weight vector or a nullary
    callable returning one — e.g.
    ``torch_evaluator.JointStreamEvaluator.group_bias``, the per-group SLO
    violation attribution of the current best candidate) is given:
    weights are then mixed with uniform as ``(1 - violation_bias)/G +
    violation_bias * w``, steering mutation attention toward the group
    whose latencies dominate the current violations.

    ``warm_start`` (group key -> index-aligned encoding lists, e.g. a
    completed fixed-point run's adopted per-group elites) seeds the front
    of every group's initial population: each list is filtered by
    :func:`validate_warm_start` and truncated to the *common* count so
    every warm slot is seeded in every group. Warm individual 0 (the
    adopted-encoding tuple of a fixed-point source) is a co-evaluated
    whole-scenario mapping; later slots pair per-group elites by list
    position — strong per-group seeds, not jointly-scored solutions.
    With an empty/absent warm start the rng draw sequence is
    bit-identical to the cold search (tested in tests/test_coexplore.py).

    ``eval_fn`` receives the dict of index-aligned ``StackedPopulation``
    and returns (P,) minimised scores — no best-known splicing is
    involved, every group's latency comes from the same candidate. With a
    single group the rng draw sequence is identical to :func:`ga_search`
    (joint == spliced one-sweep, tested in tests/test_coexplore.py)."""
    cfg = config or GAConfig()
    rng = np.random.default_rng(cfg.seed)
    keys = list(shapes)
    n_groups = len(keys)
    n_warm = 0
    warm: dict = {}
    if warm_start is not None:
        warm = {k: validate_warm_start(list(warm_start.get(k, [])),
                                       *shapes[k], n_chips) for k in keys}
        n_warm = min((len(warm[k]) for k in keys), default=0)
        n_warm = min(n_warm, cfg.population)
    pops = {}
    for k in keys:
        rows, m_cols = shapes[k]
        init = warm[k][:n_warm] if n_warm else []
        init += seed_population(rng, rows, m_cols, n_chips,
                                cfg.population - n_warm)
        pops[k] = StackedPopulation.from_encodings(init)
    scores = np.asarray(eval_fn(pops), dtype=float)
    n_eval = cfg.population
    n_rejected = 0
    history = [float(scores.min())]

    for gen in range(cfg.generations):
        progress = gen / max(cfg.generations - 1, 1)
        order = np.argsort(scores)
        elite = order[: cfg.elite]
        elites = {k: (pops[k].segmentation[elite].copy(),
                      pops[k].layer_to_chip[elite].copy()) for k in keys}

        n_child = max(0, cfg.population - cfg.elite)
        p1 = tournament_select(rng, scores, cfg.tournament_k, n_child)
        p2 = tournament_select(rng, scores, cfg.tournament_k, n_child)
        crossed = {}
        for k in keys:
            pop = pops[k]
            crossed[k] = crossover_population(
                rng, pop.segmentation[p1], pop.layer_to_chip[p1],
                pop.segmentation[p2], pop.layer_to_chip[p2])
        do_cx = rng.random(n_child) < cfg.crossover_rate
        children = {}
        for k in keys:
            c_seg, c_l2c = crossed[k]
            pop = pops[k]
            c_seg = np.where(do_cx[:, None], c_seg, pop.segmentation[p1])
            c_l2c = np.where(do_cx[:, None, None], c_l2c,
                             pop.layer_to_chip[p1])
            children[k] = StackedPopulation(c_seg, c_l2c)
        if n_groups == 1:
            mutate_population(rng, children[keys[0]], n_chips, progress,
                              rate=cfg.mutation_rate)
        else:
            do = rng.random(n_child) < cfg.mutation_rate
            p = _group_bias_probs(mutation_bias, n_groups, violation_bias)
            grp = rng.choice(n_groups, size=n_child, p=p) if p is not None \
                else rng.integers(n_groups, size=n_child)
            for gi, k in enumerate(keys):
                mutate_population(rng, children[k], n_chips, progress,
                                  mask=do & (grp == gi))
        if cfg.verify:
            # a joint individual illegal in ANY group is replaced whole
            # (every group's slot reverts to parent p1), preserving the
            # cross-group index alignment of the genotype
            from ..analysis.mapping import population_legal_mask
            legal = np.ones(n_child, dtype=bool)
            for k in keys:
                legal &= population_legal_mask(children[k], n_chips)
            bad = np.flatnonzero(~legal)
            if bad.size:
                for k in keys:
                    children[k].segmentation[bad] = \
                        pops[k].segmentation[p1[bad]]
                    children[k].layer_to_chip[bad] = \
                        pops[k].layer_to_chip[p1[bad]]
                n_rejected += int(bad.size)

        pops = {
            k: StackedPopulation(
                np.concatenate([elites[k][0], children[k].segmentation]),
                np.concatenate([elites[k][1], children[k].layer_to_chip]))
            for k in keys
        }
        scores = np.asarray(eval_fn(pops), dtype=float)
        n_eval += cfg.population
        history.append(float(scores.min()))

    best_i = int(np.argmin(scores))
    return JointGAResult(
        best={k: pops[k].individual(best_i) for k in keys},
        best_score=float(scores[best_i]),
        history=history, evaluations=n_eval,
        final_populations=pops,
        final_scores=np.asarray(scores, dtype=float),
        rejected=n_rejected)


def simulated_annealing_search(
    eval_fn: Callable[[Sequence[MappingEncoding]], np.ndarray],
    rows: int,
    m_cols: int,
    n_chips: int,
    iters: int = 400,
    seed: int = 0,
    t0: float = 1.0,
) -> GAResult:
    """Gemini-style simulated-annealing mapping search (baseline, §VI-A)."""
    rng = np.random.default_rng(seed)
    cur = pipeline_parallel(rows, m_cols, n_chips)
    cur_s = float(eval_fn([cur])[0])
    best, best_s = cur.copy(), cur_s
    history = [best_s]
    for it in range(iters):
        t = t0 * (1.0 - it / iters) + 1e-3
        cand = cur.copy()
        mutate(rng, cand, n_chips, progress=it / iters)
        s = float(eval_fn([cand])[0])
        if s < cur_s or rng.random() < np.exp(-(s - cur_s) / (t * max(cur_s, 1e-12))):
            cur, cur_s = cand, s
            if s < best_s:
                best, best_s = cand.copy(), s
        history.append(best_s)
    return GAResult(best=best, best_score=best_s, history=history,
                    evaluations=iters + 1)


def random_search(
    eval_fn: Callable[[Sequence[MappingEncoding]], np.ndarray],
    rows: int,
    m_cols: int,
    n_chips: int,
    budget: int = 400,
    seed: int = 0,
    batch: int = 64,
) -> GAResult:
    """Random mapping search with the same evaluation budget (ablation)."""
    rng = np.random.default_rng(seed)
    best, best_s = None, np.inf
    done = 0
    history = []
    while done < budget:
        n = min(batch, budget - done)
        cand = [random_encoding(rng, rows, m_cols, n_chips) for _ in range(n)]
        s = np.asarray(eval_fn(cand), dtype=float)
        i = int(np.argmin(s))
        if s[i] < best_s:
            best, best_s = cand[i], float(s[i])
        done += n
        history.append(best_s)
    return GAResult(best=best, best_score=best_s, history=history, evaluations=done)
