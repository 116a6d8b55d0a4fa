"""Baseline DSE methods reimplemented on the Compass encoding (paper §VI-A).

* Gemini-style — single-model DSE: homogeneous dataflow layouts only, the
  workload collapsed to the scenario's *mean* sequence length (padding
  assumption), simulated-annealing mapping search, grid-search hardware.
* MOHaM-style — multi-model DSE: each micro-batch treated as an independent
  model (micro_batch_size forced to 1, so the QKV/FFN merge is impossible),
  joint GA over hardware + mapping.
* SCAR-style — heterogeneity-aware greedy mapping (earliest-finish-time with
  per-dataflow cost lookahead) used in the Fig. 11 ablation.

All baselines are *evaluated on the same test batches* as Compass, exactly as
the paper does: Gemini designs at the mean length, but pays the real
variable-length cost at test time.

The port's copy of the JAX package's module. Its one device call is
MOHaM's GA fitness, which runs the population evaluator on the scenario's
``device`` under its ``timing_backend`` (``None`` = CUDA and the ``fused``
kernel); Gemini-style, SCAR-style and the test-batch pricing run the numpy
oracle, as in the JAX package.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

import numpy as np

from .bo import SYS_CANDIDATES, HardwarePoint, random_point
from .compass import (
    Scenario,
    _make_population_eval,
    scenario_score,
)
from .encoding import MappingEncoding, pipeline_parallel
from .evaluator import CostTables, evaluate
from .ga import GAConfig, ga_search, simulated_annealing_search
from .hardware import DATAFLOWS, HardwareConfig, monetary_cost
from .objectives import Objective
from .traces import fixed_length_batch
from .workload import PREFILL, build_execution_graph


@dataclass
class BaselineResult:
    name: str
    hardware: HardwareConfig
    point: HardwarePoint
    latency_s: float
    energy_j: float
    mc_total: float
    score: float
    encodings: dict = field(default_factory=dict)

    @property
    def edp(self) -> float:
        return self.latency_s * self.energy_j


def _evaluate_on_test(scenario: Scenario, hw: HardwareConfig,
                      encodings: dict, default_mb: int | None = None):
    """Evaluate found (hw, mapping) on the scenario's real test batches.
    Returns totals plus the per-iteration latencies SLO-aware objectives
    need to price the scenario's rollout."""
    batches = scenario.batches(hw)
    lat = en = 0.0
    batch_lat = []
    for batch in batches:
        mb = default_mb if default_mb is not None else scenario.micro_batch(hw, batch)
        g = build_execution_graph(scenario.spec, batch, mb,
                                  tp=hw.tensor_parallel, n_blocks=scenario.n_blocks)
        key = (g.rows, g.n_cols)
        enc = encodings.get(key)
        if enc is None:
            enc = pipeline_parallel(g.rows, g.n_cols, hw.n_chiplets)
        r = evaluate(g, enc, hw)
        lat += r.latency_s
        en += r.energy_j
        batch_lat.append(r.latency_s)
    return lat, en, batch_lat


# --------------------------------------------------------------------------
# Gemini-style
# --------------------------------------------------------------------------


def gemini_style_search(
    scenario: Scenario,
    sa_iters: int = 200,
    objective: Objective | str = "edp_mc",
    grid_subsample: int = 2,
    seed: int = 0,
) -> BaselineResult:
    """Homogeneous layouts, mean-length workload, SA mapping, grid hardware."""
    trace = scenario.trace
    mean_len = int(trace.mean_input if scenario.phase == PREFILL
                   else trace.mean_input + trace.mean_output / 2) if trace else 512

    best = None
    nop_grid = SYS_CANDIDATES[0][::grid_subsample]
    dram_grid = SYS_CANDIDATES[1][::grid_subsample]
    tp_grid = SYS_CANDIDATES[4][::grid_subsample]
    for spec_name, flow, nop, dram, tp in itertools.product(
            ("M", "L"), DATAFLOWS, nop_grid, dram_grid, tp_grid):
        mb = 4 if scenario.phase == PREFILL else 16
        sys_idx = (
            SYS_CANDIDATES[0].index(nop), SYS_CANDIDATES[1].index(dram),
            SYS_CANDIDATES[2].index(min(mb, 4)), SYS_CANDIDATES[3].index(mb),
            SYS_CANDIDATES[4].index(tp),
        )
        from .hardware import CHIPLET_LIBRARY, n_chiplets_for_target
        n = n_chiplets_for_target(scenario.target_tops,
                                  CHIPLET_LIBRARY[spec_name])
        point = HardwarePoint(spec_name, sys_idx,
                              tuple([DATAFLOWS.index(flow)] * n))
        hw = point.to_config(scenario.target_tops)

        # design-time workload: fixed mean length (padding assumption)
        batch = fixed_length_batch(scenario.phase, mean_len, scenario.batch_size)
        g = build_execution_graph(scenario.spec, batch, mb,
                                  tp=hw.tensor_parallel, n_blocks=scenario.n_blocks)
        tables = CostTables.build(g, hw)

        def eval_fn(pop):
            return np.array([
                evaluate(g, enc, hw, tables).edp for enc in pop
            ])

        sa = simulated_annealing_search(eval_fn, g.rows, g.n_cols,
                                        hw.n_chiplets, iters=sa_iters, seed=seed)
        lat, en, b_lat = _evaluate_on_test(scenario, hw,
                                           {(g.rows, g.n_cols): sa.best},
                                           default_mb=mb)
        mc = monetary_cost(hw)["mc_total"]
        score = scenario_score(scenario, objective, lat, en, mc, b_lat)
        if best is None or score < best.score:
            best = BaselineResult("gemini", hw, point, lat, en, mc, score,
                                  {(g.rows, g.n_cols): sa.best})
    return best


# --------------------------------------------------------------------------
# MOHaM-style
# --------------------------------------------------------------------------


def moham_style_search(
    scenario: Scenario,
    generations: int = 10,
    population: int = 16,
    ga_config: GAConfig | None = None,
    objective: Objective | str = "edp_mc",
    seed: int = 0,
) -> BaselineResult:
    """Joint hardware+mapping GA with micro_batch_size forced to 1 (each
    request an independent 'model' — no cross-request merging)."""
    rng = np.random.default_rng(seed)
    ga_cfg = ga_config or GAConfig(population=24, generations=8)

    def eval_hw(point: HardwarePoint):
        hw = point.to_config(scenario.target_tops)
        batches = scenario.batches(hw)
        lat = en = 0.0
        batch_lat = []
        encs = {}
        for batch in batches:
            g = build_execution_graph(scenario.spec, batch, 1,
                                      tp=hw.tensor_parallel,
                                      n_blocks=scenario.n_blocks)
            key = (g.rows, g.n_cols)
            tables = CostTables.build(g, hw)
            if key not in encs:
                eval_pop = _make_population_eval(
                    [g], [tables], hw, scenario.timing_backend,
                    scenario.device)

                def eval_fn(pop, eval_pop=eval_pop):
                    b_lat, b_en = eval_pop(pop)           # (1, P)
                    return (b_lat * b_en)[0]

                eval_fn.accepts_stacked = True
                res = ga_search(eval_fn, g.rows, g.n_cols, hw.n_chiplets, ga_cfg)
                encs[key] = res.best
            r = evaluate(g, encs[key], hw, tables)
            lat += r.latency_s
            en += r.energy_j
            batch_lat.append(r.latency_s)
        mc = monetary_cost(hw)["mc_total"]
        score = scenario_score(scenario, objective, lat, en, mc, batch_lat)
        return score, (lat, en, mc, encs)

    pop = [random_point(rng, scenario.target_tops) for _ in range(population)]
    cache = {}

    def score_of(p):
        if p.key() not in cache:
            cache[p.key()] = eval_hw(p)
        return cache[p.key()][0]

    scores = [score_of(p) for p in pop]
    for _ in range(generations):
        order = np.argsort(scores)
        survivors = [pop[i] for i in order[: max(2, population // 2)]]
        children = []
        while len(children) + len(survivors) < population:
            parent = survivors[rng.integers(len(survivors))]
            from .bo import _inner_move, _outer_move
            child = (_outer_move(rng, parent, scenario.target_tops)
                     if rng.random() < 0.5 else _inner_move(rng, parent))
            children.append(child)
        pop = survivors + children
        scores = [score_of(p) for p in pop]

    best_i = int(np.argmin(scores))
    point = pop[best_i]
    score, (lat, en, mc, encs) = cache[point.key()]
    return BaselineResult("moham", point.to_config(scenario.target_tops),
                          point, lat, en, mc, score, encs)


# --------------------------------------------------------------------------
# SCAR-style greedy heterogeneous mapping (ablation)
# --------------------------------------------------------------------------


def scar_style_mapping(graph, hw: HardwareConfig,
                       tables: CostTables | None = None) -> MappingEncoding:
    """Earliest-finish-time greedy with per-dataflow cost lookahead: each op
    (scheduled layer-first) goes to the chiplet minimising its finish time
    given the chiplet's dataflow-specific cost."""
    tables = tables or CostTables.build(graph, hw)
    rows, m_cols = graph.rows, graph.n_cols
    enc = pipeline_parallel(rows, m_cols, hw.n_chiplets)
    flow_idx = np.array([DATAFLOWS.index(f) for f in hw.layout])
    chip_free = np.zeros(hw.n_chiplets)
    end = np.zeros((rows, m_cols))
    for b, l in enc.scheduled_order():
        pred_done = 0.0
        lo, hi = tables.pred_lo[l], tables.pred_hi[l]
        if lo >= 0:
            pred_done = end[b, lo:hi].max()
        # approximate per-chip processing time: compute + weight DRAM
        t_proc = np.maximum(
            tables.comp_seconds[b, l, flow_idx],
            (tables.weight_bytes[b, l, flow_idx] + tables.stream_bytes[b, l])
            / hw.dram_bw,
        )
        finish = np.maximum(chip_free, pred_done) + t_proc
        chip = int(np.argmin(finish))
        enc.layer_to_chip[b, l] = chip
        end[b, l] = finish[chip]
        chip_free[chip] = finish[chip]
    return enc
