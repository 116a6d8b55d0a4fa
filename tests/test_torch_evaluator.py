"""The port's torch population evaluators against the JAX package's
(``repro.core.jax_evaluator``, dense backend) on identical inputs: the
reference builds graphs, tables and populations, and the port receives
copies through its interop functions.

Tolerances: lat / end / free / tproc_sched 1e-6 relative (the same float32
ops in the same order, up to XLA's fusion choices); energy 1e-5 relative,
because its float32 sum over rows * M runs in another order.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import jax_evaluator as j_eval
from repro.core.encoding import pipeline_parallel, random_encoding
from repro.core.evaluator import CostTables as JCostTables
from repro.core.evaluator import evaluate as j_evaluate
from repro.core.hardware import make_hardware
from repro.core.workload import (
    LLMSpec,
    MoESpec,
    build_execution_graph,
    decode_request,
    prefill_request,
)
from repro_torch.core import interop
from repro_torch.core import timing as t_timing
from repro_torch.core import torch_evaluator as t_eval
from repro_torch.core.evaluator import CostTables as TCostTables
from repro_torch.core.workload import build_execution_graph as t_build_graph

# the three specs of tests/test_jax_evaluator.py
SPECS = [
    (LLMSpec("dense", 256, 4, 4, 64, 1024, 1000, 8),
     [prefill_request(128), prefill_request(64), decode_request(300),
      decode_request(80)], 2),
    (LLMSpec("moe", 256, 4, 2, 64, 1024, 1000, 8,
             moe=MoESpec(8, 1, 2, 128)),
     [decode_request(100 + 37 * i) for i in range(6)], 3),
    (LLMSpec("mamba", 256, 0, 0, 64, 0, 1000, 8, attn_kind="none",
             mixer="mamba", d_inner=512, ssm_state=16),
     [prefill_request(200), decode_request(500)], 1),
]
BACKENDS = ("dense", "kernel", "fused")


def _hw():
    hw = make_hardware(64, "M", layout=None, tensor_parallel=2)
    return hw.replace(layout=tuple(["WS", "OS"] * (hw.n_chiplets // 2)))


def _port_graph(spec, batch, mb):
    """The port's own graph of the same workload (built from copied
    fields, not from the reference's objects)."""
    t_spec = interop.spec_from(spec)
    t_batch = [interop.request_from(r) for r in batch]
    return t_build_graph(t_spec, t_batch, micro_batch_size=mb, tp=2,
                         n_blocks=2)


def _population(g, hw, n=8, seed=0):
    rng = np.random.default_rng(seed)
    pop = [pipeline_parallel(g.rows, g.n_cols, hw.n_chiplets)]
    pop += [random_encoding(rng, g.rows, g.n_cols, hw.n_chiplets)
            for _ in range(n - 1)]
    return pop


def _numpy(outs) -> list:
    """The five ``_run(full=True)`` outputs as numpy arrays."""
    return [x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
            for x in outs]


def _assert_full(got, want):
    """got / want: (lat, energy_pj, end, free, tproc_sched)."""
    got, want = _numpy(got), _numpy(want)
    for i in (0, 2, 3, 4):                  # lat, end, free, tproc_sched
        np.testing.assert_allclose(got[i], want[i], rtol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)     # energy


@pytest.mark.parametrize("case", range(len(SPECS)))
def test_cost_tables_build_bitwise(case):
    spec, batch, mb = SPECS[case]
    hw = _hw()
    g = build_execution_graph(spec, batch, micro_batch_size=mb, tp=2,
                              n_blocks=2)
    ref = JCostTables.build(g, hw)
    got = TCostTables.build(_port_graph(spec, batch, mb),
                            interop.hardware_from(hw))
    for f in dataclasses.fields(JCostTables):
        np.testing.assert_array_equal(getattr(got, f.name),
                                      getattr(ref, f.name), err_msg=f.name)
    # interop copies a table set field for field
    copied = interop.cost_tables_from(ref)
    for f in dataclasses.fields(JCostTables):
        np.testing.assert_array_equal(getattr(copied, f.name),
                                      getattr(ref, f.name))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", range(len(SPECS)))
def test_population_evaluator_full_matches_jax(case, backend):
    spec, batch, mb = SPECS[case]
    hw = _hw()
    g = build_execution_graph(spec, batch, micro_batch_size=mb, tp=2,
                              n_blocks=2)
    tables = JCostTables.build(g, hw)
    pop = _population(g, hw)
    want = j_eval.PopulationEvaluator(g, tables, hw, backend="dense")._run(
        pop, full=True)

    t_hw = interop.hardware_from(hw)
    t_g = _port_graph(spec, batch, mb)
    pe = t_eval.PopulationEvaluator(t_g, TCostTables.build(t_g, t_hw), t_hw,
                                    backend=backend, device="cpu")
    t_pop = interop.population_from(pop)
    _assert_full(pe._run(t_pop, full=True), want)

    # the scaled entry point agrees with the numpy oracle per individual
    lat, en = pe.evaluate_population(t_pop)
    for i, enc in enumerate(pop):
        r = j_evaluate(g, enc, hw, tables)
        assert lat[i] == pytest.approx(r.latency_s, rel=1e-4)
        assert en[i] == pytest.approx(r.energy_j, rel=1e-4)
    tm = pe.timing_matrix(t_pop)
    np.testing.assert_allclose(tm.makespan_s, lat, rtol=1e-12)


@pytest.mark.parametrize("backend", BACKENDS)
def test_group_evaluator_full_matches_jax(backend):
    """The grouped multi-batch case of tests/test_batched_search.py."""
    spec = SPECS[0][0]
    hw = _hw()
    batches = [
        [prefill_request(128), prefill_request(64), decode_request(300)],
        [prefill_request(30), prefill_request(31), decode_request(77)],
    ]
    graphs = [build_execution_graph(spec, b, 2, tp=2, n_blocks=2)
              for b in batches]
    tables = [JCostTables.build(g, hw) for g in graphs]
    rng = np.random.default_rng(0)
    pop = [random_encoding(rng, graphs[0].rows, graphs[0].n_cols,
                           hw.n_chiplets) for _ in range(6)]
    want = j_eval.GroupPopulationEvaluator(graphs, tables, hw,
                                           backend="dense")._run(
        pop, full=True)

    t_hw = interop.hardware_from(hw)
    t_graphs = [_port_graph(spec, b, 2) for b in batches]
    ge = t_eval.GroupPopulationEvaluator(
        t_graphs, [interop.cost_tables_from(t) for t in tables], t_hw,
        backend=backend, device="cpu")
    t_pop = interop.population_from(pop)
    _assert_full(ge._run(t_pop, full=True), want)
    lat, en = ge.evaluate_population(t_pop)
    j_lat, j_en = j_eval.GroupPopulationEvaluator(
        graphs, tables, hw, backend="dense").evaluate_population(pop)
    assert lat.shape == (2, 6) and en.shape == (2, 6)
    np.testing.assert_allclose(lat, j_lat, rtol=1e-6)
    np.testing.assert_allclose(en, j_en, rtol=1e-5)


def test_backends_agree_bitwise_and_are_counted():
    """dense, kernel and fused give bitwise-equal outputs on the CPU, and
    each call is counted under the path that ran."""
    spec, batch, mb = SPECS[0]
    t_hw = interop.hardware_from(_hw())
    t_g = _port_graph(spec, batch, mb)
    tables = TCostTables.build(t_g, t_hw)
    pop = interop.population_from(_population(t_g, t_hw))
    outs = {}
    for backend in BACKENDS:
        t_timing.clear_timing_backend_stats()
        pe = t_eval.PopulationEvaluator(t_g, tables, t_hw, backend=backend,
                                        device="cpu")
        outs[backend] = _numpy(pe._run(pop, full=True))
        path = {"dense": "dense", "kernel": "mapping_eval:plain",
                "fused": "mapping_eval_fused:plain"}[backend]
        assert t_timing.timing_backend_stats()["dispatches"] == {path: 1}
    for i, dense in enumerate(outs["dense"]):
        np.testing.assert_array_equal(outs["kernel"][i], dense)
        np.testing.assert_array_equal(outs["fused"][i], dense)


def test_device_table_cache_is_keyed_on_content():
    spec, batch, mb = SPECS[0]
    t_hw = interop.hardware_from(_hw())
    t_g = _port_graph(spec, batch, mb)
    a = TCostTables.build(t_g, t_hw)
    b = interop.cost_tables_from(a)             # equal content, new object
    t_eval.clear_device_table_cache()
    t_eval.GroupPopulationEvaluator([t_g], [a], t_hw, device="cpu")
    t_eval.GroupPopulationEvaluator([t_g], [b], t_hw, device="cpu")
    stats = t_eval.device_table_cache_stats()
    assert (stats["hits"], stats["misses"], stats["entries"]) == (1, 1, 1)
    b.comp_seconds = b.comp_seconds * 2.0       # new content, new entry
    t_eval.GroupPopulationEvaluator([t_g], [b], t_hw, device="cpu")
    assert t_eval.device_table_cache_stats()["entries"] == 2


def test_oracle_backend_has_no_population_path():
    spec, batch, mb = SPECS[0]
    t_hw = interop.hardware_from(_hw())
    t_g = _port_graph(spec, batch, mb)
    with pytest.raises(ValueError, match="oracle"):
        t_eval.PopulationEvaluator(t_g, TCostTables.build(t_g, t_hw), t_hw,
                                   backend="oracle", device="cpu")


def test_verify_gate_rejects_illegal_population(monkeypatch):
    from repro_torch.analysis import MappingLegalityError

    spec, batch, mb = SPECS[0]
    t_hw = interop.hardware_from(_hw())
    t_g = _port_graph(spec, batch, mb)
    pe = t_eval.PopulationEvaluator(t_g, TCostTables.build(t_g, t_hw), t_hw,
                                    device="cpu")
    pop = interop.population_from(_population(t_g, t_hw, n=2))
    pop.layer_to_chip[1, 0, 0] = t_hw.n_chiplets     # out of range
    monkeypatch.setenv("REPRO_VERIFY_MAPPINGS", "1")
    with pytest.raises(MappingLegalityError):
        pe.evaluate_population(pop)
