"""The port's copies of the search's leftovers against the JAX package on
the same inputs: the goodput-frontier knee search (every case of
``tests/test_frontier.py``, run on both packages' ``frontier`` modules),
the paper's baselines (Gemini-, MOHaM- and SCAR-style, on the tiny
scenario and at the budgets of ``tests/test_compass_system.py``: hardware
points, layouts and encodings exact; latency, energy and score within the
goldens' rtol of 1e-3) and the GA-legality fuzz (the report field for
field). MOHaM's GA prices its populations through the port's population
evaluator with ``device="cpu"`` (the fused kernel's plain version); the JAX
side takes its dense backend on this host."""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.analysis import fuzz as j_fuzz  # noqa: E402
from repro.core import baselines as j_baselines  # noqa: E402
from repro.core import compass as j_compass  # noqa: E402
from repro.core import frontier as j_frontier  # noqa: E402
from repro.core.evaluator import CostTables as JCostTables  # noqa: E402
from repro.core.ga import GAConfig as JGAConfig  # noqa: E402
from repro.core.hardware import make_hardware as j_make_hardware  # noqa: E402
from repro.core.traces import SHAREGPT as J_SHAREGPT  # noqa: E402
from repro.core.workload import LLMSpec as JLLMSpec  # noqa: E402
from repro.core.workload import build_execution_graph as j_graph  # noqa: E402
from repro.core.workload import prefill_request as j_prefill  # noqa: E402
from repro_torch.analysis import fuzz as t_fuzz  # noqa: E402
from repro_torch.core import baselines as t_baselines  # noqa: E402
from repro_torch.core import compass as t_compass  # noqa: E402
from repro_torch.core import frontier as t_frontier  # noqa: E402
from repro_torch.core.encoding import pipeline_parallel  # noqa: E402
from repro_torch.core.evaluator import CostTables, evaluate  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.hardware import make_hardware  # noqa: E402
from repro_torch.core.traces import SHAREGPT  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    LLMSpec,
    build_execution_graph,
    prefill_request,
)

CPU = "cpu"
RTOL = 1e-3                   # the goldens' rule
FRONTIERS = pytest.mark.parametrize("fr", [j_frontier, t_frontier],
                                    ids=["jax", "torch"])
SPEC_ARGS = ("tiny", 512, 8, 8, 64, 2048, 32000, 8)


# --------------------------------------------------------------------------
# frontier: the cases of tests/test_frontier.py on both packages' modules
# --------------------------------------------------------------------------


def _unimodal(knee: float, width: float = 1.0):
    """A smooth goodput curve peaking at ``knee``."""

    def evaluate_(rate):
        return float(np.exp(-((np.log(rate / knee) / width) ** 2))), {}

    return evaluate_


@FRONTIERS
def test_knee_index_prefers_highest_tied_rate(fr):
    pts = [fr.FrontierPoint(0.5, 1.0), fr.FrontierPoint(1.0, 3.0),
           fr.FrontierPoint(2.0, 3.0), fr.FrontierPoint(4.0, 2.0)]
    assert fr.knee_index(pts) == 2
    pts[2].goodput = 3.0 * (1 - 1e-12)
    assert fr.knee_index(pts) == 2
    with pytest.raises(ValueError):
        fr.knee_index([])


@FRONTIERS
def test_interior_knee_brackets_within_tolerance(fr):
    res = fr.refine_knee(_unimodal(1.3), [0.25, 0.5, 1.0, 2.0, 4.0],
                         rel_tol=0.25, max_probes=16)
    assert not res.knee_saturated
    assert res.converged
    lo, hi = res.bracket
    assert lo <= 1.3 <= hi or abs(res.knee_rate - 1.3) <= 0.35
    assert hi - lo <= 0.25 * res.knee_rate
    rates = [p.rate for p in res.points]
    assert rates == sorted(rates) and len(rates) == len(set(rates))


@FRONTIERS
def test_refinement_halves_coarse_bracket(fr):
    res = fr.refine_knee(_unimodal(1.9), [0.5, 1.0, 2.0, 4.0], rel_tol=1e-6,
                         max_probes=2)
    lo, hi = res.bracket
    assert not res.knee_saturated
    assert hi - lo <= (4.0 - 1.0) / 2 + 1e-12


@FRONTIERS
def test_boundary_peak_extends_grid_instead_of_reporting_knee(fr):
    def tent(r):
        return (float(r if r <= 8.0 else 16.0 - r), {})

    res = fr.refine_knee(tent, [0.5, 1.0, 2.0], rel_tol=0.25, max_probes=8)
    assert res.knee_rate == pytest.approx(8.0)
    assert not res.knee_saturated
    res0 = fr.refine_knee(tent, [0.5, 1.0, 2.0], rel_tol=0.25, max_probes=0)
    assert res0.knee_saturated
    assert res0.knee_rate == 2.0
    sat = fr.refine_knee(lambda r: (min(r, 10.0), {}), [0.5, 1.0, 2.0],
                         rel_tol=0.25, max_probes=6)
    assert sat.knee_saturated


@FRONTIERS
def test_low_boundary_peak_extends_down_instead_of_converging(fr):
    res = fr.refine_knee(lambda r: (1.0 / r if r >= 0.2 else r, {}),
                         [0.5, 1.0, 2.0], rel_tol=0.25, max_probes=8,
                         extend_factor=2.0)
    assert any(p.rate < 0.5 for p in res.points)
    assert res.knee_rate < 0.5
    if res.knee_saturated:
        assert not res.converged
    else:
        assert res.bracket[0] < res.knee_rate < res.bracket[1]
    res0 = fr.refine_knee(lambda r: (1.0 / r, {}), [0.5, 1.0, 2.0],
                          rel_tol=0.25, max_probes=0)
    assert res0.knee_saturated
    assert not res0.converged


@FRONTIERS
def test_all_zero_grid_searches_below_not_above(fr):
    def cliff(r):
        return (0.25 - r if r < 0.25 else 0.0, {})

    res = fr.refine_knee(cliff, [0.5, 1.0, 2.0], rel_tol=0.25, max_probes=6,
                         extend_factor=2.0)
    assert all(p.rate <= 2.0 for p in res.points)
    assert any(p.rate < 0.25 for p in res.points)
    assert res.peak_goodput > 0.0


@FRONTIERS
def test_max_rate_caps_extension_and_stays_saturated(fr):
    res = fr.refine_knee(lambda r: (r, {}), [1.0, 2.0], rel_tol=0.25,
                         max_probes=50, extend_factor=2.0, max_rate=16.0)
    assert res.knee_saturated
    assert res.knee_rate <= 16.0
    assert res.probes < 50


@FRONTIERS
def test_input_validation(fr):
    with pytest.raises(ValueError):
        fr.refine_knee(lambda r: (r, {}), [])
    with pytest.raises(ValueError):
        fr.refine_knee(lambda r: (r, {}), [0.0, 1.0])


@FRONTIERS
def test_evaluator_called_once_per_rate(fr):
    calls = []

    def evaluate_(rate):
        calls.append(rate)
        return _unimodal(1.0)(rate)

    res = fr.refine_knee(evaluate_, [0.5, 1.0, 2.0, 1.0, 0.5], rel_tol=0.1,
                         max_probes=6)
    assert len(calls) == len(set(calls))
    assert len(res.points) == len(calls)
    assert res.probes <= 6


def _noisy(calls):
    def evaluate_(rate):
        calls.append(rate)
        return float(np.round(np.sin(rate * 12.9898) * 43758.5453 % 3.0,
                              1)), {}

    return evaluate_


@FRONTIERS
@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 10_000),
       n_coarse=st.integers(1, 5),
       max_probes=st.integers(0, 10),
       rel_tol=st.floats(0.01, 1.0),
       extend=st.floats(1.1, 4.0))
def test_refinement_terminates_under_probe_budget(fr, seed, n_coarse,
                                                  max_probes, rel_tol,
                                                  extend):
    """For ANY evaluator (here a noisy, plateaued one) ``refine_knee``
    spends at most ``max_probes`` evaluations beyond the coarse grid; the
    port's copy probes exactly the rates the JAX package's does."""
    rng = np.random.default_rng(seed)
    coarse = sorted(set(np.round(rng.uniform(0.1, 8.0, n_coarse), 3)))
    calls, ref_calls = [], []
    res = fr.refine_knee(_noisy(calls), coarse, rel_tol=rel_tol,
                         max_probes=max_probes, extend_factor=extend)
    ref = j_frontier.refine_knee(_noisy(ref_calls), coarse, rel_tol=rel_tol,
                                 max_probes=max_probes, extend_factor=extend)
    assert len(calls) <= len(coarse) + max_probes
    assert res.probes <= max_probes
    assert res.points[-1].rate >= res.points[0].rate
    assert any(p.rate == res.knee_rate for p in res.points)
    assert calls == ref_calls
    assert dataclasses.asdict(res) == dataclasses.asdict(ref)


@FRONTIERS
def test_sweep_knee_fixed_grid_bookkeeping(fr):
    calls = []

    def evaluate_(rate):
        calls.append(rate)
        return _unimodal(4.0)(rate)

    res = fr.sweep_knee(evaluate_, [1.0, 2.0, 4.0, 8.0, 16.0])
    assert calls == [1.0, 2.0, 4.0, 8.0, 16.0]
    assert res.knee_rate == 4.0
    assert res.bracket == (2.0, 8.0)
    assert not res.knee_saturated
    assert res.probes == 0 and not res.converged
    res = fr.sweep_knee(_unimodal(100.0), [1.0, 2.0, 4.0])
    assert res.knee_rate == 4.0 and res.knee_saturated
    res = fr.sweep_knee(lambda r: (1.0, {}), [1.0, 2.0, 4.0])
    assert res.knee_rate == 4.0 and res.knee_saturated
    with pytest.raises(ValueError):
        fr.sweep_knee(_unimodal(4.0), [])
    with pytest.raises(ValueError):
        fr.sweep_knee(_unimodal(4.0), [0.0, 1.0])


@pytest.mark.parametrize("knee", [0.3, 1.3, 7.0])
def test_frontier_results_equal_the_jax_package(knee):
    """The whole ``FrontierResult`` (points, meta, bracket, flags) of the
    port's copy equals the JAX package's, refined and swept."""
    coarse = [0.25, 0.5, 1.0, 2.0, 4.0]
    for call in (lambda fr: fr.refine_knee(_unimodal(knee), coarse,
                                           rel_tol=0.1, max_probes=8),
                 lambda fr: fr.sweep_knee(_unimodal(knee), coarse)):
        assert dataclasses.asdict(call(t_frontier)) == \
            dataclasses.asdict(call(j_frontier))


# --------------------------------------------------------------------------
# baselines on tests/test_compass_system.py's tiny scenario
# --------------------------------------------------------------------------


def _scenarios():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        kw = dict(target_tops=64, phase="prefill", batch_size=4, n_batches=2,
                  n_blocks=2)
        j_sc = j_compass.Scenario("t", JLLMSpec(*SPEC_ARGS), trace=J_SHAREGPT,
                                  **kw)
        t_sc = t_compass.Scenario("t", LLMSpec(*SPEC_ARGS), trace=SHAREGPT,
                                  device=CPU, **kw)
    return j_sc, t_sc


@functools.cache
def _baseline(name):
    """(JAX result, port result) of one baseline, made once."""
    j_sc, t_sc = _scenarios()
    if name == "gemini":
        kw = dict(sa_iters=10, grid_subsample=4)
        return (j_baselines.gemini_style_search(j_sc, **kw),
                t_baselines.gemini_style_search(t_sc, **kw))
    kw = dict(generations=2, population=4)
    return (j_baselines.moham_style_search(
                j_sc, ga_config=JGAConfig(population=8, generations=3), **kw),
            t_baselines.moham_style_search(
                t_sc, ga_config=GAConfig(population=8, generations=3), **kw))


def _same_encodings(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, enc in want.items():
        np.testing.assert_array_equal(got[key].segmentation, enc.segmentation)
        np.testing.assert_array_equal(got[key].layer_to_chip,
                                      enc.layer_to_chip)


@pytest.mark.parametrize("name", ["gemini", "moham"])
def test_baseline_matches_jax_package(name):
    want, got = _baseline(name)
    assert got.name == want.name == name
    assert got.point.key() == want.point.key()
    assert got.hardware.layout == want.hardware.layout
    assert got.hardware.n_chiplets == want.hardware.n_chiplets
    _same_encodings(got.encodings, want.encodings)
    for field in ("latency_s", "energy_j", "score", "edp"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=RTOL, err_msg=field)
    assert got.mc_total == want.mc_total
    assert got.latency_s > 0 and got.mc_total > 0


def test_gemini_layout_is_homogeneous():
    _, got = _baseline("gemini")
    assert len(set(got.hardware.layout)) == 1


def test_moham_runs_on_the_population_evaluator():
    """MOHaM's GA fitness is the port's population evaluator: on the CPU
    the fused kernel's plain version (the scenario's default backend), and
    an explicit ``oracle`` backend finds the same design."""
    from repro_torch.core import timing

    _, t_sc = _scenarios()
    kw = dict(generations=1, population=2,
              ga_config=GAConfig(population=8, generations=2))
    timing.clear_timing_backend_stats()
    fused = t_baselines.moham_style_search(t_sc, **kw)
    disp = timing.timing_backend_stats()["dispatches"]
    assert disp.get("mapping_eval_fused:plain", 0) > 0
    oracle = t_baselines.moham_style_search(
        dataclasses.replace(t_sc, timing_backend="oracle"), **kw)
    assert oracle.point.key() == fused.point.key()
    _same_encodings(oracle.encodings, fused.encodings)
    np.testing.assert_allclose(oracle.score, fused.score, rtol=RTOL)


def test_moham_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    _, t_sc = _scenarios()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_baselines.moham_style_search(
            dataclasses.replace(t_sc, device=None), generations=1,
            population=2, ga_config=GAConfig(population=8, generations=2))


def test_scar_mapping_matches_jax_package_and_beats_naive_pipeline():
    """The SCAR-style greedy mapping of tests/test_compass_system.py:
    the same encoding as the JAX package's, priced within 1.5x of the
    naive pipeline."""
    def two_chip_kinds(hw):
        return hw.replace(layout=tuple(["WS", "OS"] * (hw.n_chiplets // 2)))

    lens = [64 * (i + 1) for i in range(4)]
    j_hw = two_chip_kinds(j_make_hardware(256, "M", tensor_parallel=2))
    j_g = j_graph(JLLMSpec(*SPEC_ARGS), [j_prefill(n) for n in lens], 2,
                  tp=2, n_blocks=1)
    hw = two_chip_kinds(make_hardware(256, "M", tensor_parallel=2))
    g = build_execution_graph(LLMSpec(*SPEC_ARGS),
                              [prefill_request(n) for n in lens], 2, tp=2,
                              n_blocks=1)
    t = CostTables.build(g, hw)
    enc = t_baselines.scar_style_mapping(g, hw, t)
    want = j_baselines.scar_style_mapping(j_g, j_hw,
                                          JCostTables.build(j_g, j_hw))
    np.testing.assert_array_equal(enc.segmentation, want.segmentation)
    np.testing.assert_array_equal(enc.layer_to_chip, want.layer_to_chip)
    scar = evaluate(g, enc, hw, t)
    pp = evaluate(g, pipeline_parallel(g.rows, g.n_cols, hw.n_chiplets), hw, t)
    assert scar.latency_s <= pp.latency_s * 1.5


# --------------------------------------------------------------------------
# fuzz
# --------------------------------------------------------------------------


def test_fuzz_report_equals_jax_package():
    got = t_fuzz.run_fuzz(n=120, seed=7, p_corrupt=0.5)
    want = j_fuzz.run_fuzz(n=120, seed=7, p_corrupt=0.5)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.ok and got.trials == 120
    assert got.accepted > 0 and got.rejected > 0 and got.corrupted > 0


def test_fuzz_main_smoke(capsys):
    assert t_fuzz.main(["--n", "40", "--seed", "3", "--progress-every",
                        "20"]) == 0
    out = capsys.readouterr().out
    assert "40 trials" in out and "ok:" in out
