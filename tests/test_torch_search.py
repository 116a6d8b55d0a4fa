"""The port's search entry points reproduce the JAX package's golden search
scores (tests/goldens/search_goldens.json) on the CPU, through the port's
own kernels' plain path, and its spec table matches the reference's."""
import dataclasses
import json
import math
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs
from repro_torch.core import timing as t_timing
from repro_torch.core.compass import (
    CoSearchConfig,
    Scenario,
    explore,
    search_mapping,
)
from repro_torch.core.ga import GAConfig
from repro_torch.core.hardware import make_hardware
from repro_torch.core.objectives import GoodputUnderSLO
from repro_torch.core.streams import RequestStream
from repro_torch.core.traces import TraceDistribution
from repro_torch.core.workload import LLMSpec, prefill_request

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "goldens",
                           "search_goldens.json")
CPU = "cpu"

# the exact inputs of tests/test_golden_search.py, built from the port
SPEC = LLMSpec("tiny", 512, 8, 8, 64, 2048, 32000, 8)
SMALL = TraceDistribution("small", mean_input=48, mean_output=12, max_len=256)
HW = make_hardware(64, "M", tensor_parallel=2)
CFG = GAConfig(population=8, generations=4, seed=0)


def _fixed_batches():
    return [[prefill_request(64), prefill_request(128)],
            [prefill_request(96), prefill_request(192)]]


def _case_edp_fixed_batches():
    out = search_mapping(SPEC, _fixed_batches(), HW, [2, 2], CFG,
                         objective="edp", n_blocks=1, device=CPU)
    return {"score": out.score, "latency_s": out.latency_s,
            "energy_j": out.energy_j, "n_groups": len(out.encodings),
            "ga_evaluations": out.ga_evaluations}


def _case_goodput_stream():
    st = RequestStream("golden", trace=SMALL, rate=16.0, n_requests=32,
                       warm_fraction=0.6, max_new_tokens_cap=6, seed=3)
    sc = Scenario("golden", SPEC, target_tops=64, stream=st,
                  scheduler="orca", n_blocks=1, max_stream_iters=32)
    ro = sc.rollout()
    mbs = [sc.micro_batch(HW, b) for b in ro.batches]
    obj = GoodputUnderSLO(ttft_slo_s=0.5, tpot_slo_s=0.1)
    kw = dict(objective=obj, n_blocks=1, stream_rollout=ro, device=CPU)
    one = search_mapping(SPEC, ro.batches, HW, mbs, CFG, **kw)
    fp = search_mapping(SPEC, ro.batches, HW, mbs, CFG,
                        co_search=CoSearchConfig(mode="fixed_point",
                                                 max_rounds=4), **kw)
    joint = search_mapping(SPEC, ro.batches, HW, mbs, CFG, co_search="joint",
                           **kw)
    warm = search_mapping(SPEC, ro.batches, HW, mbs, CFG,
                          co_search=CoSearchConfig(mode="joint", warm_from=fp,
                                                   warm_fraction=0.5), **kw)
    return {"one_sweep_score": one.score, "fixed_point_score": fp.score,
            "fixed_point_rounds": fp.rounds,
            "fixed_point_converged": fp.converged,
            "joint_score": joint.score, "joint_warm_score": warm.score,
            "n_groups": len(one.encodings), "n_batches": len(ro.batches)}


def _case_explore_fixed():
    sc = Scenario("golden-explore", SPEC, target_tops=64,
                  stream=RequestStream.fixed_batches(_fixed_batches()),
                  n_blocks=1)
    res = explore(sc, bo_iters=2, bo_init=2, ga_config=CFG, seed=0,
                  device=CPU)
    return {"bo_best_score": res.bo.best_score, "edp": res.mapping.edp,
            "n_chiplets": res.hardware.n_chiplets}


CASES = {
    "search_edp_fixed_batches": _case_edp_fixed_batches,
    "search_goodput_stream": _case_goodput_stream,
    "explore_edp_mc_fixed": _case_explore_fixed,
}


def check_golden(name: str, got: dict, golden: dict) -> None:
    """Floats within the golden's rtol; ints and bools exact."""
    assert set(got) == set(golden["values"])
    rtol = golden["rtol"]
    for key, want in golden["values"].items():
        have = got[key]
        if isinstance(want, bool) or isinstance(have, bool):
            assert have == want, f"{name}.{key}: {have!r} != {want!r}"
        elif isinstance(want, int):
            assert have == want, f"{name}.{key}: {have!r} != {want!r}"
        else:
            assert math.isfinite(have), f"{name}.{key} is {have}"
            assert have == pytest.approx(want, rel=rtol), \
                f"{name}.{key}: {have!r} != golden {want!r}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_reproduces_golden(name):
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)[name]
    t_timing.clear_timing_backend_stats()
    got = CASES[name]()
    check_golden(name, got, golden)
    # the default backend is `fused`; on CPU tensors it is the plain path,
    # and the counters say so (no kernel launched, no other GA path ran;
    # `oracle` is the numpy pricing of each group's final best mapping)
    stats = t_timing.timing_backend_stats()
    assert stats["dispatches"].get("mapping_eval_fused:plain", 0) > 0
    assert set(stats["dispatches"]) == {"mapping_eval_fused:plain", "oracle"}
    assert sum(stats["launches"].values()) == 0


def test_golden_edp_case_same_on_every_backend():
    """`dense`, `kernel` and `fused` agree bitwise, so the seeded GA takes
    the same path on each: identical scores, each counted by name."""
    scores = {}
    for backend in ("dense", "kernel", "fused"):
        t_timing.clear_timing_backend_stats()
        out = search_mapping(SPEC, _fixed_batches(), HW, [2, 2], CFG,
                             objective="edp", n_blocks=1, device=CPU,
                             timing_backend=backend)
        scores[backend] = out.score
        path = {"dense": "dense", "kernel": "mapping_eval:plain",
                "fused": "mapping_eval_fused:plain"}[backend]
        assert set(t_timing.timing_backend_stats()["dispatches"]) \
            == {path, "oracle"}
    assert scores["dense"] == scores["kernel"] == scores["fused"]


def test_batched_bo_on_one_device_and_cache_stats():
    """bo_batch > 1 on one device prices the batch serially at the same
    total budget; cache_stats reports the caches and the paths that ran."""
    import json as _json

    from repro_torch.core import cache_stats

    sc = Scenario("golden-explore", SPEC, target_tops=64,
                  stream=RequestStream.fixed_batches(_fixed_batches()),
                  n_blocks=1)
    t_timing.clear_timing_backend_stats()
    res = explore(sc, bo_iters=2, bo_init=2, ga_config=CFG, seed=0,
                  bo_batch=2, device=CPU)
    assert len(res.bo.points) == 4
    assert math.isfinite(res.bo.best_score)
    stats = cache_stats()
    _json.dumps(stats)
    assert stats["timing_backend"]["dispatches"]["mapping_eval_fused:plain"] > 0
    assert stats["cost_tables"]["tables"] > 0
    assert stats["device_tables"]["entries"] > 0
    assert stats["device_resident_bytes"].get("cpu", 0) > 0
    assert stats["serving"]["engine_runs"] >= 0


@pytest.mark.cuda
def test_batched_bo_across_cards_matches_one_card():
    """explore(bo_batch=4) prices a batch's points concurrently, one card
    each, when CUDA is unpinned and there are several cards; pinned to one
    card it prices them serially. Both give the same BO history."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from repro_torch.core.traces import SHAREGPT, sample_batches

    sc = Scenario("llama3_2_3b_prefill", t_configs.llm_spec("llama3.2-3b"),
                  target_tops=512, n_blocks=4,
                  stream=RequestStream.fixed_batches(
                      sample_batches(SHAREGPT, "prefill", 8, 3, seed=0)))
    cfg = GAConfig(population=64, generations=4, seed=0)
    kw = dict(bo_iters=4, bo_init=4, ga_config=cfg, seed=0, bo_batch=4)
    spread = explore(sc, **kw)
    one = explore(sc, device="cuda:0", **kw)
    assert [p.key() for p in spread.bo.points] == \
        [p.key() for p in one.bo.points]
    assert spread.bo.scores == one.bo.scores


@pytest.mark.parametrize("arch", sorted(t_configs.all_archs()))
def test_spec_table_matches_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import all_archs

    ref = all_archs()[arch].llm_spec()
    got = t_configs.llm_spec(arch)
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        if dataclasses.is_dataclass(want):      # the MoE spec, field by field
            assert dataclasses.asdict(getattr(got, f.name)) == \
                dataclasses.asdict(want), f.name
        else:
            assert getattr(got, f.name) == want, f.name
    assert got.active_param_count() == ref.active_param_count()


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown arch"):
        t_configs.llm_spec("no-such-model")
