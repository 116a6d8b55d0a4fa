"""The plain references against the port at reduced widths on the CPU:
one search generation (the rollout, graphs, cost tables and the whole
population's latency and energy) and one serve step (logits after a
prefill and a decode step, dense and with experts)."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from bench import traffic  # noqa: E402
from bench.search import _port_spec, _ref_spec  # noqa: E402
from bench.weights import make_weights, port_model  # noqa: E402
from reference import model as ref_model  # noqa: E402
from reference.mapping import hardware as rh, population as rp, rollout as rr  # noqa: E402
from reference.mapping import tables as rt, workload as rw  # noqa: E402

DENSE = dict(name="tiny-dense", vocab=256, d_model=64, n_layers=2, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=96, max_seq=256, tie_embeddings=False)
MOE = dict(DENSE, name="tiny-moe", n_kv_heads=4,
           moe=dict(n_routed=8, n_shared=2, top_k=3, d_expert=24))
DENSE_BIAS = dict(DENSE, name="tiny-bias", qkv_bias=True)


@pytest.mark.parametrize("scheduler,slots", [("orca", 16), ("vllm", 40)])
def test_search_generation_matches_the_port(scheduler, slots):
    """vllm over 40 slots makes decode batches past the 16-request
    micro-batch: graphs of several rows."""
    from repro_torch.core.ga import seed_population
    from repro_torch.core.encoding import StackedPopulation
    from repro_torch.core.evaluator import evaluate
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.streams import RequestStream, StreamRequest, rollout
    from repro_torch.core.timing import get_graph_and_tables
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator
    from repro_torch.serving.scheduler import get_scheduler

    t = dict(kind="stream", input={"mean": 78, "sigma": 1.0},
             output={"mean": 483, "sigma": 1.0}, min_len=1, max_len=4096,
             arrival="poisson", rate_per_iter=4.0, n_requests=40, warm_fraction=0.8,
             max_new_tokens_cap=16)
    reqs = traffic.stream_requests(t, 2**31 + 3)
    m = dict(DENSE, moe=None)
    spec = _port_spec({k: v for k, v in m.items() if v is not None})
    ro = rollout(RequestStream.from_requests([StreamRequest(**r) for r in reqs]),
                 get_scheduler(scheduler), max_slots=slots, max_iters=20)
    ref_batches = rr.rollout_batches(reqs, scheduler, slots, 20)
    assert [[(r.kind, r.q_len, r.kv_len) for r in b] for b in ro.batches] == \
        [[(r.kind, r.q_len, r.kv_len) for r in b] for b in ref_batches]
    hw = make_hardware(512, "L")
    rhw = rh.make_hardware(512, "L")
    rspec = _ref_spec(DENSE)
    groups: dict = {}
    for i, b in enumerate(ro.batches):
        mb = hw.micro_batch_decode if any(r.kind == "decode" for r in b) \
            else hw.micro_batch_prefill
        g, tab = get_graph_and_tables(spec, b, hw, mb)
        rg = rw.build_execution_graph(rspec, ref_batches[i], mb, tp=rhw.tensor_parallel)
        rtab = rt.build_tables(rg, rhw)
        for k in ("comp_seconds", "comp_energy_pj", "weight_bytes", "stream_bytes",
                  "output_bytes", "flops"):
            np.testing.assert_array_equal(getattr(tab, k), getattr(rtab, k))
        groups.setdefault((g.rows, g.n_cols), []).append((g, tab, rg, rtab))
    rng = np.random.default_rng(0)
    seen_rows = set()
    for (rows, cols), items in groups.items():
        seen_rows.add(rows)
        pop = StackedPopulation.from_encodings(
            seed_population(rng, rows, cols, hw.n_chiplets, 12))
        lat, en = rp.evaluate_population([x[2] for x in items], [x[3] for x in items],
                                         rhw, pop.segmentation, pop.layer_to_chip)
        for bi, (g, tab, _, _) in enumerate(items):
            for pi, enc in enumerate(pop.to_encodings()):
                e = evaluate(g, enc, hw, tab)
                assert abs(e.latency_s - lat[bi, pi]) <= 1e-12 * e.latency_s
                assert abs(e.energy_j - en[bi, pi]) <= 1e-12 * e.energy_j
        ev = GroupPopulationEvaluator([x[0] for x in items], [x[1] for x in items], hw,
                                      backend="fused", device="cpu")
        plat, pen = ev.evaluate_population(pop)
        np.testing.assert_allclose(plat, lat, rtol=1e-5)
        np.testing.assert_allclose(pen, en, rtol=1e-5)
        blat, ben = rp.evaluate_population([x[2] for x in items], [x[3] for x in items],
                                           rhw, pop.segmentation, pop.layer_to_chip,
                                           rounding="bfloat16")
        assert max(np.max(np.abs(blat - lat) / lat), np.max(np.abs(ben - en) / en)) > 1e-3
    if scheduler == "vllm":
        assert any(r > 1 for r in seen_rows)


@pytest.mark.parametrize("m", [DENSE, DENSE_BIAS, MOE], ids=["dense", "qkv_bias", "moe"])
def test_serve_step_matches_the_port(m, monkeypatch):
    """A prefill of 12 tokens then one decode step through the port's
    kernel-path model functions against the reference's full forward."""
    from repro_torch.models.transformer import (ModelConfig, MoECfg, decode_step,
                                                init_cache, prefill)

    monkeypatch.setenv("REPRO_MOE_CAP", "16")
    torch.backends.cuda.matmul.allow_tf32 = False
    w = make_weights(m, 2**31 + 9, torch.device("cpu"))
    kw = {k: v for k, v in m.items() if k != "moe"}
    cfg = ModelConfig(moe=MoECfg(**m["moe"]) if "moe" in m else None, **kw)
    params = port_model(cfg, w)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, m["vocab"], 13))
    cache = init_cache(cfg, 1, 32, dtype=torch.float32, device="cpu")
    last, cache = prefill(params, cfg, toks[None, :12], cache, impl="kernel", device="cpu")
    served = [int(last[0].argmax())]
    step, _ = decode_step(params, cfg, torch.tensor(served), cache, impl="kernel",
                          device="cpu")
    served.append(int(step[0].argmax()))
    toks = torch.cat([toks[:12], torch.tensor(served[:1])])
    rm = dict(m, rms_norm_eps=1e-6)
    if "moe" in m:
        rm["moe"] = dict(m["moe"], norm_topk_prob=True)
    ref = ref_model.forward_logits(w, rm, toks, torch.tensor([11, 12]))
    scale = float(ref.abs().max())
    assert float((last[0] - ref[0]).abs().max()) <= 1e-5 * scale
    assert float((step[0] - ref[1]).abs().max()) <= 1e-5 * scale
    gaps = ref_model.served_gaps(w, rm, toks[:12].tolist(), served, "cpu")
    assert gaps.max() <= 1e-5 * scale


@pytest.mark.parametrize("rows", [1, 3])
def test_ga_replay_follows_the_ports_search(rows):
    """The reference's GA, fed the populations and fitness of a search of
    the port's GA, makes every one of its generations and its answer;
    the fitness has exact ties, and several rows bring the row operators
    in."""
    from repro_torch.core.ga import GAConfig, ga_search
    from reference.mapping.ga import replay

    ga = dict(population=48, generations=10, tournament_k=3, crossover_rate=0.7,
              mutation_rate=0.9, elite=2)
    pops, fits = [], []

    def fitness(pop):
        pops.append((pop.segmentation.copy(), pop.layer_to_chip.copy()))
        f = (pop.layer_to_chip[:, :, :4] % 3).sum(axis=(1, 2)).astype(float)
        f -= pop.segmentation.sum(axis=1) % 2
        fits.append(f)
        return f

    fitness.accepts_stacked = True
    res = ga_search(fitness, rows, 20, 16, GAConfig(**ga, seed=2**31 + 5))
    bad, (seg, l2c) = replay(2**31 + 5, ga, 16, pops, fits)
    assert bad == 0
    assert np.array_equal(seg, res.best.segmentation)
    assert np.array_equal(l2c, res.best.layer_to_chip)
    # a step that keeps its population unchanged is seen
    pops[5] = pops[4]
    assert replay(2**31 + 5, ga, 16, pops, fits)[0] > 0


def test_near_tied_routes_are_taken_either_way(monkeypatch):
    """A served token's gap is the smallest over the reference and every
    forward with one near-tied route taken the other way."""
    from reference import model as rm_mod

    w = make_weights(MOE, 2**31 + 21, torch.device("cpu"))
    rm = dict(MOE, rms_norm_eps=1e-6, moe=dict(MOE["moe"], norm_topk_prob=True))
    monkeypatch.setattr(rm_mod, "ROUTE_TIE", 1.0)      # every route counts as tied
    prompt = np.random.default_rng(0).integers(0, MOE["vocab"], 12).tolist()
    seq, pos = torch.as_tensor(prompt), torch.tensor([11])
    ties = []
    base = rm_mod.forward_logits(w, rm, seq, pos, ties=ties)[0]
    last = [t for t in ties if t[2] == 11]
    assert last
    alt = rm_mod.forward_logits(w, rm, seq, pos, swap=last[0])[0]
    served = [int((alt - base).argmax())]
    expect = float(base.max() - base[served[0]])
    for tie in ties:
        a = rm_mod.forward_logits(w, rm, seq, pos, swap=tie)[0]
        expect = min(expect, float(a.max() - a[served[0]]))
    got = rm_mod.served_gaps(w, rm, prompt, served, "cpu")
    assert got[0] == pytest.approx(expect, abs=1e-6)
    assert expect < float(base.max() - base[served[0]])
    monkeypatch.setattr(rm_mod, "MAX_SWAPS", 0)
    assert rm_mod.served_gaps(w, rm, prompt, served, "cpu")[0] == pytest.approx(
        float(base.max() - base[served[0]]), abs=1e-6)
