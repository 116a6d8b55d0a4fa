"""The search driver: Compass's mapping search (``core/compass.
search_mapping``) over a stream rolled out under a scheduler, run as whole
searches back to back through the window.

Set-up draws the stream, rolls it out, builds the execution graphs and
cost tables and runs one one-generation search, which builds the
evaluator, uploads its tables and builds the kernels. The window counts
every population evaluation that finished in it; the first call of the
evaluator after the window has closed ends the search it is in. On the
card the device trace spans the whole window, in every run: the device
time of all its work, over the mappings evaluated while it ran, is the
cell's end-to-end number.

The check, after the window: the rollout's batches, every graph's cost
tables, and a sample of the window's generations (drawn from the seed)
recomputed by the plain numpy reference: every individual's latency and
energy on every batch. One of the searches that finished in the window,
drawn from the seed, is followed by the reference's GA from its seed:
each generation it made from the one before, and the mapping it returned
with that mapping's latency and energy over every batch."""
from __future__ import annotations

import os
import time

import numpy as np

from .common import Spans, check


class WindowClosed(Exception):
    """Raised by the evaluator's hook at the first call after the window."""


def _port_spec(m: dict):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.transformer import ModelConfig, MoECfg

    kw = {k: v for k, v in m.items() if k != "moe"}
    moe = MoECfg(**m["moe"]) if m.get("moe") else None
    cfg = ModelConfig(moe=moe, **kw)
    return ArchConfig(arch_id=cfg.name, family="moe" if moe else "dense",
                      model=cfg, source="").llm_spec()


def _ref_spec(m: dict):
    from reference.mapping.workload import LLMSpec, MoESpec

    moe = m.get("moe")
    return LLMSpec(
        name=m["name"], d_model=m["d_model"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"], head_dim=m["head_dim"], d_ff=m["d_ff"],
        vocab=m["vocab"], n_layers=m["n_layers"],
        ffn_gated=m.get("ffn_gated", True), attn_kind=m.get("attn_kind", "gqa"),
        moe=MoESpec(moe["n_routed"], moe["n_shared"], moe["top_k"], moe["d_expert"])
        if moe else None,
        moe_every=m.get("moe_every", 1))


def _model(cell: dict) -> dict:
    return cell["config_data"]["model"]


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, break_eval=None, control: bool = False) -> dict:
    """One run of a search cell. ``break_eval``, for the harness's own
    tests, wraps the evaluator's answers on their way out; ``control``
    also reads the precision control (the reference in bfloat16 in the
    program's place) on the same generations."""
    import torch

    from repro_torch.core.compass import search_mapping
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.streams import RequestStream, StreamRequest, rollout
    from repro_torch.core.timing import get_graph_and_tables
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator
    from repro_torch.serving.scheduler import get_scheduler

    from . import traffic
    from .trace import DeviceTrace

    spans = Spans()
    dev = torch.device(device)
    m = _model(cell)
    hwc, ga = cell["hardware"], cell["ga"]
    with spans.span("stream_and_rollout"):
        reqs = traffic.stream_requests(cell["traffic_data"], seed)
        stream = RequestStream.from_requests([StreamRequest(**r) for r in reqs],
                                             name=cell["traffic"])
        ro = rollout(stream, get_scheduler(cell["scheduler"]),
                     max_slots=cell["max_slots"], max_iters=cell["max_stream_iters"])
        spec = _port_spec(m)
        hw = make_hardware(hwc["target_tops"], hwc["spec"])
        mbs = [hw.micro_batch_decode if any(r.kind == "decode" for r in b)
               else hw.micro_batch_prefill for b in ro.batches]

    def search(gens: int, ga_seed: int):
        return search_mapping(spec, ro.batches, hw, mbs,
                              GAConfig(**dict(ga, generations=gens), seed=ga_seed),
                              objective=cell["objective"],
                              timing_backend=cell["timing_backend"], device=dev)

    with spans.span("graphs_tables_and_warm_search"):
        search(1, seed)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    tr = DeviceTrace() if dev.type == "cuda" else None
    if tr is not None:
        with spans.span("profiler_warm"):
            tr.warm()
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(2)[1])
    n_keep = int(cell["check"]["sampled_generations"])
    kept: list[dict] = []
    st = {"calls": 0, "evals": 0, "traced_calls": 0, "traced_evals": 0,
          "traced_shapes": []}
    fitness = _fitness(cell["objective"])
    cur: dict = {}           # the running search: its seed, populations, fitness
    chosen: dict = {}        # the finished search the check follows
    orig = GroupPopulationEvaluator.evaluate_population
    if tr is not None:
        tr.start()
    w_start = time.perf_counter()
    deadline = w_start + seconds

    def hooked(ev, population):
        if time.perf_counter() >= deadline:
            raise WindowClosed
        t_e = time.perf_counter()
        cur.setdefault("first_eval_at", t_e)
        lat, en = orig(ev, population)
        if break_eval is not None:
            lat, en = break_eval(lat, en)
        cur["eval_s"] += time.perf_counter() - t_e
        seg = np.asarray(population.segmentation)
        l2c = np.asarray(population.layer_to_chip)
        cur["pops"].setdefault(l2c.shape[1:], []).append((seg.copy(), l2c.copy()))
        cur["fits"].setdefault(l2c.shape[1:], []).append(fitness(lat, en))
        if tr is not None and tr.running:
            st["traced_calls"] += 1
            st["traced_evals"] += l2c.shape[0]
            st["traced_shapes"].append((lat.shape[0],) + l2c.shape)
        if time.perf_counter() > deadline:
            return lat, en
        i = st["calls"]
        st["calls"] += 1
        st["evals"] += l2c.shape[0]
        item = None
        if i < n_keep:
            item = len(kept)
            kept.append(None)
        else:
            j = int(rng.integers(0, i + 1))
            if j < n_keep:
                item = j
        if item is not None:
            kept[item] = {"call": i, "seg": seg.copy(), "l2c": l2c.copy(),
                          "lat": np.array(lat), "en": np.array(en)}
        return lat, en

    GroupPopulationEvaluator.evaluate_population = hooked
    cpu_start = os.times()
    searches = 0
    walls, eval_walls, setup_walls = [], [], []
    try:
        while True:
            ga_seed = seed + 7919 * (searches + 1)
            cur.clear()
            cur.update(seed=ga_seed, pops={}, fits={}, eval_s=0.0)
            t_s = time.perf_counter()
            out = search(ga["generations"], ga_seed)
            walls.append(time.perf_counter() - t_s)
            eval_walls.append(cur["eval_s"])
            setup_walls.append(cur["first_eval_at"] - t_s)
            # one finished search kept, each with the same chance
            if int(rng.integers(0, searches + 1)) == 0:
                chosen = dict(cur, out=out)
            searches += 1
    except WindowClosed:
        pass
    finally:
        GroupPopulationEvaluator.evaluate_population = orig
        if tr is not None and tr.running:
            tr.stop()
    w_end = time.perf_counter()
    cpu_end = os.times()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    cur.clear()
    t_c = time.perf_counter()
    checks = _check(cell, reqs, ro, spec, hw, mbs, kept, chosen,
                    get_graph_and_tables, control)
    check_s = time.perf_counter() - t_c
    rec = {"kind": "search", "window_s": float(seconds),
           "window_wall_s": w_end - w_start, "setup_s": w_start - t_process,
           "setup_split": spans.spans, "evals": st["evals"],
           "generations": st["calls"], "searches_finished": searches,
           "search_walls_s": walls, "search_eval_walls_s": eval_walls,
           "search_setup_walls_s": setup_walls, "check_s": check_s,
           # the process's user and system CPU seconds over the window
           "window_cpu_s": [cpu_end.user - cpu_start.user,
                            cpu_end.system - cpu_start.system],
           "traced_calls": st["traced_calls"], "traced_evals": st["traced_evals"],
           "traced_shapes": st["traced_shapes"], "checks": checks,
           "attempted": st["calls"], "failed": 0, "peak_bytes": peak,
           "n_batches": len(ro.batches), "n_chips": hw.n_chiplets,
           "pred_width": _pred_width(spec, ro.batches, hw, mbs)}
    if control:
        rec["control"] = checks.pop()
    if tr is not None and tr.prof is not None:
        rec["trace"] = tr.summary()
    return rec


def _pred_width(spec, batches, hw, mbs) -> int:
    from reference.mapping.population import _pred_columns

    from repro_torch.core.timing import get_graph_and_tables

    g, _ = get_graph_and_tables(spec, batches[0], hw, mbs[0])
    lo = np.array([x.pred_lo for x in g.layers])
    hi = np.array([x.pred_hi for x in g.layers])
    return _pred_columns(lo, hi)[0].shape[1]


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return float("inf")
    den = np.maximum(np.abs(b), 1e-300)
    d = np.abs(a - b) / den
    d = np.where((a == b), 0.0, d)
    return float(d.max(initial=0.0))


TABLE_KEYS = ("comp_seconds", "comp_energy_pj", "weight_bytes", "psum_bytes",
              "output_bytes", "input_reread", "stream_bytes", "extra_write_bytes",
              "out_act_bytes", "flops")


def reference_graphs(cell: dict, reqs: list[dict]):
    """The reference's rollout, graphs and cost tables of a search cell."""
    from reference.mapping import hardware as rh, rollout as rr, tables as rt, \
        workload as rw

    m = _model(cell)
    rspec = _ref_spec(m)
    rhw = rh.make_hardware(cell["hardware"]["target_tops"], cell["hardware"]["spec"])
    batches = rr.rollout_batches(reqs, cell["scheduler"], cell["max_slots"],
                                 cell["max_stream_iters"])
    graphs, tables = [], []
    for b in batches:
        mb = rhw.micro_batch_decode if any(r.kind == "decode" for r in b) \
            else rhw.micro_batch_prefill
        g = rw.build_execution_graph(rspec, b, mb, tp=rhw.tensor_parallel)
        graphs.append(g)
        tables.append(rt.build_tables(g, rhw))
    return batches, graphs, tables, rhw


def _fitness(objective: str):
    from reference.mapping.ga import FITNESS

    if objective not in FITNESS:
        raise ValueError(f"the reference has no GA fitness for objective {objective!r}")
    return FITNESS[objective]


def _check(cell, reqs, ro, spec, hw, mbs, kept, chosen, get_graph_and_tables,
           control: bool = False) -> list[dict]:
    from reference.mapping.ga import SCORE, replay
    from reference.mapping.population import evaluate_population

    lim = cell["check"]["limits"]
    batches, graphs, tables, rhw = reference_graphs(cell, reqs)
    prog = [[(r.kind, r.q_len, r.kv_len) for r in b] for b in ro.batches]
    ref = [[(r.kind, r.q_len, r.kv_len) for r in b] for b in batches]
    n = max(len(prog), len(ref))
    differ = sum(1 for i in range(n)
                 if i >= len(prog) or i >= len(ref) or prog[i] != ref[i])
    out = [check("rollout_batches_differing", float(differ),
                 lim["rollout_batches_differing"])]
    worst = 0.0
    for i, (b, mb) in enumerate(zip(ro.batches, mbs)):
        if i >= len(tables):
            worst = float("inf")
            break
        g, t = get_graph_and_tables(spec, b, hw, mb)
        if (g.rows, g.n_cols) != (graphs[i].rows, graphs[i].n_cols) \
                or g.scale != graphs[i].scale:
            worst = float("inf")
            break
        for k in TABLE_KEYS:
            worst = max(worst, _rel(getattr(t, k), getattr(tables[i], k)))
    out.append(check("cost_table_rel_gap", worst, lim["cost_table_rel_gap"]))

    groups: dict[tuple, list[int]] = {}
    for i, g in enumerate(graphs):
        groups.setdefault((g.rows, g.n_cols), []).append(i)

    def ref_eval(idx, seg, l2c, rounding=None):
        return evaluate_population([graphs[i] for i in idx], [tables[i] for i in idx],
                                   rhw, seg, l2c, rounding=rounding)

    ev_gap, c_ev = 0.0, 0.0
    for k in kept:
        _, rows, cols = k["l2c"].shape
        idx = groups.get((rows, cols), [])
        if len(idx) != k["lat"].shape[0]:
            ev_gap = float("inf")
            continue
        lat, en = ref_eval(idx, k["seg"], k["l2c"])
        ev_gap = max(ev_gap, _rel(k["lat"], lat), _rel(k["en"], en))
        if control:
            cl, ce = ref_eval(idx, k["seg"], k["l2c"], "bfloat16")
            c_ev = max(c_ev, _rel(cl, lat), _rel(ce, en))
    if not kept:
        ev_gap = float("inf")
    out.append(check("eval_rel_gap", ev_gap, lim["eval_rel_gap"]))

    # the followed search: every generation it made, then its answer
    ga_bad, res_gap, c_res = float("inf"), float("inf"), 0.0
    if chosen and set(chosen["pops"]) == set(groups):
        ga_bad, tot, c_tot = 0, np.zeros(2), np.zeros(2)
        for key, idx in groups.items():
            bad, (b_seg, b_l2c) = replay(chosen["seed"], cell["ga"], rhw.n_chiplets,
                                         chosen["pops"][key], chosen["fits"][key])
            enc = chosen["out"].encodings.get(key)
            if enc is None or not (np.array_equal(enc.segmentation, b_seg)
                                   and np.array_equal(enc.layer_to_chip, b_l2c)):
                bad += 1
            ga_bad += bad
            lat, en = ref_eval(idx, b_seg[None], b_l2c[None])
            tot += [lat.sum(), en.sum()]
            if control:
                cl, ce = ref_eval(idx, b_seg[None], b_l2c[None], "bfloat16")
                c_tot += [cl.sum(), ce.sum()]
        score = SCORE[cell["objective"]]
        o = chosen["out"]
        res_gap = max(_rel(o.latency_s, tot[0]), _rel(o.energy_j, tot[1]),
                      _rel(o.score, score(*tot)))
        if control:
            c_res = max(_rel(c_tot[0], tot[0]), _rel(c_tot[1], tot[1]),
                        _rel(score(*c_tot), score(*tot)))
    out.append(check("ga_individuals_differing", float(ga_bad),
                     lim["ga_individuals_differing"]))
    out.append(check("search_result_rel_gap", res_gap, lim["search_result_rel_gap"]))
    if control:
        out.append({"eval_rel_gap": c_ev, "search_result_rel_gap": c_res})
    return out
