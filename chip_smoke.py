#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases — any failure raises and the script exits non-zero:

1. build   compile the hand-written CUDA kernels from
           src/repro_torch/kernels/csrc with nvcc (sm_90a) and load them;
2. parity  each kernel against its plain torch version on the card, at the
           main path's shapes (llama3.2-3b graph: rows 4, M 80, T 320;
           B = 3; P in {64, 2048}; both grid orders): bitwise; and both
           against the float64 numpy reference at 1e-5 relative;
3. main    ``explore`` on the canonical llama3.2-3b prefill scenario with the
           default (fused) backend and then with ``kernel``: the same best
           score, each kernel launched, no plain path dispatched, the best
           mapping re-priced on the card equal to the numpy oracle at 1e-4;
           then the golden goodput scenario (orca, joint co-search, the fold
           on the card) against tests/goldens/search_goldens.json;
4. times   CUDA-event times of each kernel and its plain version at
           P in {64, 512, 2048, 4096}, beside the least time the card could
           take for the same bytes (3.35 TB/s) or operations (67 TFLOP/s
           float32) and the measured time of one (b, p) chain alone;
5. profile one hardware point's mapping search (the main path's GA) under
           ``torch.profiler``: wall, device busy time and share, and the
           kernels that take the device time.

``--phases build,parity`` runs a prefix of the phases only and then prints
no result line. The full run prints, last, the card's name and power limit,
one ``{"kernels": [...]}`` line and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("build", "parity", "main", "times", "profile")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/csrc/mapping_eval.cu"
# kernel -> the body of the TPU kernel it replaces
KERNELS = {
    "mapping_eval": "src/repro/kernels/mapping_eval.py:60",
    "mapping_eval_fused": "src/repro/kernels/mapping_eval.py:135",
}
MAIN_POP, MAIN_GENS = 512, 16
PARITY_POPS = (64, 2048)
TIME_POPS = (64, 512, 2048, 4096)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# shared set-up: the canonical scenario and the kernels' inputs
# --------------------------------------------------------------------------


def canonical_scenario():
    from repro_torch.configs import llm_spec
    from repro_torch.core.compass import Scenario
    from repro_torch.core.streams import RequestStream
    from repro_torch.core.traces import SHAREGPT, sample_batches

    batches = sample_batches(SHAREGPT, "prefill", 8, 3, seed=0)
    return Scenario("llama3_2_3b_prefill", llm_spec("llama3.2-3b"),
                    target_tops=512,
                    stream=RequestStream.fixed_batches(batches), n_blocks=4)


def canonical_evaluator(scenario, device):
    """A group evaluator over the scenario's 3 batches on a hardware point
    whose llama3.2-3b graph is rows 4 x M 80 (TP 8, micro-batch 2)."""
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.timing import get_graph_and_tables
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator

    hw = make_hardware(scenario.target_tops, tensor_parallel=8,
                       micro_batch_prefill=2)
    pairs = [get_graph_and_tables(scenario.spec, b, hw, 2, scenario.n_blocks)
             for b in scenario.rollout().batches]
    return GroupPopulationEvaluator([g for g, _ in pairs],
                                    [t for _, t in pairs], hw,
                                    backend="fused", device=device)


def kernel_inputs(ev, pop: int, seed: int) -> dict:
    import numpy as np

    from repro_torch.core.encoding import random_encoding

    rng = np.random.default_rng(seed)
    g = ev.graphs[0]
    encs = [random_encoding(rng, g.rows, g.n_cols, ev.hw.n_chiplets)
            for _ in range(pop)]
    return ev.pass_ab_inputs(encs)


def traffic(name: str, inp: dict) -> tuple[int, int]:
    """(bytes, float32 operations) the kernel's function needs: each input
    read once, each output written once; per (b, p, t) W + 1 maxes and
    one add."""
    n_batch, pop, n_flat = inp["t_proc"].shape
    t_len, width = inp["ppos"].shape[1:]
    n_chips = inp["n_chips"]
    idx_bytes = 4 * pop * t_len * (2 + width)          # chip + ppos (+sched)
    if name == "mapping_eval":
        in_bytes = 4 * n_batch * pop * t_len + 4 * pop * t_len * (1 + width)
    else:
        in_bytes = 4 * n_batch * pop * n_flat + idx_bytes
    out_bytes = 4 * n_batch * pop * (t_len + n_chips)
    ops = n_batch * pop * t_len * (width + 2)
    return in_bytes + out_bytes, ops


def bound(name: str, inp: dict) -> tuple[float, str]:
    nbytes, ops = traffic(name, inp)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def run_kernel(name: str, inp: dict, order: str, plain: bool = False):
    from repro_torch.kernels import mapping_eval as me

    a = (inp["chip"], inp["ppos"], inp["n_chips"])
    if name == "mapping_eval":
        tp = inp["gathered"]
        return (me.mapping_eval_plain(tp, *a) if plain
                else me.mapping_eval_cuda(tp, *a, order))
    tp, sched = inp["t_proc"], inp["sched_idx"]
    return (me.mapping_eval_fused_plain(tp, sched, *a) if plain
            else me.mapping_eval_fused_cuda(tp, sched, *a, order))


def with_gathered(inp: dict) -> dict:
    from repro_torch.kernels import mapping_eval as me

    return dict(inp, gathered=me.gather_sched(
        inp["t_proc"], inp["sched_idx"]).contiguous())


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_build() -> dict:
    from repro_torch.kernels import build
    from repro_torch.kernels import mapping_eval as me

    t0 = time.perf_counter()
    found = build.library_path("mapping_eval.cu").exists()
    lib = build.compile_source("mapping_eval.cu")
    me._lib()
    rec = {"phase": "build", "source": SOURCE, "library": lib.name,
           "compiled_now": not found, "seconds": time.perf_counter() - t0}
    emit(rec)
    return rec


def phase_parity(ev) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import mapping_eval as me
    from repro_torch.kernels import ref

    errs = {name: 0.0 for name in KERNELS}
    for pop in PARITY_POPS:
        inp = with_gathered(kernel_inputs(ev, pop, seed=pop))
        n_batch, _, t_len = inp["gathered"].shape
        plain = {name: run_kernel(name, inp, "batch_major", plain=True)
                 for name in KERNELS}
        outs = {}
        for order in me.GRID_ORDERS:
            for name in KERNELS:
                end, free = run_kernel(name, inp, order)
                torch.cuda.synchronize()
                p_end, p_free = plain[name]
                err = max(float((end - p_end).abs().max()),
                          float((free - p_free).abs().max()))
                errs[name] = max(errs[name], err)
                check(torch.equal(end, p_end) and torch.equal(free, p_free),
                      f"{name} ({order}, P={pop}) differs from its plain "
                      f"version: max abs err {err}")
                outs[(name, order)] = (end, free)
        ref_outs = list(outs.values())
        check(all(torch.equal(o[0], ref_outs[0][0])
                  and torch.equal(o[1], ref_outs[0][1]) for o in ref_outs),
              f"kernels or grid orders disagree at P={pop}")
        # float64 numpy reference on a strided subset of individuals
        sel = np.arange(0, pop, max(1, pop // 32))
        sel_t = torch.as_tensor(sel, device=inp["chip"].device)
        host = {k: inp[k].index_select(1 if k in ("t_proc", "gathered")
                                       else 0, sel_t).cpu().numpy()
                for k in ("t_proc", "gathered", "sched_idx", "chip", "ppos")}
        e_end, e_free = ref.mapping_eval_fused_reference(
            host["t_proc"], host["sched_idx"], host["chip"], host["ppos"],
            inp["n_chips"])
        u_end, u_free = ref.mapping_eval_reference(
            host["gathered"], host["chip"], host["ppos"], inp["n_chips"])
        np.testing.assert_array_equal(e_end, u_end)
        for name in KERNELS:
            end, free = outs[(name, "batch_major")]
            np.testing.assert_allclose(
                end.index_select(1, sel_t).cpu().numpy(), e_end, rtol=1e-5)
            np.testing.assert_allclose(
                free.index_select(1, sel_t).cpu().numpy(), e_free, rtol=1e-5)
        emit({"phase": "parity", "B": n_batch, "P": pop, "T": t_len,
              "W": int(inp["ppos"].shape[-1]), "C": inp["n_chips"],
              "L": int(inp["t_proc"].shape[-1]), "bitwise": True,
              "ref_rtol": 1e-5, "ref_individuals": int(sel.size)})
    return errs


def _explore_once(scenario, backend):
    import torch

    from repro_torch.core import timing
    from repro_torch.core.compass import explore
    from repro_torch.core.ga import GAConfig

    ga = GAConfig(population=MAIN_POP, generations=MAIN_GENS, seed=0)
    timing.clear_timing_backend_stats()            # counts to 0 just before
    t0 = time.perf_counter()
    res = explore(scenario, bo_iters=4, bo_init=3, ga_config=ga, seed=0,
                  timing_backend=backend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = timing.timing_backend_stats()          # read just after
    return res, wall, stats


def _oracle_agreement(scenario, res, device) -> float:
    """Re-price the best mapping on the card and return its largest
    relative gap to the numpy oracle's per-batch latency and energy."""
    from repro_torch.core.timing import get_graph_and_tables
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator

    hw, batches = res.hardware, scenario.rollout().batches
    pairs = [get_graph_and_tables(scenario.spec, b, hw,
                                  scenario.micro_batch(hw, b),
                                  scenario.n_blocks) for b in batches]
    worst = 0.0
    for key, enc in res.mapping.encodings.items():
        idxs = [i for i, (g, _) in enumerate(pairs)
                if (g.rows, g.n_cols) == key]
        ev = GroupPopulationEvaluator([pairs[i][0] for i in idxs],
                                      [pairs[i][1] for i in idxs], hw,
                                      device=device)
        lat, en = ev.evaluate_population([enc])
        for j, i in enumerate(idxs):
            r = res.mapping.per_batch[i]
            worst = max(worst, abs(lat[j, 0] - r.latency_s) / r.latency_s,
                        abs(en[j, 0] - r.energy_j) / r.energy_j)
    return worst


def _golden_goodput(device) -> dict:
    """The golden ``search_goodput_stream`` case, on the card."""
    from repro_torch.core.compass import CoSearchConfig, Scenario, search_mapping
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.objectives import GoodputUnderSLO
    from repro_torch.core.streams import RequestStream
    from repro_torch.core.traces import TraceDistribution
    from repro_torch.core.workload import LLMSpec

    spec = LLMSpec("tiny", 512, 8, 8, 64, 2048, 32000, 8)
    hw = make_hardware(64, "M", tensor_parallel=2)
    cfg = GAConfig(population=8, generations=4, seed=0)
    st = RequestStream("golden", trace=TraceDistribution(
        "small", mean_input=48, mean_output=12, max_len=256), rate=16.0,
        n_requests=32, warm_fraction=0.6, max_new_tokens_cap=6, seed=3)
    sc = Scenario("golden", spec, target_tops=64, stream=st,
                  scheduler="orca", n_blocks=1, max_stream_iters=32)
    ro = sc.rollout()
    mbs = [sc.micro_batch(hw, b) for b in ro.batches]
    kw = dict(objective=GoodputUnderSLO(ttft_slo_s=0.5, tpot_slo_s=0.1),
              n_blocks=1, stream_rollout=ro, device=device)
    one = search_mapping(spec, ro.batches, hw, mbs, cfg, **kw)
    fp = search_mapping(spec, ro.batches, hw, mbs, cfg,
                        co_search=CoSearchConfig(mode="fixed_point",
                                                 max_rounds=4), **kw)
    joint = search_mapping(spec, ro.batches, hw, mbs, cfg, co_search="joint",
                           **kw)
    warm = search_mapping(spec, ro.batches, hw, mbs, cfg,
                          co_search=CoSearchConfig(mode="joint", warm_from=fp,
                                                   warm_fraction=0.5), **kw)
    return {"one_sweep_score": one.score, "fixed_point_score": fp.score,
            "fixed_point_rounds": fp.rounds,
            "fixed_point_converged": fp.converged,
            "joint_score": joint.score, "joint_warm_score": warm.score,
            "n_groups": len(one.encodings), "n_batches": len(ro.batches)}


def _path_ok(stats: dict, kernel: str) -> None:
    """Only the kernel's CUDA path (and the oracle's final pricing) ran."""
    disp = stats["dispatches"]
    check(stats["launches"][kernel] > 0, f"{kernel} was never launched")
    check(set(disp) <= {f"{kernel}:cuda", "oracle"},
          f"unexpected dispatch paths {sorted(disp)}")


def phase_main(scenario, device) -> dict:
    from repro_torch.core import timing

    check(timing.get_timing_backend(None).name == "fused",
          "the default backend is not fused")
    runs = {}
    for label, backend, kernel in (("fused", None, "mapping_eval_fused"),
                                   ("kernel", "kernel", "mapping_eval")):
        res, wall, stats = _explore_once(scenario, backend)
        _path_ok(stats, kernel)
        score = float(res.bo.best_score)
        check(math.isfinite(score) and score > 0, f"best score {score}")
        gap = _oracle_agreement(scenario, res, device)
        check(gap <= 1e-4, f"card vs numpy oracle gap {gap}")
        calls = stats["dispatches"][f"{kernel}:cuda"]
        runs[label] = {"best_score": score, "wall_s": wall,
                       "launches": stats["launches"][kernel],
                       "evaluator_calls": calls,
                       "launches_per_generation":
                           stats["launches"][kernel] / calls,
                       "points": len(res.bo.points),
                       "best_hw": {"spec": res.hardware.spec_name,
                                   "grid": list(res.hardware.grid)},
                       "oracle_gap": gap}
        emit({"phase": "main", "backend": label, "kernel": kernel,
              **runs[label], "dispatches": stats["dispatches"]})
    check(runs["fused"]["best_score"] == runs["kernel"]["best_score"],
          "fused and kernel backends found different best scores")

    with open(ROOT / "tests" / "goldens" / "search_goldens.json") as f:
        golden = json.load(f)["search_goodput_stream"]
    timing.clear_timing_backend_stats()
    got = _golden_goodput(None)
    stats = timing.timing_backend_stats()
    _path_ok(stats, "mapping_eval_fused")
    for key, want in golden["values"].items():
        have = got[key]
        if isinstance(want, (bool, int)):
            check(have == want, f"golden {key}: {have} != {want}")
        else:
            check(math.isfinite(have)
                  and abs(have - want) <= golden["rtol"] * abs(want),
                  f"golden {key}: {have} vs {want}")
    emit({"phase": "golden", "case": "search_goodput_stream", "values": got,
          "rtol": golden["rtol"], "launches": stats["launches"]})
    return runs


def _time_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_times(ev, runs: dict) -> dict:
    from repro_torch.kernels import mapping_eval as me

    at_main = {}
    for pop in TIME_POPS:
        inp = with_gathered(kernel_inputs(ev, pop, seed=pop))
        one = with_gathered({k: (v[:1, :1].contiguous() if k == "t_proc"
                                 else v[:1].contiguous())
                             if hasattr(v, "shape") else v
                             for k, v in inp.items() if k != "gathered"})
        for name in KERNELS:
            by_order = {o: _time_ms(lambda o=o: run_kernel(name, inp, o), 20)
                        for o in me.GRID_ORDERS}
            order = min(by_order, key=by_order.get)
            rec = {
                "kernel": name, "B": int(inp["t_proc"].shape[0]), "P": pop,
                "T": int(inp["chip"].shape[1]),
                "kernel_ms": by_order[order], "grid_order": order,
                "kernel_ms_by_order": by_order,
                "plain_ms": _time_ms(
                    lambda: run_kernel(name, inp, order, plain=True), 3, 1),
                "single_pair_chain_ms": _time_ms(
                    lambda: run_kernel(name, one, "batch_major"), 20),
                "library_ms": None,
            }
            rec["bound_ms"], rec["bound_by"] = bound(name, inp)
            rec["bytes"], rec["f32_ops"] = traffic(name, inp)
            label = "fused" if name == "mapping_eval_fused" else "kernel"
            rec["launches_per_generation"] = \
                runs[label]["launches_per_generation"]
            emit(rec)
            if pop == MAIN_POP:
                at_main[name] = rec
    return at_main


def phase_profile(scenario) -> dict:
    """One BO point's ``hardware_objective`` under ``torch.profiler``. The
    device busy time is the sum of CUDA kernel times (one stream, so no
    overlap); idle share = 1 - busy / wall."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import timing
    from repro_torch.core.bo import random_point
    from repro_torch.core.compass import hardware_objective
    from repro_torch.core.ga import GAConfig

    point = random_point(np.random.default_rng(0), scenario.target_tops)
    ga = GAConfig(population=MAIN_POP, generations=MAIN_GENS, seed=0)
    hardware_objective(scenario, point, ga)        # warm: tables, probe
    timing.clear_timing_backend_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hardware_objective(scenario, point, ga)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    calls = sum(timing.timing_backend_stats()["dispatches"].get(k, 0)
                for k in ("mapping_eval_fused:cuda",))

    def dev_us(e) -> float:
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)

    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    top = sorted(kern, key=dev_us, reverse=True)[:8]
    rec = {"phase": "profile", "wall_ms": wall_ms, "evaluator_calls": calls,
           "device_busy_ms": busy_ms,
           "device_idle_share": (1.0 - busy_ms / wall_ms) if kern else None,
           "kernel_launches": sum(e.count for e in kern),
           "top_kernels": [{"name": e.key[:80], "count": e.count,
                            "ms": dev_us(e) / 1e3} for e in top]}
    if not kern:
        rec["note"] = "the profiler saw no device time"
    emit(rec)
    return rec


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated prefix of " + ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if phases != list(PHASES[:len(phases)]):
        ap.error(f"--phases must be a prefix of {','.join(PHASES)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is missing; run it from the root "
              "of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    for var in ("REPRO_TORCH_TIMING_BACKEND", "REPRO_FUSED_GRID_ORDER",
                "REPRO_VERIFY_MAPPINGS"):
        os.environ.pop(var, None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    build_rec = phase_build()
    if "parity" not in phases:
        return 0
    scenario = canonical_scenario()
    ev = canonical_evaluator(scenario, device)
    errs = phase_parity(ev)
    if "main" not in phases:
        return 0
    runs = phase_main(scenario, device)
    if "times" not in phases:
        return 0
    at_main = phase_times(ev, runs)
    if "profile" not in phases:
        return 0
    phase_profile(scenario)

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    check(not leaked, f"modules of JAX or the JAX package loaded: {leaked}")
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "build_seconds": build_rec["seconds"]})
    print(card_line(), flush=True)
    kernels = []
    for name, replaces in KERNELS.items():
        rec = at_main[name]
        label = "fused" if name == "mapping_eval_fused" else "kernel"
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": runs[label]["launches"],
            "max_abs_err": errs[name], "ms": rec["kernel_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
