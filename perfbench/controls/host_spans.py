"""The program's host spans on the card: a cell's traced runs with the
span recorder on over the device trace, the recorder's cost in turns,
and how well the spans' clock lines up with the device trace's.

    python3 perfbench/controls/host_spans.py trace --workload <cell> --seeds 3 [--seconds 50]
    python3 perfbench/controls/host_spans.py cost --workload <cell> [--pairs 3]
    python3 perfbench/controls/host_spans.py align [--reps 20]
    python3 perfbench/controls/host_spans.py micro

``trace`` runs the cell as ``run.py --trace 1`` does, with the recorder
turned on when the device trace starts and off when it stops; it prints,
per seed, the ``host_spans`` line (the spans that took most host time and
most idle device time), then one JSON line: the cell's metrics, the span
readings of ``bench/host_spans.py`` and ``correct``. ``cost`` times the
cell's program work with the recorder off and on in turns (off, on, on,
off, ...) in one process: whole searches at the cell's sizes, or serves
of 8 decoding lanes cut at a fixed iteration count. ``align`` brackets
``torch.cuda._sleep`` and a synchronise in a span under the profiler, and
prints how far each span's ends lie from its kernel's. ``micro`` times a
``span`` call off and on, on the host. Each needs the card but ``micro``."""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

from bench import common  # noqa: E402


def _span_trace_class():
    """``DeviceTrace`` with the recorder on while it runs, whose summary
    also holds the recorder's summary and the idle seconds by span."""
    from repro_torch import spans

    from bench import host_spans, trace

    class SpanTrace(trace.DeviceTrace):
        def start(self):
            super().start()
            spans.start()

        def stop(self):
            spans.stop()
            super().stop()

        def summary(self, top: int = 10):
            out = super().summary(top)
            s = spans.summary()
            busy = host_spans.device_busy_ns(self.prof)
            out["program_spans"] = s
            out["idle_by_span"] = host_spans.attribute_idle(
                busy, s.get("spans", {}), s["start_ns"], s["stop_ns"])
            return out

    return trace, SpanTrace


def cmd_trace(a) -> int:
    import run
    from bench import host_spans

    trace, SpanTrace = _span_trace_class()
    orig = trace.DeviceTrace
    trace.DeviceTrace = SpanTrace
    try:
        for i in range(a.seeds):
            seed = a.first_seed + 7_919 * i
            t = time.perf_counter()
            rec, res = run.run_cell(a.workload, seed, a.seconds, True, t_process=t)
            tr = rec["trace"]
            kind = rec["kind"]
            sp = tr["program_spans"].get("spans", {})
            idle = tr["idle_by_span"]
            print(host_spans.host_spans_line(sp, idle), flush=True)
            print(json.dumps({
                "seed": seed, "correct": res["correct"], "metrics": res["metrics"],
                "spans": host_spans.readings(kind, sp, idle),
                "window_s": tr["window_s"], "busy_s": tr["busy_s"],
                "idle_total_s": sum(idle.values()),
                "stretch_s": (tr["program_spans"]["stop_ns"]
                              - tr["program_spans"]["start_ns"]) / 1e9,
                "run": {k: rec[k] for k in ("generations", "evals", "searches_finished",
                                            "tokens", "decode_calls") if k in rec}}),
                flush=True)
            del rec, res
            _free()
    finally:
        trace.DeviceTrace = orig
    return 0


def _free():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _turns(n_pairs: int) -> list[bool]:
    """off, on, on, off, off, on, ... (``True`` = recorder on)."""
    out = []
    for i in range(n_pairs):
        out += [False, True] if i % 2 == 0 else [True, False]
    return out


def _timed(turns, one):
    from repro_torch import spans

    rows = []
    for on in turns:
        if on:
            spans.start()
        try:
            r = one()
        finally:
            spans.stop()
        r["recorder"] = "on" if on else "off"
        print(json.dumps(r), flush=True)
        rows.append(r)
    return rows


def _search_setup(cell, seed, dev):
    from repro_torch.core.compass import search_mapping
    from repro_torch.core.ga import GAConfig
    from repro_torch.core.hardware import make_hardware
    from repro_torch.core.streams import RequestStream, StreamRequest, rollout
    from repro_torch.serving.scheduler import get_scheduler

    from bench import search as drv
    from bench import traffic

    reqs = traffic.stream_requests(cell["traffic_data"], seed)
    stream = RequestStream.from_requests([StreamRequest(**r) for r in reqs],
                                         name=cell["traffic"])
    ro = rollout(stream, get_scheduler(cell["scheduler"]), max_slots=cell["max_slots"],
                 max_iters=cell["max_stream_iters"])
    spec = drv._port_spec(drv._model(cell))
    hwc, ga = cell["hardware"], cell["ga"]
    hw = make_hardware(hwc["target_tops"], hwc["spec"])
    mbs = [hw.micro_batch_decode if any(r.kind == "decode" for r in b)
           else hw.micro_batch_prefill for b in ro.batches]

    def search(gens, ga_seed):
        return search_mapping(spec, ro.batches, hw, mbs,
                              GAConfig(**dict(ga, generations=gens), seed=ga_seed),
                              objective=cell["objective"],
                              timing_backend=cell["timing_backend"], device=dev)

    return search


def _serve_setup(cell, seed, dev, iters):
    import os

    import numpy as np
    from repro_torch.serving.clock import IterationClock
    from repro_torch.serving.scheduler import ServeRequest, get_scheduler
    from repro_torch.serving.service import AsyncLLMService, ServiceConfig

    from bench import serve as drv
    from bench.weights import make_weights, port_model

    cfg_file = cell["config_data"]
    for k, v in cfg_file.get("program_env", {}).items():
        os.environ[k] = v
    m = cfg_file["model"]
    cfg = drv._port_config(m)
    params = port_model(cfg, make_weights(m, seed, dev))
    scfg = ServiceConfig(max_batch=cell["max_batch"], max_len=cell["max_len"],
                         block_len=cell["block_len"], num_blocks=cell.get("num_blocks"),
                         max_iters=iters)
    svc = AsyncLLMService(params, cfg, scfg, impl="kernel", clock=IterationClock(),
                          device=dev)
    rng = np.random.default_rng(seed)
    lanes = cell["max_batch"]
    prompt_len = int(cell["traffic_data"]["prompt"]["mean"])

    def requests():
        # every lane decodes through the whole run: answers longer than it
        return [ServeRequest(i, rng.integers(0, m["vocab"], size=prompt_len).tolist(),
                             iters + 8) for i in range(lanes)]

    return svc, requests, get_scheduler(cell["scheduler"])


def cmd_cost(a) -> int:
    import warnings

    import torch

    common.prepare_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = common.load_cell(a.workload)
    dev = torch.device(a.device)
    if cell["driver"] == "search":
        search = _search_setup(cell, a.first_seed, dev)
        search(1, a.first_seed)                     # graphs, tables, kernels
        gens = cell["ga"]["generations"]
        k = iter(range(10 ** 6))

        def one():
            t = time.perf_counter()
            out = search(gens, a.first_seed + 7_919 * next(k))
            wall = time.perf_counter() - t
            return {"wall_s": wall, "evals_per_s": out.ga_evaluations / wall}

        rows = _timed(_turns(a.pairs), one)
        key = "evals_per_s"
    else:
        svc, requests, sched = _serve_setup(cell, a.first_seed, dev, a.iters)
        warnings.simplefilter("ignore")
        svc.serve_sync(requests(), sched)            # every bucket warmed

        def one():
            t = time.perf_counter()
            res = svc.serve_sync(requests(), sched)
            wall = time.perf_counter() - t
            dec = [s.seconds for s in res.stats if s.n_decode == cell["max_batch"]]
            toks = sum(s.n_decode for s in res.stats) + sum(
                1 for s in res.stats if s.n_prefill_tokens)
            return {"wall_s": wall, "tokens_per_s": toks / wall,
                    "decode_iter_ms_median": 1e3 * statistics.median(dec),
                    "decode_iters": len(dec)}

        rows = _timed(_turns(a.pairs), one)
        key = "tokens_per_s"
    off = [r[key] for r in rows if r["recorder"] == "off"]
    on = [r[key] for r in rows if r["recorder"] == "on"]
    print(json.dumps({"cost": key, "off_median": statistics.median(off),
                      "on_median": statistics.median(on),
                      "on_over_off": statistics.median(on) / statistics.median(off),
                      "card": _card() if dev.type == "cuda" else "cpu"}), flush=True)
    return 0


def cmd_align(a) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans

    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):       # the profiler's slow start
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    with spans.recording():
        for _ in range(a.reps):
            with spans.span("align"):
                torch.cuda._sleep(a.cycles)
                torch.cuda.synchronize()
            time.sleep(0.002)
    prof.stop()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
    ivs = spans.summary()["spans"]["align"]["intervals"]
    if len(kernels) != len(ivs):
        print(f"kernels {len(kernels)} != spans {len(ivs)}", file=sys.stderr)
        return 1
    lead = [(k0 - s0) / 1e3 for (s0, _), (k0, _) in zip(ivs, kernels)]
    lag = [(s1 - k1) / 1e3 for (_, s1), (_, k1) in zip(ivs, kernels)]
    print(json.dumps({"reps": a.reps, "kernel_us": statistics.median(
        (k1 - k0) / 1e3 for k0, k1 in kernels),
        "span_opens_before_kernel_us": [min(lead), statistics.median(lead), max(lead)],
        "span_closes_after_kernel_us": [min(lag), statistics.median(lag), max(lag)],
        "inside": all(x >= 0 for x in lead + lag), "card": _card()}), flush=True)
    return 0


def cmd_micro(a) -> int:
    sys.path.insert(0, str(common.ROOT / "src"))
    from repro_torch import spans

    def per_call(n):
        sp = spans.span
        t = time.perf_counter_ns()
        for _ in range(n):
            with sp("micro"):
                pass
        return (time.perf_counter_ns() - t) / n

    def empty(n):
        t = time.perf_counter_ns()
        for _ in range(n):
            pass
        return (time.perf_counter_ns() - t) / n

    n = a.calls
    off = min(per_call(n) for _ in range(a.reps))
    loop = min(empty(n) for _ in range(a.reps))
    with spans.recording():
        on = min(per_call(n // 10) for _ in range(a.reps))
    print(json.dumps({"span_off_ns": off, "span_on_ns": on, "empty_loop_ns": loop,
                      "calls": n, "reps": a.reps}), flush=True)
    return 0


def _card() -> str:
    import subprocess

    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True)
    return p.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("trace")
    t.add_argument("--workload", required=True)
    t.add_argument("--seeds", type=int, default=3)
    t.add_argument("--first-seed", type=int, default=2_147_483_659)
    t.add_argument("--seconds", type=float, default=50)
    c = sub.add_parser("cost")
    c.add_argument("--workload", required=True)
    c.add_argument("--pairs", type=int, default=3)
    c.add_argument("--first-seed", type=int, default=2_147_483_659)
    c.add_argument("--iters", type=int, default=250)
    c.add_argument("--device", default="cuda", help="cpu: a rehearsal off the card")
    al = sub.add_parser("align")
    al.add_argument("--reps", type=int, default=20)
    al.add_argument("--cycles", type=int, default=2_000_000)
    mi = sub.add_parser("micro")
    mi.add_argument("--calls", type=int, default=1_000_000)
    mi.add_argument("--reps", type=int, default=7)
    a = ap.parse_args()
    if a.cmd != "micro":
        common.prepare_environment()
    return {"trace": cmd_trace, "cost": cmd_cost, "align": cmd_align,
            "micro": cmd_micro}[a.cmd](a)


if __name__ == "__main__":
    sys.exit(main())
