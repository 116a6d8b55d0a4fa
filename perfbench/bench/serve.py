"""The serve driver: the port's paged service (``serving/service.
AsyncLLMService``) over seeded float32 weights on the card, fed by the
cell's traffic on the wall clock.

An open-loop mix sends the requests due in the window at their due
times, and the window opens when the service starts; each request's time
to first token runs from when it was due. A closed-loop mix starts with
every client's request decode-resident and the rest queued behind them;
the window opens at the first decode. Either window closes after the
cell's seconds, at the next call into the model; a request not answered
by then is late, not wrong.

The harness watches the service through a subclass that times the calls
into the model (prefill chunks and decode steps), starts and stops the
device trace and closes the window; the service's own code runs as it
is. The check, after the window and with the service's state and weights
freed: the reference draws the weights again from the seed, and runs a
sample of the answered requests, drawn from the seed with the longest
among them, through the plain float32 reference over the prompt and the
served tokens; each served token's logit is held against the best."""
from __future__ import annotations

import asyncio
import gc
import os
import time

import numpy as np

from .common import Spans, check


class WindowClosed(Exception):
    """Raised at the first call into the model after a closed-loop window."""


class DueClock:
    """The service's clock: the k-th request (``arrived_iter`` k, in due
    order) is released at ``t0 + due_s[k]`` on the host clock."""

    deterministic = False

    def __init__(self, due_s):
        self.due_s = list(due_s)
        self.t0 = time.perf_counter()

    @property
    def now(self) -> float:
        return time.perf_counter() - self.t0

    async def sleep_until(self, k) -> None:
        dt = self.t0 + self.due_s[int(k)] - time.perf_counter()
        if dt > 0:
            await asyncio.sleep(dt)

    def advance(self, t) -> None:
        pass


class Probe:
    """What the harness records of one timed serve."""

    def __init__(self, resident: set, trace, seconds: float, trace_seconds: float,
                 closed_loop: bool, break_tokens=None):
        self.resident, self.tr = resident, trace
        self.seconds, self.trace_seconds = seconds, trace_seconds
        self.closed_loop = closed_loop
        self.processed = 0
        self.break_tokens = break_tokens
        self.w_start = None
        self.first: dict[int, float] = {}
        self.tokens = 0
        self.decode_calls = 0
        self.traced = {"contexts": [], "heads": 0, "decode": [], "iterations": 0,
                       "prefill_tokens": 0}

    def open(self):
        if self.w_start is None:
            self.w_start = time.perf_counter()

    @property
    def deadline(self):
        return None if self.w_start is None else self.w_start + self.seconds

    def entry(self):
        now = time.perf_counter()
        dl = self.deadline
        if self.tr is not None and dl is not None:
            if self.tr.prof is None and now >= dl - self.trace_seconds:
                self.tr.start()
            elif self.tr.running and now >= dl:
                self.tr.stop()
        if dl is not None and now >= dl:
            raise WindowClosed

    def in_window(self) -> bool:
        dl = self.deadline
        return dl is not None and time.perf_counter() <= dl


def _service_class():
    from repro_torch.serving.service import AsyncLLMService

    class Measured(AsyncLLMService):
        probe: Probe = None

        async def serve(self, requests, scheduler, stream_name="requests"):
            if isinstance(self.clock, DueClock):
                self.clock.t0 = time.perf_counter()
                if self.probe is not None and not self.probe.closed_loop:
                    self.probe.w_start = self.clock.t0
            return await super().serve(requests, scheduler, stream_name)

        def _run_prefill_chunk(self, req, chunk_len):
            p = self.probe
            if p is not None:
                p.entry()
            off = int(self.kv.lens_np[req.slot]) if req.slot is not None else 0
            tok = super()._run_prefill_chunk(req, chunk_len)
            if p is None:
                return tok
            if req.rid not in p.resident and p.in_window():
                p.processed += chunk_len
            if p.tr is not None and p.tr.running:
                p.traced["contexts"].extend(range(off + 1, off + chunk_len + 1))
                p.traced["heads"] += 1
                p.traced["prefill_tokens"] += chunk_len
            if req.prefill_done and req.rid not in p.resident:
                if p.break_tokens is not None:
                    tok = p.break_tokens(req.rid, len(req.generated), tok)
                p.first[req.rid] = time.perf_counter()
                if p.in_window():
                    p.tokens += 1
            return tok

        def _run_decode(self, decode):
            p = self.probe
            if p is not None:
                p.open()
                p.entry()
            lens = [int(self.kv.lens_np[r.slot]) for r in decode]
            super()._run_decode(decode)
            if p is None:
                return
            if p.break_tokens is not None:
                for r in decode:
                    r.generated[-1] = p.break_tokens(r.rid, len(r.generated) - 1,
                                                     r.generated[-1])
            p.decode_calls += 1
            if p.tr is not None and p.tr.running:
                p.traced["contexts"].extend(x + 1 for x in lens)
                p.traced["heads"] += len(decode)
                p.traced["iterations"] += 1
                b = 1 << max(0, len(decode) - 1).bit_length()
                p.traced["decode"].append((b, [x + 1 for x in lens]))
            if p.in_window():
                p.tokens += len(decode)
                p.processed += len(decode)

    return Measured


def _port_config(m: dict):
    from repro_torch.models.transformer import ModelConfig, MoECfg

    kw = {k: v for k, v in m.items() if k != "moe"}
    return ModelConfig(moe=MoECfg(**m["moe"]) if m.get("moe") else None, **kw)


def reference_config(cfg_file: dict) -> dict:
    """The configuration's ``model`` group with what the reference reads
    beside it (norm epsilon, gate renormalisation)."""
    m = dict(cfg_file["model"])
    ref = cfg_file.get("reference", {})
    m["rms_norm_eps"] = ref.get("rms_norm_eps", 1e-6)
    if m.get("moe"):
        m["moe"] = dict(m["moe"], norm_topk_prob=ref.get("norm_topk_prob", False))
    return m


def _warm_requests(cell: dict, vocab: int, rng):
    """The shapes the cell's traffic uses, served once in set-up: every
    prefill chunk bucket its prompts (and, in a closed loop, its resident
    contexts) can make, and every decode bucket up to the batch."""
    from repro_torch.serving.scheduler import ServeRequest

    t = cell["traffic_data"]
    lo, hi = t["prompt"]["min"], t["prompt"]["max"]
    chunk = cell.get("prefill_chunk")
    if chunk:
        lens = [min(hi, max(lo, chunk + 2 ** j)) for j in range(chunk.bit_length())]
    else:
        lens = [min(hi, max(lo, 2 ** j)) for j in range(hi.bit_length() + 1)]
    lens = sorted(set(lens))
    out = []
    for i in range(max(cell["max_batch"], len(lens))):
        plen = lens[i] if i < len(lens) else lo
        out.append(ServeRequest(i, rng.integers(0, vocab, size=plen).tolist(),
                                1 + i % 8))
    if t["kind"] == "closed_loop":
        top = t["prompt"]["max"] + t["output"]["max"] - 2
        for ctx_len in (top, (top + 1) // 2):
            ctx = rng.integers(0, vocab, size=ctx_len).tolist()
            out.append(ServeRequest(len(out), ctx, 2, prefilled=len(ctx)))
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str,
        t_process: float, break_tokens=None, control: bool = False) -> dict:
    """One run of a serve cell. ``break_tokens(rid, index, token)``, for
    the harness's own tests, alters tokens where they are produced;
    ``control`` also reads the precision control (the reference in
    bfloat16) at the same positions."""
    cfg_file = cell["config_data"]
    for k, v in cfg_file.get("program_env", {}).items():
        os.environ[k] = v
    import torch

    from repro_torch.serving.clock import IterationClock
    from repro_torch.serving.scheduler import ServeRequest, get_scheduler
    from repro_torch.serving.service import ServiceConfig

    from . import traffic
    from .trace import DeviceTrace
    from .weights import make_weights, port_model

    spans = Spans()
    dev = torch.device(device)
    m = cfg_file["model"]
    t = cell["traffic_data"]
    with spans.span("weights"):
        w = make_weights(m, seed, dev)
        params = port_model(_port_config(m), w)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    closed = t["kind"] == "closed_loop"
    if closed:
        reqs = traffic.closed_loop_requests(t, seed, m["vocab"])
        due = [0.0] * len(reqs)
    else:
        reqs = traffic.open_loop_requests(t, seed, seconds, m["vocab"])
        due = [r["due_s"] for r in reqs]
    sched = cell["scheduler"]
    if sched == "chunked_prefill":
        from repro_torch.serving.scheduler import ChunkedPrefillScheduler
        scheduler = ChunkedPrefillScheduler(cell["prefill_chunk"])
    else:
        scheduler = get_scheduler(sched)
    scfg = ServiceConfig(max_batch=cell["max_batch"], max_len=cell["max_len"],
                         block_len=cell["block_len"], num_blocks=cell.get("num_blocks"),
                         queue_depth=max(32, len(reqs)), max_iters=10 ** 7)
    Measured = _service_class()
    with spans.span("service_and_pools"):
        svc = Measured(params, _port_config(m), scfg, impl="kernel",
                       clock=IterationClock(), device=dev)
    with spans.span("warm_buckets"):
        rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(3)[2])
        svc.serve_sync(_warm_requests(cell, m["vocab"], rng), scheduler)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    serve_reqs = []
    for i, r in enumerate(reqs):
        if r.get("resident"):
            serve_reqs.append(ServeRequest(i, r["prompt"], r["max_new_tokens"],
                                           prefilled=len(r["prompt"]), arrived_iter=0))
        else:
            serve_reqs.append(ServeRequest(i, r["prompt"], r["max_new_tokens"],
                                           arrived_iter=0 if closed else i))
    resident = {i for i, r in enumerate(reqs) if r.get("resident")}
    tr = DeviceTrace() if trace else None
    if tr is not None:
        with spans.span("profiler_warm"):
            tr.warm()
    svc.clock = DueClock(due)
    probe = Probe(resident, tr, seconds, float(cell["trace_seconds"]), closed,
                  break_tokens)
    svc.probe = probe
    t_serve = time.perf_counter()
    result = None
    try:
        result = svc.serve_sync(serve_reqs, scheduler, stream_name=cell["traffic"])
    except WindowClosed:
        pass
    finally:
        if tr is not None and tr.running:
            tr.stop()
    t_end = time.perf_counter()
    if probe.w_start is None:
        raise RuntimeError("the window never opened: no decode step reached the "
                           "harness (AsyncLLMService._run_decode)")
    w_start = probe.w_start
    if dev.type == "cuda":
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    rec = {"kind": "serve", "closed_loop": closed, "window_s": float(seconds),
           "setup_s": w_start - t_process, "setup_split": dict(spans.spans),
           "peak_bytes": peak, "requests": len(reqs), "decode_calls": probe.decode_calls,
           "tokens": probe.tokens, "processed_tokens": probe.processed,
           "window_wall_s": t_end - w_start}
    if not closed:
        t0 = svc.clock.t0
        rec["ttft_ms"] = [1e3 * (probe.first[i] - (t0 + due[i])) if i in probe.first
                          else float("inf") for i in range(len(reqs))]
        events = result.wall_events if result is not None else svc._wall_events
        rec["arrival_lag_ms"] = [1e3 * (events[i]["arrival_s"] - due[i])
                                 if "arrival_s" in events.get(i, {}) else float("inf")
                                 for i in range(len(reqs))]
    # every request sent was attempted; one not answered when the window
    # closed is late, not failed
    rec["attempted"] = len([r for r in serve_reqs if r.rid not in resident]) \
        if not closed else len([r for r in serve_reqs if r.generated or r.slot is not None])
    rec["failed"] = 0
    if tr is not None and tr.prof is not None:
        rec["trace"] = tr.summary()
        rec["traced"] = probe.traced

    # the program's state goes before the reference runs, the weights it
    # served with too: the reference draws its own from the seed
    del result, svc
    params = None
    del w
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        rec["allocated_before_reference"] = torch.cuda.memory_allocated()
    t_w = time.perf_counter()
    w = make_weights(m, seed, dev)
    rec["reference_weights_s"] = time.perf_counter() - t_w
    rec["checks"] = _check(cell, cfg_file, w, reqs, serve_reqs, resident, seed, dev,
                           closed, rec, control)
    rec["check_s"] = time.perf_counter() - t_w
    return rec


def _sample(cell, serve_reqs, resident, seed, closed):
    """The requests to check: answered cold requests, drawn from the seed,
    the one with the most served tokens first, until the cell's count of
    served tokens is reached."""
    cand = [r for r in serve_reqs if r.rid not in resident and r.generated]
    if not cand:
        return []
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(4)[3])
    longest = max(cand, key=lambda r: len(r.generated))
    rest = [r for r in cand if r is not longest]
    order = [longest] + [rest[i] for i in rng.permutation(len(rest))]
    want = int(cell["check"]["served_tokens"])
    out, n = [], 0
    for r in order:
        out.append(r)
        n += len(r.generated)
        if n >= want or len(out) >= int(cell["check"]["max_requests"]):
            break
    return out


def _check(cell, cfg_file, w, reqs, serve_reqs, resident, seed, dev, closed, rec,
           control=False):
    from reference.model import control_gaps, served_gaps

    lim = cell["check"]["limits"]
    out = []
    m = reference_config(cfg_file)
    worst, n_tok, c_worst = 0.0, 0, 0.0
    for r in _sample(cell, serve_reqs, resident, seed, closed):
        g = served_gaps(w, m, reqs[r.rid]["prompt"], list(r.generated), dev)
        worst = max(worst, float(g.max()))
        n_tok += len(g)
        if control:
            c = control_gaps(w, m, reqs[r.rid]["prompt"], list(r.generated), dev)
            c_worst = max(c_worst, float(c.max()))
    if control:
        rec["control"] = {"served_logit_gap": c_worst}
    rec["checked_tokens"] = n_tok
    if n_tok == 0:
        worst = float("inf")
    out.append(check("served_logit_gap", worst, lim["served_logit_gap"]))
    return out
