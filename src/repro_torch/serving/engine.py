"""Serving engine: slotted KV caches, chunked-prefill + batched decode
steps, iteration-level scheduling (Orca-style continuous batching).

The engine owns a [max_batch, max_len] cache (or a [max_batch] Mamba
state) per layer; requests are admitted into slots, prefilled
(whole-prompt or chunk-at-a-time, per the scheduler, through ``extend``
with the chunk right-padded to a power-of-two bucket; a Mamba layer's
chunk runs the eager chunked SSD, never the ``ssd_scan`` kernel, as in the
JAX package), then decoded together — one ``decode_step`` over all slots
per iteration, with the inactive slots masked. A copy of the JAX package's
engine in which each jitted entry point is an eager call (one per bucket
size; CUDA graphs are later work) and a slot's cache row is a view of the
engine's cache, written in place.

An encoder-decoder model serves against ``enc_out`` [max_batch, Le,
d_model], as the reference does (ROADMAP R5 a): a decode step attends
each slot to its own row, but every prompt chunk attends to row 0,
whatever its slot. A request's prompt and its decode therefore see
different encoder rows unless the rows are equal.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.timing import resolve_device
from ..models.attention import check_impl, refuse_int8_serving
from ..models.transformer import (
    ModelConfig,
    decode_step,
    extend,
    init_cache,
)
from . import stats as serving_stats
from .scheduler import (
    Scheduler,
    ServeRequest,
    admit_arrivals,
    complete_prefill,
    retire_finished,
    try_admit,
)


@dataclass
class IterationStats:
    it: int
    n_prefill_tokens: int
    n_decode: int
    seconds: float
    # occupancy / pressure gauges (0 where a backend has no such notion)
    queue_depth: int = 0        # requests admitted but not yet scheduled
    slots_used: int = 0         # batch slots occupied after the iteration
    blocks_used: int = 0        # KV blocks resident (paged service only)
    blocked_admissions: int = 0  # admissions refused for lack of blocks
    preempts: int = 0
    evictions: int = 0


@dataclass
class RunResult:
    """``ServingEngine.run`` outcome. Unpacks like a ``(finished, stats)``
    tuple; also carries the requests still in flight when the iteration
    budget ran out."""

    finished: list[ServeRequest]
    stats: list[IterationStats]
    unfinished: list[ServeRequest] = field(default_factory=list)
    truncated: bool = False

    def __iter__(self):
        yield self.finished
        yield self.stats


class ServingEngine:
    """``params`` (a :class:`~repro_torch.models.Transformer`) must lie on
    ``device`` (``None`` = CUDA, raising where there is none). An int8
    cache (``cache_dtype=torch.int8`` or ``REPRO_CACHE_QUANT=1``) is
    refused: prompts go through ``extend``, which does not take one.
    ``enc_out`` [max_batch, Le, d_model] (an encoder-decoder model's
    ``encode`` output, on ``device``): decode attends slot i to row i, a
    prompt chunk to row 0 (see the module docstring)."""

    def __init__(self, params, cfg: ModelConfig, max_batch: int = 8,
                 max_len: int = 512, impl: str = "kernel",
                 cache_dtype=torch.float32, device=None, enc_out=None):
        refuse_int8_serving("ServingEngine", cache_dtype)
        self.device = resolve_device(device)
        if max_len > cfg.max_seq:
            raise ValueError(f"max_len {max_len} exceeds {cfg.name}'s "
                             f"max_seq {cfg.max_seq} (its RoPE tables)")
        if enc_out is not None and enc_out.shape[0] != max_batch:
            raise ValueError(f"enc_out has {enc_out.shape[0]} rows for "
                             f"{max_batch} slots")
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.impl = check_impl(impl)
        self.enc_out = enc_out
        self.cache = init_cache(cfg, max_batch, max_len, dtype=cache_dtype,
                                device=self.device)
        self.free = list(range(max_batch))

    def _decode(self, tokens, active):
        logits, self.cache = decode_step(self.params, self.cfg, tokens,
                                         self.cache, impl=self.impl,
                                         active=active, device=self.device,
                                         enc_out=self.enc_out)
        return torch.argmax(logits, -1)

    def _extend(self, tokens, slot: int, length: int):
        """Run a chunk for one slot: the slot's cache row as views ->
        extend (K/V written through the views) -> the new ``len`` and, of a
        Mamba layer, the new state (a new tensor) back into the slot's
        row. ``tokens`` is padded to its bucket. The chunk attends to row 0
        of ``enc_out`` whatever the slot, as the reference's does (ROADMAP
        R5 a)."""
        row = [{k: t[slot:slot + 1] for k, t in layer.items()}
               for layer in self.cache]
        logits, row = extend(self.params, self.cfg, tokens[None, :], row,
                             impl=self.impl, length=length,
                             device=self.device,
                             enc_out=None if self.enc_out is None
                             else self.enc_out[:1])
        for layer, r in zip(self.cache, row):
            for key in ("len", "state"):
                if key in r:
                    layer[key][slot:slot + 1] = r[key]
        return torch.argmax(logits, -1)[0]

    @staticmethod
    def _bucket(n: int) -> int:
        """Smallest power of two >= n."""
        return 1 << max(0, n - 1).bit_length()

    def run(self, requests: list[ServeRequest], scheduler: Scheduler,
            max_iters: int = 10_000):
        for r in requests:
            if r.prefill_done and r.slot is None:
                # warm (decode-resident) requests are a pure-rollout
                # modeling device: the engine has no KV state for a prompt
                # it never ran, so admitting one would decode over a stale
                # or zeroed cache and silently emit garbage
                raise ValueError(
                    f"request {r.rid} is already prefilled but holds no "
                    "cache slot; the dense engine cannot serve warm "
                    "requests — use repro_torch.core.streams.rollout for "
                    "pure simulation")
        pending = sorted(requests, key=lambda r: r.arrived_iter)
        waiting: list[ServeRequest] = []
        running: list[ServeRequest] = []
        finished: list[ServeRequest] = []
        stats: list[IterationStats] = []
        serving_stats.bump("engine_runs")
        it = 0
        while (pending or waiting or running) and it < max_iters:
            admit_arrivals(pending, waiting, running, self.free, it)
            queue_depth = len(waiting)
            plan = scheduler.plan(waiting, running, len(self.free))
            t0 = time.perf_counter()
            n_prefill_tok = 0

            for req, chunk_len in plan.prefill:
                had_slot = req.slot is not None
                if not try_admit(req, self.free):
                    continue
                if not had_slot:
                    self._reset_slot(req.slot)
                chunk = req.prompt[req.prefilled: req.prefilled + chunk_len]
                n = len(chunk)
                padded = np.zeros((self._bucket(n),), np.int64)
                padded[:n] = chunk
                tok = self._extend(torch.as_tensor(padded, device=self.device),
                                   req.slot, n)
                req.prefilled += n
                n_prefill_tok += n
                if req.prefill_done:
                    req.generated.append(int(tok))
                    complete_prefill(req, it, waiting, running)

            if plan.decode:
                toks = np.zeros((self.max_batch,), np.int64)
                active = np.zeros((self.max_batch,), bool)
                for r in plan.decode:
                    toks[r.slot] = r.generated[-1]
                    active[r.slot] = True
                new_toks = self._decode(
                    torch.as_tensor(toks, device=self.device),
                    torch.as_tensor(active, device=self.device)).cpu().numpy()
                for r in plan.decode:
                    r.generated.append(int(new_toks[r.slot]))

            retire_finished(running, finished, self.free, it)

            stats.append(IterationStats(
                it, n_prefill_tok, len(plan.decode),
                time.perf_counter() - t0,
                queue_depth=queue_depth,
                slots_used=self.max_batch - len(self.free)))
            serving_stats.bump("iterations")
            serving_stats.bump("prefill_tokens", n_prefill_tok)
            serving_stats.bump("decode_tokens", len(plan.decode))
            serving_stats.high_water("peak_slots_used",
                                     self.max_batch - len(self.free))
            serving_stats.high_water("peak_queue_depth", queue_depth)
            it += 1

        unfinished = pending + waiting + running
        if unfinished:
            serving_stats.bump("truncated_runs")
            serving_stats.bump("unfinished_requests", len(unfinished))
            warnings.warn(
                f"engine run truncated at max_iters={max_iters} with "
                f"{len(unfinished)} request(s) still in flight — they are "
                "reported in RunResult.unfinished, not silently dropped",
                stacklevel=2)
        return RunResult(finished, stats, unfinished=unfinished,
                         truncated=bool(unfinished))

    def _reset_slot(self, slot: int):
        """Reset a slot for a fresh request: live length to zero plus the
        (small) recurrent state rows. KV contents are deliberately left
        stale — every attention path masks reads by ``len`` — but a Mamba
        state is read whole, so a reused slot must not start from the last
        request's."""
        for layer in self.cache:
            layer["len"][slot] = 0
            if "state" in layer:
                layer["state"][slot] = 0


def summarize(finished: list[ServeRequest], stats: list[IterationStats],
              unfinished: list[ServeRequest] | None = None):
    total_s = sum(s.seconds for s in stats)
    out_toks = sum(len(r.generated) for r in finished)
    ttft = [r.first_token_iter - r.arrived_iter for r in finished
            if r.first_token_iter is not None]
    n_it = len(stats)
    return {
        "requests": len(finished),
        "unfinished": len(unfinished) if unfinished is not None else 0,
        "iterations": n_it,
        "output_tokens": out_toks,
        "total_seconds": total_s,
        "tokens_per_second": out_toks / total_s if total_s else 0.0,
        "mean_ttft_iters": float(np.mean(ttft)) if ttft else 0.0,
        "mean_queue_depth": float(np.mean([s.queue_depth for s in stats]))
        if n_it else 0.0,
        "mean_slots_used": float(np.mean([s.slots_used for s in stats]))
        if n_it else 0.0,
        "peak_blocks_used": max((s.blocks_used for s in stats), default=0),
        "blocked_admissions": sum(s.blocked_admissions for s in stats),
        "preempts": sum(s.preempts for s in stats),
        "evictions": sum(s.evictions for s in stats),
    }
