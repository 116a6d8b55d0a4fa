"""Async continuous-batching serving service over a paged KV cache.

This is the *served* counterpart of the pure planner (``plan_rollout``):
the same iteration-level :class:`Scheduler` policies, driven by queue
events on an asyncio loop instead of a synchronous while-loop, executing
real model compute through per-batch-size entry points over a paged block
pool on one torch device. Four layers (SHARK ``service_v1`` structurally):

1. **admission/queueing** — a producer coroutine releases requests onto a
   bounded work queue at their stream arrival times (virtual or wall
   clock); the engine coroutine drains arrivals, admits through the shared
   ``admit_arrivals``/``try_admit`` bookkeeping, and additionally gates
   admission on *block* availability: while the head of the queue cannot
   reserve its worst-case KV demand, the scheduler is shown zero
   schedulable slots (OOM-of-blocks queues, never crashes).
2. **paged KV residency** — ``PagedKVCache``: free-list block allocator,
   per-request block tables, no zero-on-admit (stale blocks are masked by
   length; only recurrent state rows are cleared).
3. **bucketed entry points** — one ``prefill_bs1_c{C}`` callable per
   power-of-two chunk bucket and one ``decode_bs{N}`` per power-of-two
   batch bucket (eager calls, cached per bucket as the JAX package caches
   its jitted ones, and counted alike), fed from a
   :class:`TransferBufferPool` so steady-state iterations allocate no host
   staging memory.
4. **sim-to-real contract** — the service records the executed schedule as
   a :class:`StreamRollout` (the planner's own structure) and emits
   :class:`RequestTimings` from it, so under the deterministic
   :class:`IterationClock` the parity suite can require admission order,
   per-iteration membership and timings to be *bit-identical* to
   ``plan_rollout``, and generated tokens to match the dense engine.
"""
from __future__ import annotations

import asyncio
import time
import warnings
from dataclasses import dataclass, field
from functools import partial

import numpy as np

import torch

from ..core.streams import RequestStream, RequestTimings, StreamRollout
from ..core.timing import resolve_device
from ..core.workload import DECODE, PREFILL, Request
from ..models.attention import check_impl, refuse_int8_serving
from .clock import IterationClock, WallClock
from .paged_cache import PagedKVCache, TransferBufferPool
from .. import spans
from .scheduler import (
    IterationPlan,
    ServeRequest,
    admit_arrivals,
    complete_prefill,
    get_scheduler,
    retire_finished,
)
from . import stats

__all__ = ["ServiceConfig", "AsyncLLMService", "ServiceResult",
           "golden_parity_stream", "service_requests",
           "IterationClock", "WallClock"]


def _bucket(n: int) -> int:
    """Smallest power of two >= n (shared with the dense engine)."""
    return 1 << max(0, n - 1).bit_length()


@dataclass(frozen=True)
class ServiceConfig:
    max_batch: int = 8
    max_len: int = 512
    block_len: int = 16
    num_blocks: int | None = None   # default: full residency for every slot
    queue_depth: int = 32           # bounded admission queue (backpressure)
    max_iters: int = 10_000


@dataclass
class ServiceResult:
    """Everything a serve() run produced, measured."""

    requests: list[ServeRequest]        # input order
    finished: list[ServeRequest]
    unfinished: list[ServeRequest]
    stats: list                         # IterationStats per executed iter
    rollout: StreamRollout              # the schedule actually executed
    admissions: list[tuple[int, int, int]]   # (rid, slot, iter), in order
    iteration_seconds: np.ndarray       # measured wall seconds per iter
    wall_events: dict[int, dict[str, float]]
    truncated: bool
    counters: dict = field(default_factory=dict)

    def timings(self, batch_latency_s=None) -> RequestTimings:
        """Measured-schedule timings: the same structure the planner
        predicts. Price with an explicit per-iteration latency vector (the
        parity contract: identical vector + identical schedule =>
        bit-identical timings) or default to the measured wall seconds."""
        lat = self.iteration_seconds if batch_latency_s is None \
            else batch_latency_s
        return self.rollout.timings(lat)

    def wall_timings(self) -> RequestTimings:
        """Event-time timings from the wall stamps (arrival -> first token
        -> completion), independent of the iteration schedule. The warm
        mask is the stream's real one (threaded through the measured
        rollout) — it used to be hardcoded all-cold, which leaked warm
        decode-resident requests (whose TTFT is undefined) into
        ``cold_ttft_s`` and skewed measured SLO percentiles."""
        n = len(self.requests)
        arr = np.full(n, np.inf)
        first = np.full(n, np.inf)
        done = np.full(n, np.inf)
        ntok = np.zeros(n, dtype=int)
        for i, r in enumerate(self.requests):
            ev = self.wall_events.get(r.rid, {})
            arr[i] = ev.get("arrival_s", np.inf)
            first[i] = ev.get("first_s", np.inf)
            done[i] = ev.get("done_s", np.inf)
            ntok[i] = len(r.generated)
        fin = np.isfinite(done)
        ttft = np.where(np.isfinite(first), first - arr, np.inf)
        steps = np.maximum(ntok - 1, 1)
        tpot = np.where(fin, (done - first) / steps, np.inf)
        tpot = np.where(fin & (ntok <= 1), 0.0, tpot)
        makespan = float(np.max(done[fin]) - np.min(arr[np.isfinite(arr)])) \
            if fin.any() else 0.0
        return RequestTimings(ttft_s=ttft, tpot_s=tpot, finished=fin,
                              warm=self.rollout.warm,
                              makespan_s=makespan,
                              truncated=self.truncated)

    def summary(self) -> dict:
        from .engine import summarize
        return summarize(self.finished, self.stats,
                         unfinished=self.unfinished)


class AsyncLLMService:
    """Asyncio continuous-batching service (the served path).

    Use :meth:`serve_sync` from synchronous code, or ``await serve(...)``
    inside an event loop. One instance owns its device pools; each serve()
    call resets the residency bookkeeping. ``params`` (a
    :class:`~repro_torch.models.Transformer`) must lie on ``device``
    (``None`` = CUDA, raising where there is none); ``impl`` is the model
    stack's (``"kernel"``: decode through the decode-attention kernel). An
    int8 cache (``cache_dtype=torch.int8`` or ``REPRO_CACHE_QUANT=1``) is
    refused: prompts go through ``extend``, which does not take one.
    """

    def __init__(self, params, cfg, config: ServiceConfig | None = None,
                 impl: str = "kernel", clock=None, cache_dtype=None,
                 device=None):
        refuse_int8_serving("AsyncLLMService", cache_dtype)
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.config = config or ServiceConfig()
        if self.config.max_len > cfg.max_seq:
            raise ValueError(f"max_len {self.config.max_len} exceeds "
                             f"{cfg.name}'s max_seq {cfg.max_seq} (its RoPE "
                             "tables)")
        self.impl = check_impl(impl)
        self.clock = clock or IterationClock()
        self.kv = PagedKVCache(
            cfg, self.config.max_batch, self.config.max_len,
            block_len=self.config.block_len,
            num_blocks=self.config.num_blocks,
            dtype=torch.float32 if cache_dtype is None else cache_dtype,
            device=self.device)
        self.free: list[int] = list(range(self.config.max_batch))
        self.xfer = TransferBufferPool()
        self._prefill_fns: dict = {}
        self._decode_fns: dict = {}

    # -- entry points (one per power-of-two bucket) -------------------------

    def _prefill_entry(self, chunk_bucket: int):
        if chunk_bucket not in self._prefill_fns:
            from ..models.paged import paged_extend
            fn = partial(paged_extend, cfg=self.cfg,
                         block_len=self.kv.block_len, impl=self.impl,
                         device=self.device)

            def prefill_fn(params, tokens, pools, table, off, slot, length):
                return fn(params, tokens=tokens, pools=pools, table=table,
                          off=off, slot=slot, length=length)

            prefill_fn.__name__ = f"prefill_bs1_c{chunk_bucket}"
            self._prefill_fns[chunk_bucket] = prefill_fn
            stats.bump("prefill_entrypoints")
        return self._prefill_fns[chunk_bucket]

    def _decode_entry(self, batch_bucket: int):
        if batch_bucket not in self._decode_fns:
            from ..models.paged import paged_decode
            fn = partial(paged_decode, cfg=self.cfg,
                         block_len=self.kv.block_len, impl=self.impl,
                         device=self.device)

            def decode_fn(params, tokens, pools, tables, lens, slots):
                return fn(params, tokens=tokens, pools=pools, tables=tables,
                          lens=lens, slots=slots)

            decode_fn.__name__ = f"decode_bs{batch_bucket}"
            self._decode_fns[batch_bucket] = decode_fn
            stats.bump("decode_entrypoints")
        return self._decode_fns[batch_bucket]

    # -- admission ----------------------------------------------------------

    def _demand(self, req: ServeRequest) -> int:
        """Worst-case KV token demand, reserved at admission so an admitted
        request can never OOM mid-flight."""
        return min(len(req.prompt) + req.max_new_tokens,
                   self.config.max_len)

    def _schedulable_slots(self, waiting) -> int:
        """What the scheduler is told about capacity: the free-slot count,
        *zeroed while the head of the queue cannot reserve its blocks* —
        block residency, not slot count, is the admission signal."""
        free = len(self.free)
        if free and waiting:
            head = waiting[0]
            if head.slot is None and \
                    not self.kv.allocator.can_reserve(self._demand(head)):
                self._iter_blocked += 1
                stats.bump("blocked_admissions")
                return 0
        return free

    def _admit(self, req: ServeRequest, it: int,
               prefault: bool = False) -> bool:
        if req.slot is not None:
            return True
        if not self.free:
            return False
        if not self.kv.allocator.reserve(req.rid, self._demand(req)):
            self._iter_blocked += 1
            stats.bump("blocked_admissions")
            return False
        req.slot = self.free.pop()
        self.kv.bind(req.slot, req.rid)
        self._admissions.append((req.rid, req.slot, it))
        if prefault:
            self._prefault(req)
        return True

    def _prefault(self, req: ServeRequest) -> None:
        """Materialise a warm (decode-resident) request's KV residency:
        run its context through the prefill entry points at admission.
        Warm requests model a server that already holds this state, so
        the prefault is a precondition being built, not served work — it
        runs outside the per-iteration walls (measured iteration seconds
        time only the scheduled batches) and emits no first token (the
        warm contract: the first *decode* is the first token). The
        prefill logits' argmax is kept as the seed token for that first
        decode."""
        target = req.prefilled
        req.prefilled = 0
        tok = 0
        while not req.prefill_done:
            tok = self._run_prefill_chunk(
                req, len(req.prompt) - req.prefilled)
        assert req.prefilled == target
        self._warm_seed[req.rid] = tok
        stats.bump("warm_prefaults")

    # -- producer / engine handshake ---------------------------------------

    async def _producer(self, reqs):
        for r in sorted(reqs, key=lambda r: r.arrived_iter):
            self._next_arrival = r.arrived_iter
            await self.clock.sleep_until(r.arrived_iter)
            await self._queue.put(r)
            self._stamp(r.rid, "arrival_s")
            stats.high_water("peak_queue_depth", self._queue.qsize())
        self._next_arrival = None
        self._producer_done = True

    async def _deliver(self, it: int, pending: list) -> None:
        """Move every request whose arrival is due into ``pending``. Under
        the deterministic clock this *waits* until the producer has
        delivered everything with ``arrived_iter <= it`` (the handshake
        that makes admission order reproducible); under a wall clock it
        takes whatever has arrived by now."""
        self.clock.advance(it)
        if not self.clock.deterministic:
            while not self._queue.empty():
                pending.append(self._queue.get_nowait())
            return
        while True:
            while not self._queue.empty():
                pending.append(self._queue.get_nowait())
            done = self._producer_done or self._producer_task.done()
            na = self._next_arrival
            if (done or (na is not None and na > it)) \
                    and self._queue.empty():
                return
            await asyncio.sleep(0)

    def _stamp(self, rid: int, key: str) -> None:
        self._wall_events.setdefault(rid, {})[key] = \
            time.perf_counter() - self._wall_t0

    # -- execution ----------------------------------------------------------

    def _to_device(self, buf: np.ndarray) -> torch.Tensor:
        """A staging buffer's contents as a new tensor on the device. A
        copy, never a view (``torch.tensor``, not ``torch.as_tensor``,
        which shares a CPU tensor's memory with the buffer), made from
        pageable memory, so the buffer may be released and overwritten as
        soon as this returns."""
        return torch.tensor(buf, device=self.device)

    def _run_prefill_chunk(self, req: ServeRequest, chunk_len: int) -> int:
        with spans.span("service.prefill_chunk"):
            slot = req.slot
            chunk = req.prompt[req.prefilled: req.prefilled + chunk_len]
            n = len(chunk)
            c = _bucket(n)
            buf = self.xfer.acquire((c,), np.int32)
            buf[:] = 0
            buf[:n] = chunk
            fn = self._prefill_entry(c)
            tok, self.kv.pools = fn(
                self.params, self._to_device(buf), self.kv.pools,
                self._to_device(self.kv.tables_np[slot]),
                int(self.kv.lens_np[slot]), slot, n)
            self.xfer.release(buf)
            req.prefilled += n
            self.kv.lens_np[slot] += n
            stats.bump("prefill_tokens", n)
            with spans.span("service.readback"):
                return int(tok)

    # repro-lint: hot
    def _run_decode(self, decode: list) -> None:
        with spans.span("service.decode"):
            n = len(decode)
            b = _bucket(n)
            t = self.kv.blocks_per_seq
            tok_buf = self.xfer.acquire((b,), np.int32)
            tbl_buf = self.xfer.acquire((b, t), np.int32)
            len_buf = self.xfer.acquire((b,), np.int32)
            slot_buf = self.xfer.acquire((b,), np.int32)
            tok_buf[:] = 0
            tbl_buf[:] = 0                      # null block: pad-lane sink
            len_buf[:] = 0
            slot_buf[:] = self.kv.scratch_slot  # pad-lane recurrent-state sink
            for j, r in enumerate(decode):
                # warm requests have no generated token yet at their first
                # decode: seed with the prefault's final prefill token
                tok_buf[j] = r.generated[-1] if r.generated \
                    else self._warm_seed[r.rid]
                tbl_buf[j] = self.kv.tables_np[r.slot]
                len_buf[j] = self.kv.lens_np[r.slot]
                slot_buf[j] = r.slot
            fn = self._decode_entry(b)
            toks, self.kv.pools = fn(
                self.params, self._to_device(tok_buf), self.kv.pools,
                self._to_device(tbl_buf), self._to_device(len_buf),
                self._to_device(slot_buf))
            with spans.span("service.readback"):
                # repro-lint: disable=RT002 -- boundary: the scheduler reads the tokens on the host
                toks = toks.cpu().numpy()
            for j, r in enumerate(decode):
                r.generated.append(int(toks[j]))
                self.kv.lens_np[r.slot] += 1
            for buf in (tok_buf, tbl_buf, len_buf, slot_buf):
                self.xfer.release(buf)
            stats.bump("decode_tokens", n)

    # -- the service loop ---------------------------------------------------

    def serve_sync(self, requests, scheduler,
                   stream_name: str = "requests") -> ServiceResult:
        return asyncio.run(self.serve(requests, scheduler, stream_name))

    async def serve(self, requests, scheduler,
                    stream_name: str = "requests") -> ServiceResult:
        from .paged_cache import BlockAllocator
        scheduler = get_scheduler(scheduler)
        reqs = list(requests)
        rids = [r.rid for r in reqs]
        if len(set(rids)) != len(rids):
            raise ValueError("request ids must be unique")
        # warm (decode-resident) requests: already prefilled on arrival.
        # The service materialises their KV state by prefaulting the
        # context through the prefill entry points at admission, so the
        # planner's warm abstraction is servable end to end.
        self._warm_rids = {r.rid for r in reqs
                           if r.prefill_done and r.slot is None}
        self._warm_seed: dict[int, int] = {}
        self._warm_first_b: dict[int, int] = {}
        for r in reqs:
            if r.rid in self._warm_rids and \
                    len(r.prompt) + r.max_new_tokens > self.config.max_len:
                raise ValueError(
                    f"warm request {r.rid}: context {len(r.prompt)} + "
                    f"{r.max_new_tokens} new tokens exceeds max_len="
                    f"{self.config.max_len}")
        # fresh run state (pools persist: stale blocks are masked by length)
        self.kv.allocator = BlockAllocator(self.kv.allocator.num_blocks,
                                           self.kv.block_len)
        self.kv.tables_np[:] = 0
        self.kv.lens_np[:] = 0
        self.free = list(range(self.config.max_batch))
        self._queue: asyncio.Queue = asyncio.Queue(
            maxsize=self.config.queue_depth)
        self._next_arrival: float | None = None
        self._producer_done = False
        self._admissions: list[tuple[int, int, int]] = []
        self._wall_events: dict[int, dict[str, float]] = {}
        self._wall_t0 = time.perf_counter()
        self._iter_blocked = 0
        stats.bump("services_started")
        self._producer_task = asyncio.ensure_future(self._producer(reqs))
        try:
            return await self._engine_loop(reqs, scheduler, stream_name)
        finally:
            if not self._producer_task.done():
                self._producer_task.cancel()
                try:
                    await self._producer_task
                except asyncio.CancelledError:
                    pass

    async def _engine_loop(self, reqs, scheduler,
                           stream_name: str) -> ServiceResult:
        from .engine import IterationStats
        pending: list[ServeRequest] = []
        waiting: list[ServeRequest] = []
        running: list[ServeRequest] = []
        finished: list[ServeRequest] = []
        it_stats: list[IterationStats] = []
        kept_its: list[int] = []
        batches: list[list[Request]] = []
        it = 0
        while it < self.config.max_iters:
            with spans.span("service.iteration"):
                await self._deliver(it, pending)
                if not (pending or waiting or running):
                    if (self._producer_done or self._producer_task.done()) \
                            and self._queue.empty():
                        break
                    if self.clock.deterministic:
                        nxt = self._next_arrival
                        if nxt is not None and nxt > it:
                            it = int(nxt)
                            continue
                        await asyncio.sleep(0)
                        continue
                    pending.append(await self._queue.get())
                    continue
                # warm arrivals admit through the shared loop with the
                # service's richer admission (block reservation + context
                # prefault) substituted for the planner's bare try_admit;
                # the blocked counter resets FIRST so a block-starved warm
                # head shows up in this iteration's stats
                with spans.span("service.schedule"):
                    self._iter_blocked = 0
                    admit_arrivals(pending, waiting, running, self.free, it,
                                   admit=lambda r, _f: self._admit(r, it,
                                                                   prefault=True))
                    free_eff = self._schedulable_slots(waiting)
                    plan = scheduler.plan(waiting, running, free_eff)
                    prefill = [(q, n) for q, n in plan.prefill
                               if self._admit(q, it)]
                    plan = IterationPlan(prefill=prefill,
                                         decode=list(plan.decode))
                if not plan.prefill and not plan.decode:
                    if not waiting and not running and pending:
                        nxt = pending[0].arrived_iter
                        if nxt > it:
                            it = int(nxt)      # fast-forward the idle gap
                            continue
                    it += 1
                    if not self.clock.deterministic:
                        await asyncio.sleep(0)
                    continue

                # record the batch with pre-iteration state (plan_rollout's
                # yield-time convention), then execute it
                queue_depth = len(waiting) + self._queue.qsize()
                batch = [Request(PREFILL, n, q.prefilled + n)
                         for q, n in plan.prefill]
                batch += [Request(DECODE, 1, r.prefilled + len(r.generated))
                          for r in plan.decode]
                # warm first-token convention (the planner's): a warm
                # request's first scheduled decode is its first token
                newly_first_warm = [
                    r.rid for r in plan.decode
                    if r.rid in self._warm_rids
                    and r.rid not in self._warm_first_b]
                for rid in newly_first_warm:
                    self._warm_first_b[rid] = len(batches)
                t0 = time.perf_counter()
                n_prefill_tok = 0
                for req, chunk_len in plan.prefill:
                    tok = self._run_prefill_chunk(req, chunk_len)
                    n_prefill_tok += chunk_len
                    if req.prefill_done:
                        req.generated.append(tok)
                        complete_prefill(req, it, waiting, running)
                        self._stamp(req.rid, "first_s")
                if plan.decode:
                    self._run_decode(plan.decode)
                    for rid in newly_first_warm:
                        self._stamp(rid, "first_s")
                owned = {r.rid: r.slot for r in running}
                n_done = len(finished)
                retire_finished(running, finished, self.free, it)
                for r in finished[n_done:]:
                    self.kv.release(owned[r.rid], r.rid)
                    self._stamp(r.rid, "done_s")
                it_stats.append(IterationStats(
                    it, n_prefill_tok, len(plan.decode),
                    # repro-lint: disable=RT006 -- prefill and decode read tokens back first
                    time.perf_counter() - t0,
                    queue_depth=queue_depth,
                    slots_used=self.config.max_batch - len(self.free),
                    blocks_used=self.kv.allocator.blocks_used,
                    blocked_admissions=self._iter_blocked))
                kept_its.append(it)
                batches.append(batch)
                stats.bump("iterations")
                stats.high_water("peak_slots_used",
                                 self.config.max_batch - len(self.free))
                it += 1

        fin_rids = {r.rid for r in finished}
        unfinished = [r for r in reqs if r.rid not in fin_rids]
        truncated = bool(unfinished)
        if truncated:
            stats.bump("truncated_runs")
            stats.bump("unfinished_requests", len(unfinished))
            warnings.warn(
                f"service run truncated at max_iters={self.config.max_iters}"
                f" with {len(unfinished)} request(s) unfinished — measured "
                "throughput excludes them", stacklevel=2)
        ro = self._measured_rollout(reqs, scheduler, kept_its, batches,
                                    stream_name)
        return ServiceResult(
            requests=reqs, finished=finished, unfinished=unfinished,
            stats=it_stats, rollout=ro, admissions=list(self._admissions),
            iteration_seconds=np.asarray([s.seconds for s in it_stats]),
            wall_events=dict(self._wall_events), truncated=truncated,
            counters=self._counters_snapshot())

    def _measured_rollout(self, reqs, scheduler, kept_its, batches,
                          stream_name: str) -> StreamRollout:
        """The executed schedule in the planner's own structure — built
        exactly like ``repro_torch.core.streams.rollout`` builds the
        planned one, but from measured events."""
        n = len(reqs)
        idx = {r.rid: i for i, r in enumerate(reqs)}
        kept = np.asarray(kept_its, dtype=int)
        it_to_b = {raw: i for i, raw in enumerate(kept_its)}
        arrival_b = np.searchsorted(
            kept, np.asarray([r.arrived_iter for r in reqs]), side="left")
        first_b = np.full(n, -1, dtype=int)
        done_b = np.full(n, -1, dtype=int)
        ntok = np.zeros(n, dtype=int)
        warm = np.asarray([r.rid in self._warm_rids for r in reqs],
                          dtype=bool)
        for r in reqs:
            i = idx[r.rid]
            if r.rid in self._warm_first_b:
                # warm: first scheduled decode (first_token_iter stays
                # None for requests that never prefilled — the planner's
                # convention, mirrored by repro_torch.core.streams.rollout)
                first_b[i] = self._warm_first_b[r.rid]
            elif r.first_token_iter is not None:
                first_b[i] = it_to_b[r.first_token_iter]
            if r.done_iter is not None:
                done_b[i] = it_to_b[r.done_iter]
            ntok[i] = len(r.generated)
        return StreamRollout(
            stream_name=stream_name,
            scheduler_name=getattr(scheduler, "name",
                                   type(scheduler).__name__),
            batches=batches,
            arrival_b=np.asarray(arrival_b, dtype=int),
            first_b=first_b,
            done_b=done_b,
            n_new_tokens=ntok,
            warm=warm,
            truncated=any(r.done_iter is None for r in reqs),
        )

    def _counters_snapshot(self) -> dict:
        return {
            "blocks_capacity": self.kv.allocator.capacity,
            "blocks_peak_used": self.kv.allocator.peak_used,
            "oom_events": self.kv.allocator.oom_events,
            "admissions": len(self._admissions),
            "warm_requests": len(self._warm_rids),
            "transfer_pool_hits": self.xfer.hits,
            "transfer_pool_misses": self.xfer.misses,
            "prefill_entrypoints": sorted(self._prefill_fns),
            "decode_entrypoints": sorted(self._decode_fns),
            "kv_resident_bytes": self.kv.resident_bytes(),
        }


# --------------------------------------------------------------------------
# Golden parity scenario helpers (shared by tests and benchmarks)
# --------------------------------------------------------------------------


def golden_parity_stream() -> RequestStream:
    """The golden mixed stream of the parity contract: staggered cold
    arrivals whose overlapping prefills and decodes exercise queueing, slot
    contention and every scheduler's batch composition. Deterministic by
    construction (explicit request list)."""
    from ..core.streams import StreamRequest
    reqs = [
        StreamRequest(12, 4, 0),
        StreamRequest(7, 3, 0),
        StreamRequest(19, 5, 1),
        StreamRequest(5, 2, 3),
        StreamRequest(9, 4, 6),
        StreamRequest(14, 3, 6),
        StreamRequest(6, 2, 12),
    ]
    return RequestStream.from_requests(reqs, name="golden-mixed")


def service_requests(stream: RequestStream, vocab: int,
                     seed: int = 0) -> list[ServeRequest]:
    """Materialise a stream into servable requests with real token prompts
    (rid = sample index, so planner-side ``rollout`` of the same stream is
    directly comparable). Warm (decode-resident) requests become
    already-prefilled ``ServeRequest``\\ s whose prompt is their context
    snapshot (length ``warm_context``, matching the planner's serve list);
    the service prefaults that context into KV at admission."""
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate(stream.sample()):
        if s.warm:
            out.append(ServeRequest(
                i, rng.integers(0, vocab, size=s.warm_context).tolist(),
                s.max_new_tokens, prefilled=s.warm_context,
                arrived_iter=s.arrival_iter))
        else:
            plen = max(s.prompt_len, 1)
            out.append(ServeRequest(
                i, rng.integers(0, vocab, size=plen).tolist(),
                s.max_new_tokens, arrived_iter=s.arrival_iter))
    return out
