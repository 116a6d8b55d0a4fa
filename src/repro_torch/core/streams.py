"""Request streams — the stream-first scenario input (paper §V, §VI-F).

A :class:`RequestStream` models the *arrival process* of an LLM serving
workload instead of a pre-sampled batch list: request lengths drawn from a
:class:`~repro_torch.core.traces.TraceDistribution` (or given explicitly),
arrivals Poisson or deterministic at ``rate`` requests per scheduler
iteration, and mixed request kinds — cold requests that must be prefilled
plus warm, decode-resident requests that model an already-loaded server.

The stream is rolled out into per-iteration DSE batches by the *same*
iteration-level :class:`~repro_torch.serving.scheduler.Scheduler` policies the
real engine runs (vLLM-separated / Orca-mixed / Chunked-Prefill), via the
schedulers' pure ``plan_rollout`` mode — so a searched design is evaluated
under exactly the batch compositions it will be served with.

The rollout records per-request iteration indices; once the evaluator
prices each iteration's batch, :meth:`StreamRollout.timings` turns the
per-iteration latency vector into per-request TTFT / TPOT / completion
times, from which the SLO-aware objectives in ``repro_torch.core.objectives``
(TTFT/TPOT percentiles, goodput-under-SLO) are computed.

Time is modelled in *scheduler iterations*: an arrival rate of ``r`` means
``r`` requests per engine iteration, and idle iterations (nothing admitted,
nothing running) take zero modelled time.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Sequence

import numpy as np

from ..serving.scheduler import Scheduler, ServeRequest, plan_rollout
from .traces import TraceDistribution
from .workload import DECODE, PREFILL, Request

ARRIVALS = ("poisson", "deterministic")


@dataclass(frozen=True)
class StreamRequest:
    """One request of a stream, in DSE units (token counts, not tokens)."""

    prompt_len: int
    max_new_tokens: int
    arrival_iter: int = 0
    warm_context: int = 0   # > 0: enters decode-resident with this context

    @property
    def warm(self) -> bool:
        return self.warm_context > 0


@dataclass
class RequestStream:
    """An arrival process over requests.

    Three construction modes:

    * distribution mode (default): ``n_requests`` requests with lengths
      drawn from ``trace`` and arrival iterations from ``arrival``/``rate``;
      a ``warm_fraction`` of them enter decode-resident at a random
      progress point (the streaming analogue of ``decode_batch``);
    * explicit mode: ``from_requests`` with a literal request list;
    * fixed mode: ``fixed_batches`` wraps pre-composed per-iteration
      batches (the legacy ``Scenario(phase=..., trace=...)`` /
      ``workload=`` deprecation shims) — no scheduler is involved and
      per-request timing is synthetic.
    """

    name: str
    trace: TraceDistribution | None = None
    arrival: str = "poisson"          # poisson | deterministic
    rate: float = 1.0                 # mean requests per scheduler iteration
    n_requests: int = 8
    warm_fraction: float = 0.0
    max_new_tokens_cap: int | None = 32
    requests: tuple[StreamRequest, ...] | None = None
    batches: tuple[tuple[Request, ...], ...] | None = None   # fixed mode
    seed: int = 0

    @classmethod
    def from_requests(cls, requests: Sequence[StreamRequest],
                      name: str = "explicit") -> "RequestStream":
        # n_requests would otherwise keep its distribution-mode default and
        # misreport the explicit list's length
        return cls(name=name, requests=tuple(requests),
                   n_requests=len(requests))

    @classmethod
    def fixed_batches(cls, batches: Sequence[Sequence[Request]],
                      name: str = "fixed") -> "RequestStream":
        return cls(name=name, batches=tuple(tuple(b) for b in batches))

    @property
    def is_fixed(self) -> bool:
        return self.batches is not None

    def with_rate(self, rate: float) -> "RequestStream":
        """The same stream at a different offered load — the unit step of
        an arrival-rate sweep (multi-rate goodput frontiers). The request
        *population* (lengths, warm mix, decode contexts) is bit-identical
        across rates — only the arrival iterations change — so frontier
        points compare goodput on the same requests (regression-tested in
        tests/test_streams.py). Only distribution-mode streams have an
        arrival process to re-rate."""
        if self.is_fixed or self.requests is not None:
            raise ValueError(
                f"stream {self.name!r} has no arrival process (fixed "
                "batches or an explicit request list); with_rate needs a "
                "distribution-mode stream")
        return replace(self, rate=float(rate))

    def _field_rngs(self, seed: int | None):
        """Independent per-field child generators (lengths / arrival gaps /
        warm mask / decode contexts), spawned from one SeedSequence. A
        single shared generator would let the arrival draws perturb the
        subsequent warm-mask and context draws, so two ``with_rate``
        points (or a poisson-vs-deterministic pair) would sample
        *different request populations* — the frontier confound this
        split removes by construction."""
        ss = np.random.SeedSequence(self.seed if seed is None else seed)
        return tuple(np.random.default_rng(c) for c in ss.spawn(4))

    def sample(self, seed: int | None = None) -> list[StreamRequest]:
        """Materialise the request list (deterministic for a fixed seed)."""
        assert not self.is_fixed, "fixed-batch streams have no request list"
        if self.requests is not None:
            return list(self.requests)
        if self.trace is None:
            raise ValueError(
                f"stream {self.name!r} needs a trace, an explicit request "
                "list, or fixed batches")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival process {self.arrival!r}; "
                             f"choose from {ARRIVALS}")
        len_rng, gap_rng, warm_rng, ctx_rng = self._field_rngs(seed)
        lens = self.trace.sample(len_rng, self.n_requests)
        if self.arrival == "poisson":
            gaps = gap_rng.exponential(1.0 / self.rate,
                                       size=self.n_requests)
            arrivals = np.floor(np.cumsum(gaps) - gaps[0]).astype(int)
        else:
            arrivals = (np.arange(self.n_requests) / self.rate).astype(int)
        warm = warm_rng.random(self.n_requests) < self.warm_fraction
        # contexts are drawn for EVERY request (warm or not) so the decode
        # snapshot of request i is invariant to the warm mask as well
        ctx_u = ctx_rng.random(self.n_requests)
        out = []
        for i, (ilen, olen) in enumerate(lens):
            new = int(olen) if self.max_new_tokens_cap is None \
                else min(int(olen), self.max_new_tokens_cap)
            new = max(new, 1)
            if warm[i]:
                # decode-resident snapshot: context = input + progress*output
                ctx = int(ilen + ctx_u[i] * olen) + 1
                out.append(StreamRequest(ilen, new, int(arrivals[i]),
                                         warm_context=ctx))
            else:
                out.append(StreamRequest(ilen, new, int(arrivals[i])))
        return out


def mixed_serving_stream(prefill_len: int, decode_ctx: int, decode_bs: int,
                         n_decode_batches: int,
                         name: str = "serving_mix") -> RequestStream:
    """The paper's §VI-F serving mix as a stream: one cold prefill request
    arriving into a server already decoding ``decode_bs`` warm requests at
    context ``decode_ctx``. Under each scheduler this reproduces the
    vLLM-separated / Orca-mixed / Chunked-Prefill batch compositions of
    Fig. 9 (golden parity tested)."""
    reqs = [StreamRequest(prefill_len, 1)]
    reqs += [StreamRequest(decode_ctx, n_decode_batches,
                           warm_context=decode_ctx)
             for _ in range(decode_bs)]
    return RequestStream.from_requests(reqs, name=name)


# --------------------------------------------------------------------------
# Rollout
# --------------------------------------------------------------------------


@dataclass
class RequestTimings:
    """Per-request timing of a priced rollout (seconds).

    Arrays may carry leading axes (e.g. (P, R) for a whole GA population
    priced in one fold — see ``timing.fold_request_timings``); the request
    axis is always last, and ``warm`` stays (R,) (the request mix does not
    vary across candidates)."""

    ttft_s: np.ndarray        # (..., R) inf if no first token within horizon
    tpot_s: np.ndarray        # (..., R) inf if unfinished; 0 for 1-token outputs
    finished: np.ndarray      # (..., R) bool
    warm: np.ndarray          # (R,) bool — TTFT undefined for these
    makespan_s: "float | np.ndarray"
    synthetic: bool = False   # fixed-batch shim: no real scheduler timing
    truncated: bool = False   # rollout hit its iteration horizon mid-flight

    @property
    def cold_ttft_s(self) -> np.ndarray:
        return self.ttft_s[..., ~self.warm]


@dataclass
class StreamRollout:
    """A stream rolled out under one scheduler: the evaluated batches plus
    the per-request iteration indices needed to price SLO objectives."""

    stream_name: str
    scheduler_name: str
    batches: list[list[Request]]     # one per executed (non-empty) iteration
    arrival_b: np.ndarray            # (R,) first batch index >= arrival
    first_b: np.ndarray              # (R,) batch index of first token; -1
    done_b: np.ndarray               # (R,) batch index finished; -1
    n_new_tokens: np.ndarray         # (R,) tokens generated within horizon
    warm: np.ndarray                 # (R,) bool
    synthetic: bool = False
    # the iteration budget (max_iters) ran out with requests still in
    # flight: the rollout under-reports their work, so objectives (and the
    # fleet accounting) can refuse or penalise it instead of pricing the
    # shortened schedule as healthy
    truncated: bool = False

    @property
    def n_requests(self) -> int:
        return len(self.arrival_b)

    def timings(self, batch_latency_s) -> RequestTimings:
        """Price the rollout: ``batch_latency_s`` is the evaluator's latency
        per executed iteration, shape (..., B) — leading axes (e.g. a GA
        population) broadcast through. TTFT runs from the start of the
        first executed iteration at/after arrival (queueing included) to
        the end of the first-token iteration; TPOT is the mean inter-token
        time over the remaining output."""
        lat = np.asarray(batch_latency_s, dtype=float)
        nb = len(self.batches)
        assert lat.shape[-1:] == (nb,), \
            f"expected (..., {nb}) latencies, got {lat.shape}"
        cum = np.concatenate(
            [np.zeros(lat.shape[:-1] + (1,)), np.cumsum(lat, axis=-1)],
            axis=-1)
        served = self.first_b >= 0
        fin = self.done_b >= 0
        fb = np.where(served, self.first_b, 0)
        db = np.where(fin, self.done_b, 0)
        # a request can arrive AFTER the last executed iteration (routine
        # once a router splits streams: a replica may drain before a late
        # arrival, or the horizon may cut first) — arrival_b is then
        # len(batches), one past the cum index range. Clamp: such requests
        # are never served, so ttft is inf regardless of the index used.
        arr = np.minimum(self.arrival_b, nb - 1)
        ttft = np.where(served, cum[..., fb + 1] - cum[..., arr], np.inf)
        steps = np.maximum(self.n_new_tokens - 1, 1)
        tpot = np.where(fin, (cum[..., db + 1] - cum[..., fb + 1]) / steps,
                        np.inf)
        tpot = np.where(fin & (self.n_new_tokens <= 1), 0.0, tpot)
        makespan = cum[..., -1]
        return RequestTimings(
            ttft_s=ttft, tpot_s=tpot,
            finished=np.broadcast_to(fin, ttft.shape).copy(),
            warm=self.warm,
            makespan_s=float(makespan) if lat.ndim == 1 else makespan,
            synthetic=self.synthetic,
            truncated=self.truncated)


def _fixed_rollout(stream: RequestStream) -> StreamRollout:
    """Fixed-batch shim: each pre-composed batch is one iteration and every
    request lives exactly in its batch — timing is synthetic (SLO-aware
    objectives refuse it)."""
    batches = [list(b) for b in stream.batches]
    arr, first, done, ntok, warm = [], [], [], [], []
    for i, b in enumerate(batches):
        for r in b:
            arr.append(i)
            first.append(i)
            done.append(i)
            ntok.append(1)
            warm.append(r.kind == DECODE)
    return StreamRollout(
        stream_name=stream.name, scheduler_name="fixed",
        batches=batches,
        arrival_b=np.asarray(arr, dtype=int),
        first_b=np.asarray(first, dtype=int),
        done_b=np.asarray(done, dtype=int),
        n_new_tokens=np.asarray(ntok, dtype=int),
        warm=np.asarray(warm, dtype=bool),
        synthetic=True,
    )


def rollout(stream: RequestStream, scheduler: Scheduler | None = None,
            max_slots: int | None = None, max_iters: int = 256,
            seed: int | None = None) -> StreamRollout:
    """Roll a stream out under a scheduler into per-iteration DSE batches.

    Decode requests attend ``prefilled + generated`` tokens (prompt + all
    tokens produced so far, the engine's cache occupancy); prefill chunks
    attend their own prior context plus the chunk — identical to the
    engine's execution and to the paper's §VI-F batch compositions.
    """
    if stream.is_fixed:
        return _fixed_rollout(stream)
    if scheduler is None:
        raise ValueError("a non-fixed RequestStream needs a Scheduler to "
                         "be rolled out")
    sreqs = stream.sample(seed)
    serve: list[ServeRequest] = []
    for i, s in enumerate(sreqs):
        if s.warm:
            serve.append(ServeRequest(
                i, [0] * s.warm_context, s.max_new_tokens,
                prefilled=s.warm_context, arrived_iter=s.arrival_iter))
        else:
            serve.append(ServeRequest(
                i, [0] * max(s.prompt_len, 1), s.max_new_tokens,
                arrived_iter=s.arrival_iter))
    # max(1, .): an EMPTY sub-stream (a router may assign a replica zero
    # requests) still needs a valid slot count to pass plan_rollout's
    # max_slots >= 1 guard; its loop never runs either way
    n_slots = max_slots if max_slots is not None else max(len(serve), 1)

    n = len(serve)
    is_warm = np.asarray([s.warm for s in sreqs], dtype=bool)
    first_b = np.full(n, -1, dtype=int)
    batches: list[list[Request]] = []
    kept_its: list[int] = []
    for it, plan in plan_rollout(serve, scheduler, n_slots, max_iters):
        bi = len(batches)
        batch: list[Request] = []
        for req, chunk_len in plan.prefill:
            batch.append(Request(PREFILL, chunk_len,
                                 req.prefilled + chunk_len))
        for r in plan.decode:
            batch.append(Request(DECODE, 1, r.prefilled + len(r.generated)))
            if is_warm[r.rid] and first_b[r.rid] < 0:
                first_b[r.rid] = bi      # warm: first decode == first token
        batches.append(batch)
        kept_its.append(it)

    kept = np.asarray(kept_its, dtype=int)
    it_to_b = {raw: i for i, raw in enumerate(kept_its)}
    arrival_b = np.searchsorted(
        kept, np.asarray([s.arrival_iter for s in sreqs]), side="left")
    done_b = np.full(n, -1, dtype=int)
    for r in serve:
        if r.first_token_iter is not None and first_b[r.rid] < 0:
            first_b[r.rid] = it_to_b[r.first_token_iter]
        if r.done_iter is not None:
            done_b[r.rid] = it_to_b[r.done_iter]
    return StreamRollout(
        stream_name=stream.name,
        scheduler_name=getattr(scheduler, "name", type(scheduler).__name__),
        batches=batches,
        arrival_b=np.asarray(arrival_b, dtype=int),
        first_b=first_b,
        done_b=done_b,
        n_new_tokens=np.asarray([len(r.generated) for r in serve], dtype=int),
        warm=is_warm,
        truncated=any(r.done_iter is None for r in serve),
    )


# --------------------------------------------------------------------------
# Stream splitting / timing merging (the fleet layer's primitives)
# --------------------------------------------------------------------------


def split_stream(stream: RequestStream, assignment,
                 n_parts: int, seed: int | None = None,
                 ) -> tuple[tuple[RequestStream, ...], tuple[np.ndarray, ...]]:
    """Split a stream's sampled population into ``n_parts`` explicit
    sub-streams by a per-request ``assignment`` (part index, sample order).

    Arrival iterations pass through unchanged — each sub-stream sees the
    global clock, so a 1-part split is the identity: rolling out the single
    sub-stream is bit-identical to rolling out ``stream`` directly (the
    fleet layer's keystone invariant). Returns ``(substreams, indices)``
    where ``indices[p]`` maps part ``p``'s request order back to the
    original sample order (the input of :func:`merge_timings`).

    The assignment is a fleet router's job; this
    function only owns the mechanics, and requires a stream with a request
    population to split (fixed-batch streams have none).
    """
    if stream.is_fixed:
        raise ValueError(f"stream {stream.name!r} is fixed-batch: it has "
                         "no request population to split")
    reqs = stream.sample(seed)
    a = np.asarray(assignment, dtype=int)
    if a.shape != (len(reqs),):
        raise ValueError(f"assignment shape {a.shape} != ({len(reqs)},) "
                         "requests")
    if len(reqs) and (a.min() < 0 or a.max() >= n_parts):
        raise ValueError(f"assignment values must lie in [0, {n_parts}); "
                         f"got [{a.min()}, {a.max()}]")
    subs, indices = [], []
    for p in range(n_parts):
        ix = np.flatnonzero(a == p)
        subs.append(RequestStream.from_requests(
            [reqs[j] for j in ix], name=f"{stream.name}[{p}/{n_parts}]"))
        indices.append(ix)
    return tuple(subs), tuple(indices)


def merge_timings(parts: Sequence[RequestTimings],
                  indices: Sequence[np.ndarray],
                  n_requests: int) -> RequestTimings:
    """Merge per-sub-stream timings back into one request-indexed view.

    ``indices[p]`` maps part ``p``'s request axis to the original sample
    order (disjoint; from :func:`split_stream`). Replicas run concurrently,
    so the merged makespan is the elementwise max over parts. Requests no
    part served (an index never covered) read as unserved: inf TTFT/TPOT,
    unfinished, cold. A single full-coverage part merges to itself bit for
    bit — scatter copies the float bits unchanged.
    """
    if len(parts) != len(indices):
        raise ValueError(f"{len(parts)} timing parts vs {len(indices)} "
                         "index sets")
    cover = np.zeros(n_requests, dtype=int)
    for p, ix in zip(parts, indices):
        ix = np.asarray(ix, dtype=int)
        if p.ttft_s.shape[-1] != len(ix):
            raise ValueError(
                f"timing part has {p.ttft_s.shape[-1]} requests but its "
                f"index set has {len(ix)}")
        if len(ix) and (ix.min() < 0 or ix.max() >= n_requests):
            raise ValueError(f"indices out of range [0, {n_requests})")
        np.add.at(cover, ix, 1)
    if (cover > 1).any():
        raise ValueError("index sets overlap: request(s) "
                         f"{np.flatnonzero(cover > 1).tolist()} appear in "
                         "more than one part")
    lead = np.broadcast_shapes(*[p.ttft_s.shape[:-1] for p in parts]) \
        if parts else ()
    ttft = np.full(lead + (n_requests,), np.inf)
    tpot = np.full(lead + (n_requests,), np.inf)
    fin = np.zeros(lead + (n_requests,), dtype=bool)
    warm = np.zeros(n_requests, dtype=bool)
    makespans = []
    for p, ix in zip(parts, indices):
        ix = np.asarray(ix, dtype=int)
        ttft[..., ix] = p.ttft_s
        tpot[..., ix] = p.tpot_s
        fin[..., ix] = p.finished
        warm[ix] = p.warm
        makespans.append(np.asarray(p.makespan_s, dtype=float))
    mk = np.maximum.reduce(np.broadcast_arrays(*makespans)) if makespans \
        else np.zeros(lead)
    return RequestTimings(
        ttft_s=ttft, tpot_s=tpot, finished=fin, warm=warm,
        makespan_s=float(mk) if mk.ndim == 0 else mk,
        synthetic=any(p.synthetic for p in parts),
        truncated=any(p.truncated for p in parts))
