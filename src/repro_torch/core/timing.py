"""Pluggable timing backends — one evaluation stack from the numpy oracle
to the hand-written CUDA kernels (paper §V-C, pass B).

The evaluation engine runs two passes over a mapping's scheduled op order:
the dense Algorithm-2 flag pass (structural, mapping-only) and the *timing
recurrence* (pass B) — the only truly sequential computation in the GA
inner loop:

    start_t = max(chip_free[chip_t], max_w end[ppos[t, w]])
    end[t] = chip_free[chip_t] = start_t + t_proc[t]

This module defines the :class:`TimingBackend` protocol for pass B with
four implementations sharing one array contract — the *padded
predecessor-position layout*: ``t_proc`` (B, P, T) per-op processing times
in scheduled order, ``chip`` (P, T) chiplet per step, and ``ppos``
(P, T, W) positions of each step's predecessors in the same order, padded
with the sentinel T (which indexes a permanently-zero slot of the end
vector, the oracle's ``max(..., 0)``):

* ``oracle`` — pure-numpy Python loop, the reference semantics;
* ``dense``  — the torch recurrence over T, vectorised over (B, P)
  (:func:`dense_pass_b`), on whatever device it is given;
* ``kernel`` — ``repro_torch.kernels.ops.mapping_eval``: the unfused CUDA
  kernel on a CUDA tensor, its plain torch version on a CPU tensor;
* ``fused``  — ``repro_torch.kernels.ops.mapping_eval_fused``: the pass-A
  + pass-B CUDA kernel (the tproc gather runs in-kernel) on a CUDA tensor,
  its plain version on a CPU tensor. The default.

There is no fallback between them: ``kernel``/``fused`` on a CUDA tensor
launch the hand kernel or raise, and ``dense`` runs only when asked for.
Every dispatch is counted under the path that actually ran in
:func:`timing_backend_stats`, beside the kernels' launch counters.

Every backend returns the full **timing matrix** — per-op end times plus
per-chiplet free times — so :func:`fold_request_timings` can turn
per-iteration latencies into per-request TTFT/TPOT/goodput inside the GA
loop.

The module also owns the persistent cost-table cache: ``CostTables`` (and
the execution graphs they are built from) are keyed on the
(workload, micro-batch, chiplet-spec) identity and reused across GA
generations, ``search_mapping`` calls and BO iterations.

Backend selection: ``Scenario(timing_backend=...)`` > the
``REPRO_TORCH_TIMING_BACKEND`` environment variable > ``"fused"``.
Devices: ``device=None`` means ``torch.device("cuda")`` and raises when
CUDA is missing (:func:`resolve_device`); the CPU is used only when asked.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import mapping_eval as _me
from ..kernels import ops

__all__ = [
    "TimingBackend", "TimingMatrix",
    "OracleTimingBackend", "DenseTimingBackend", "KernelTimingBackend",
    "FusedTimingBackend",
    "TIMING_BACKENDS", "get_timing_backend", "resolve_device",
    "padded_predecessor_columns", "padded_predecessor_positions",
    "dense_pass_b", "fold_request_timings", "splice_latencies",
    "attribute_group_violations",
    "get_execution_graph", "get_cost_tables", "get_graph_and_tables",
    "cost_cache_stats", "clear_cost_caches",
    "record_backend_dispatch", "timing_backend_stats",
    "clear_timing_backend_stats",
]

BACKEND_ENV = "REPRO_TORCH_TIMING_BACKEND"
TIMING_BACKENDS = ("oracle", "dense", "kernel", "fused")
DEFAULT_BACKEND = "fused"

# pass B as a torch recurrence — also the plain version of the unfused kernel
dense_pass_b = _me.mapping_eval_plain


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising when CUDA is missing); anything else
    -> ``torch.device(device)``, checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain torch path explicitly")
    return dev


def _cuda_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _one_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None \
            and dev.index >= _cuda_count():
        raise ValueError(f"device {dev} but {_cuda_count()} CUDA devices "
                         "are available")
    return dev


def resolve_devices(device=None) -> "list[torch.device]":
    """A ``device`` knob that may name several devices, as a list of them
    (the JAX package's ``resolve_mesh``); the population evaluators split
    a population over them:

    * ``None`` or an unpinned ``"cuda"``: one CUDA device, the current
      one. The reference's ``devices=None`` means every local device; the
      split over several cards is opt-in here, since on four H100s it cost
      1.3-4.2x the one-card call and 1.43x the one-card search (chunks are
      dispatched one after another from one thread, and the calls are
      host-bound; PERF.md, PR 28);
    * an int N: the first N CUDA devices;
    * a list or tuple: exactly those devices, in order; a device may
      repeat (chunks evaluated one after another on one device);
    * any other device (``"cuda:1"``, ``"cpu"``): that device alone.

    One device takes the unsplit path. No device, or more than the CUDA
    devices present, raises ``ValueError``; an unpinned CUDA device
    without CUDA raises ``RuntimeError``, as :func:`resolve_device`."""
    if isinstance(device, int) and not isinstance(device, bool):
        if not 1 <= device <= _cuda_count():
            raise ValueError(f"device={device} but {_cuda_count()} CUDA "
                             "devices are available")
        return [torch.device("cuda", i) for i in range(device)]
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("device= must name at least one device")
        return [_one_device(d) for d in device]
    return [_one_device(device)]


# --------------------------------------------------------------------------
# Dispatch observability (one registry, shared with kernels.ops)
# --------------------------------------------------------------------------


def record_backend_dispatch(name: str, n: int = 1) -> None:
    """Count ``n`` pass-B dispatches of a non-kernel path (``dense``,
    ``oracle``); the kernel wrappers count their own paths."""
    ops.record_dispatch(name, n)


def timing_backend_stats() -> dict:
    """``dispatches``: calls per path that ran (``dense``, ``oracle``,
    ``mapping_eval[_fused]:cuda|plain``); ``launches``: CUDA kernel
    launches per kernel."""
    return {"dispatches": ops.dispatch_stats(),
            "launches": _me.launch_counts()}


def clear_timing_backend_stats() -> None:
    ops.clear_dispatch_stats()
    _me.reset_launch_counts()


# --------------------------------------------------------------------------
# Shared array contract
# --------------------------------------------------------------------------


@dataclass
class TimingMatrix:
    """Full pass-B output (seconds, graph units — callers apply the graph's
    block scale). Leading axes are free; the canonical grouped-evaluator
    shape is (batches, population)."""

    op_start_s: np.ndarray   # (..., T) scheduled-order op start times
    op_end_s: np.ndarray     # (..., T) scheduled-order op end times
    chip_free_s: np.ndarray  # (..., C) per-chiplet free (busy-until) times

    @property
    def makespan_s(self) -> np.ndarray:
        return self.op_end_s.max(axis=-1)


def padded_predecessor_columns(pred_lo, pred_hi):
    """Per-layer predecessor column intervals -> padded (M, W) column
    indices + validity mask (predecessors are contiguous intervals of
    width <= W, so narrow padded tensors replace dense (M, M) masks)."""
    pred_lo = np.asarray(pred_lo)
    pred_hi = np.asarray(pred_hi)
    m_cols = pred_lo.shape[0]
    widths = np.where(pred_lo >= 0, pred_hi - pred_lo, 0)
    w = max(int(widths.max(initial=0)), 1)
    pred_cols = np.zeros((m_cols, w), dtype=np.int32)
    pred_valid = np.zeros((m_cols, w), dtype=bool)
    for l in range(m_cols):
        if pred_lo[l] >= 0:
            n = int(pred_hi[l] - pred_lo[l])
            pred_cols[l, :n] = np.arange(pred_lo[l], pred_hi[l])
            pred_valid[l, :n] = True
    return pred_cols, pred_valid


def padded_predecessor_positions(order, pred_cols, pred_valid):
    """Scheduled (row, col) order (T, 2) -> (T, W) predecessor positions in
    the same order, padded with the sentinel T."""
    order = np.asarray(order)
    t_len = order.shape[0]
    b_seq, l_seq = order[:, 0], order[:, 1]
    rows = int(b_seq.max()) + 1
    m_cols = pred_cols.shape[0]
    pos = np.zeros((rows, m_cols), dtype=np.int32)
    pos[b_seq, l_seq] = np.arange(t_len, dtype=np.int32)
    ppos_mat = pos[:, pred_cols]                      # (rows, M, W)
    return np.where(pred_valid[l_seq], ppos_mat[b_seq, l_seq],
                    t_len).astype(np.int32)


def _as_bpt(t_proc, chip, ppos):
    """Normalise to the (B, P, T) / (P, T) / (P, T, W) contract."""
    t_proc = np.asarray(t_proc, dtype=np.float64)
    chip = np.asarray(chip)
    ppos = np.asarray(ppos)
    squeeze = t_proc.ndim == 2
    if squeeze:
        t_proc = t_proc[None]
    if chip.ndim == 1:
        chip = chip[None]
        ppos = ppos[None]
    return t_proc, chip, ppos, squeeze


# --------------------------------------------------------------------------
# Backends
# --------------------------------------------------------------------------


class TimingBackend:
    """Pass-B engine. ``pass_b`` consumes the shared scheduled-order layout
    (numpy) and returns numpy (end (B, P, T), chip_free (B, P, C));
    ``timing_matrix`` wraps the result (starts derived as end - t_proc).
    The torch backends run on ``device`` (``None`` = CUDA)."""

    name = "base"

    def __init__(self, device=None):
        self.device = device

    def pass_b(self, t_proc, chip, ppos, n_chips: int):
        raise NotImplementedError

    def timing_matrix(self, t_proc, chip, ppos, n_chips: int) -> TimingMatrix:
        t_bpt, chip, ppos, squeeze = _as_bpt(t_proc, chip, ppos)
        end, free = self.pass_b(t_bpt, chip, ppos, n_chips)
        end = np.asarray(end, dtype=np.float64)
        free = np.asarray(free, dtype=np.float64)
        if squeeze:
            end, free = end[0], free[0]
        return TimingMatrix(op_start_s=end - np.asarray(t_proc),
                            op_end_s=end, chip_free_s=free)

    def _tensors(self, t_proc, chip, ppos):
        dev = resolve_device(self.device)
        t_proc, chip, ppos, _ = _as_bpt(t_proc, chip, ppos)
        as_i32 = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a, dtype=np.int32), device=dev)
        return (torch.as_tensor(t_proc.astype(np.float32), device=dev),
                as_i32(chip), as_i32(ppos))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r})"


class OracleTimingBackend(TimingBackend):
    """Pure-numpy sequential recurrence — the reference semantics every
    other backend is tested against."""

    name = "oracle"

    def pass_b(self, t_proc, chip, ppos, n_chips: int):
        record_backend_dispatch(self.name)
        t_proc, chip, ppos, _ = _as_bpt(t_proc, chip, ppos)
        n_batch, pop, t_len = t_proc.shape
        end = np.zeros((n_batch, pop, t_len))
        free = np.zeros((n_batch, pop, n_chips))
        for bi in range(n_batch):
            for pi in range(pop):
                endv = np.zeros(t_len + 1)   # slot T: sentinel, stays 0
                chip_free = np.zeros(n_chips)
                for t in range(t_len):
                    c = chip[pi, t]
                    start = max(chip_free[c], endv[ppos[pi, t]].max())
                    fin = start + t_proc[bi, pi, t]
                    endv[t] = fin
                    chip_free[c] = fin
                end[bi, pi] = endv[:t_len]
                free[bi, pi] = chip_free
        return end, free


class DenseTimingBackend(TimingBackend):
    """The torch recurrence (:func:`dense_pass_b`) on ``device``."""

    name = "dense"

    def pass_b(self, t_proc, chip, ppos, n_chips: int):  # repro-lint: hot
        record_backend_dispatch(self.name)
        end, free = dense_pass_b(*self._tensors(t_proc, chip, ppos), n_chips)
        # repro-lint: disable=RT002 -- boundary: the backend protocol returns numpy
        return end.cpu().numpy(), free.cpu().numpy()


class KernelTimingBackend(TimingBackend):
    """The unfused pass-B kernel (``kernels.ops.mapping_eval``)."""

    name = "kernel"

    def pass_b(self, t_proc, chip, ppos, n_chips: int):  # repro-lint: hot
        end, free = ops.mapping_eval(*self._tensors(t_proc, chip, ppos),
                                     n_chips)
        # repro-lint: disable=RT002 -- boundary: the backend protocol returns numpy
        return end.cpu().numpy(), free.cpu().numpy()


class FusedTimingBackend(TimingBackend):
    """The pass-A + pass-B kernel (``kernels.ops.mapping_eval_fused``).
    The protocol-level ``pass_b`` receives already-gathered ``t_proc`` and
    feeds it through an identity ``sched_idx``; the population evaluators
    hand the kernel the un-gathered cost rows instead. ``grid_order=None``
    lets the autotune probe pick on the card."""

    name = "fused"

    def __init__(self, device=None, grid_order: str | None = None):
        super().__init__(device)
        self.grid_order = grid_order

    def pass_b(self, t_proc, chip, ppos, n_chips: int):  # repro-lint: hot
        t_proc, chip, ppos = self._tensors(t_proc, chip, ppos)
        sched = torch.arange(chip.shape[-1], dtype=torch.int32,
                             device=chip.device).expand(chip.shape)
        end, free = ops.mapping_eval_fused(t_proc, sched.contiguous(), chip,
                                           ppos, n_chips,
                                           grid_order=self.grid_order)
        # repro-lint: disable=RT002 -- boundary: the backend protocol returns numpy
        return end.cpu().numpy(), free.cpu().numpy()


_BACKEND_CLASSES = {"oracle": OracleTimingBackend,
                    "dense": DenseTimingBackend,
                    "kernel": KernelTimingBackend,
                    "fused": FusedTimingBackend}


def get_timing_backend(spec: "TimingBackend | str | None" = None,
                       device=None) -> TimingBackend:
    """Resolve a backend name or instance; ``None`` reads
    ``REPRO_TORCH_TIMING_BACKEND`` (default ``fused``). Unknown names
    raise; nothing is rerouted."""
    if isinstance(spec, TimingBackend):
        return spec
    if spec is None:
        spec = os.environ.get(BACKEND_ENV, DEFAULT_BACKEND)
    cls = _BACKEND_CLASSES.get(spec)
    if cls is None:
        raise ValueError(f"unknown timing backend {spec!r}; choose from "
                         f"{TIMING_BACKENDS} or pass a TimingBackend instance")
    return cls(device=device)


# --------------------------------------------------------------------------
# On-device per-request timing fold (rollout pricing inside the GA loop)
# --------------------------------------------------------------------------


def splice_latencies(base_lat, idxs, cand_lat) -> np.ndarray:
    """Splice one structure group's candidate latencies into the rollout's
    best-known per-batch latency vector: ``base_lat`` (N,) best-known
    latencies, ``cand_lat`` (P, k) candidate latencies for the batches at
    positions ``idxs`` -> (P, N) full latency matrices, one per candidate.
    This is the coordinate-descent coupling of the cross-group co-search
    (compass fixed-point loop); joint mode assembles the matrix from every
    group's own candidates instead and never calls this."""
    cand = np.asarray(cand_lat, dtype=float)
    full = np.repeat(np.asarray(base_lat, dtype=float)[None, :],
                     cand.shape[0], axis=0)
    full[:, idxs] = cand
    return full


# repro-lint: hot
def fold_request_timings(rollout, batch_latency_s, device=None):
    """Price a rollout on the device: ``batch_latency_s`` (..., B)
    per-iteration latencies (any leading axes — e.g. a whole GA population;
    numpy or a torch tensor, whose device then wins) ->
    :class:`~repro_torch.core.streams.RequestTimings` with matching leading
    axes. Semantically identical to ``StreamRollout.timings``: a float32
    cumsum over the iterations and gathers at each request's first/last
    iteration."""
    from .streams import RequestTimings

    if isinstance(batch_latency_s, torch.Tensor):
        lat = batch_latency_s.to(torch.float32)
        dev = lat.device
    else:
        dev = resolve_device(device)
        lat = torch.as_tensor(np.asarray(batch_latency_s, dtype=np.float32),
                              device=dev)
    nb = len(rollout.batches)
    assert lat.shape[-1] == nb, \
        f"expected (..., {nb}) latencies, got {tuple(lat.shape)}"
    served_np = rollout.first_b >= 0
    fin_np = rollout.done_b >= 0
    as_t = lambda a, dt=torch.long: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt, device=dev)
    served = as_t(served_np, torch.bool)
    fin = as_t(fin_np, torch.bool)
    fb1 = as_t(np.where(served_np, rollout.first_b, 0) + 1)
    db1 = as_t(np.where(fin_np, rollout.done_b, 0) + 1)
    arr_idx = as_t(np.minimum(rollout.arrival_b, nb - 1))
    steps = as_t(np.maximum(rollout.n_new_tokens - 1, 1), torch.float32)
    one_tok = as_t(fin_np & (rollout.n_new_tokens <= 1), torch.bool)

    zero = torch.zeros(lat.shape[:-1] + (1,), dtype=torch.float32,
                       device=dev)
    cum = torch.cat([zero, torch.cumsum(lat, dim=-1)], dim=-1)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    ttft = torch.where(served, cum[..., fb1] - cum[..., arr_idx], inf)
    tpot = torch.where(fin, (cum[..., db1] - cum[..., fb1]) / steps, inf)
    tpot = torch.where(one_tok, torch.zeros_like(tpot), tpot)
    # repro-lint: disable=RT002 -- boundary: RequestTimings holds numpy
    ttft, tpot = ttft.cpu().numpy(), tpot.cpu().numpy()
    # repro-lint: disable=RT002 -- boundary: RequestTimings holds numpy
    makespan = cum[..., -1].cpu().numpy()
    return RequestTimings(
        ttft_s=ttft, tpot_s=tpot,
        finished=np.broadcast_to(fin_np, np.shape(ttft)).copy(),
        warm=rollout.warm,
        makespan_s=(float(makespan) if np.ndim(makespan) == 0
                    else makespan),
        synthetic=rollout.synthetic)


def attribute_group_violations(rollout, batch_latency_s, violating,
                               group_idxs) -> np.ndarray:
    """Per-group violation attribution from the timing matrix: how much of
    the SLO-violating requests' latency is owed to each structure group.

    For every violating request, its *latency window* runs from the first
    executed iteration at/after arrival to its completion iteration (or
    the end of the horizon when unfinished); each batch inside the window
    contributes its own latency. Summing those contributions per batch and
    then per owning structure group yields the group weights the joint
    co-search uses to bias its per-group mutation mask toward the group
    whose spliced latencies dominate the current violations.

    ``batch_latency_s`` (B,): the reference candidate's per-iteration
    latencies; ``violating`` (R,) bool (an objective's ``violations``
    mask); ``group_idxs``: ordered list of per-group batch-index lists.
    Returns (G,) non-negative weights summing to 1 — uniform when nothing
    violates (no signal: keep exploring every group)."""
    lat = np.asarray(batch_latency_s, dtype=float)
    assert lat.ndim == 1, "attribution needs ONE candidate's latencies"
    nb = lat.shape[0]
    viol = np.asarray(violating, dtype=bool)
    n_groups = len(group_idxs)
    uniform = np.full(n_groups, 1.0 / max(n_groups, 1))
    if n_groups == 0 or not viol.any():
        return uniform
    start = np.minimum(np.asarray(rollout.arrival_b), nb - 1)[viol]
    done = np.asarray(rollout.done_b)[viol]
    end = np.where(done >= 0, done, nb - 1)
    # interval-cover counting: +1 at start, -1 past end, prefix-sum ->
    # how many violating windows cover each batch
    delta = np.zeros(nb + 1, dtype=float)
    np.add.at(delta, start, 1.0)
    np.add.at(delta, end + 1, -1.0)
    cover = np.cumsum(delta[:-1])
    per_batch = cover * lat
    weights = np.array([per_batch[list(idxs)].sum() for idxs in group_idxs])
    total = weights.sum()
    if not np.isfinite(total) or total <= 0.0:
        return uniform
    return weights / total


# --------------------------------------------------------------------------
# Persistent cost-table / execution-graph cache
# --------------------------------------------------------------------------
#
# CostTables depend only on the (execution graph, chiplet spec) pair —
# layout/bandwidth enter at evaluation time — so one table serves every GA
# generation, every search_mapping call on the scenario, and every BO point
# sharing a chiplet spec. The device-resident stacked copies are cached one
# level up, in torch_evaluator, keyed on the tables' content.
#
# Eviction is LRU (hits refresh recency): a hardware sweep over more than
# _CACHE_CAPACITY points must not evict the scenario's own hot entries.
# Lock-guarded get-or-build: BO may price hardware points from worker
# threads, and a concurrent miss must not build the same key twice.


_GRAPH_CACHE: "OrderedDict" = OrderedDict()
_TABLE_CACHE: "OrderedDict" = OrderedDict()
_CACHE_CAPACITY = 256
_CACHE_LOCK = threading.Lock()
_STATS = {"graph_hits": 0, "graph_misses": 0,
          "table_hits": 0, "table_misses": 0}


def _graph_key(spec, batch, micro_batch, tp, n_blocks):
    return (spec, tuple(batch), int(micro_batch), int(tp), n_blocks)


def get_execution_graph(spec, batch, micro_batch, tp, n_blocks=None):
    """Cached ``build_execution_graph`` (the graph is pure data)."""
    from .workload import build_execution_graph

    key = _graph_key(spec, batch, micro_batch, tp, n_blocks)
    with _CACHE_LOCK:
        g = _GRAPH_CACHE.get(key)
        if g is None:
            _STATS["graph_misses"] += 1
            if len(_GRAPH_CACHE) >= _CACHE_CAPACITY:
                _GRAPH_CACHE.popitem(last=False)         # LRU eviction
            g = build_execution_graph(spec, list(batch), micro_batch, tp=tp,
                                      n_blocks=n_blocks)
            _GRAPH_CACHE[key] = g
        else:
            _STATS["graph_hits"] += 1
            _GRAPH_CACHE.move_to_end(key)                # refresh hot entry
    return g


def get_cost_tables(graph, graph_key, hw):
    """Cached ``CostTables.build``; the table key adds only the chiplet
    spec (tables are layout/bandwidth independent)."""
    from .evaluator import CostTables

    key = (graph_key, hw.spec_name)
    with _CACHE_LOCK:
        t = _TABLE_CACHE.get(key)
        if t is None:
            _STATS["table_misses"] += 1
            if len(_TABLE_CACHE) >= _CACHE_CAPACITY:
                _TABLE_CACHE.popitem(last=False)         # LRU eviction
            t = CostTables.build(graph, hw)
            _TABLE_CACHE[key] = t
        else:
            _STATS["table_hits"] += 1
            _TABLE_CACHE.move_to_end(key)                # refresh hot entry
    return t


def get_graph_and_tables(spec, batch, hw, micro_batch, n_blocks=None):
    """The search_mapping entry point: one cached (graph, tables) pair per
    (workload batch, micro-batch, TP, block window, chiplet spec)."""
    key = _graph_key(spec, batch, micro_batch, hw.tensor_parallel, n_blocks)
    g = get_execution_graph(spec, batch, micro_batch, hw.tensor_parallel,
                            n_blocks)
    return g, get_cost_tables(g, key, hw)


def cost_cache_stats() -> dict:
    with _CACHE_LOCK:
        return dict(_STATS, graphs=len(_GRAPH_CACHE),
                    tables=len(_TABLE_CACHE),
                    table_host_bytes=sum(t.nbytes
                                         for t in _TABLE_CACHE.values()))


def clear_cost_caches() -> None:
    with _CACHE_LOCK:
        _GRAPH_CACHE.clear()
        _TABLE_CACHE.clear()
        for k in _STATS:
            _STATS[k] = 0
