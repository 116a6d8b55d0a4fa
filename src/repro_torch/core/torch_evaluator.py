"""Torch population-parallel evaluation engine.

The GA's evaluation loop is the DSE hot spot. Here a whole population is
evaluated in one device call per generation, structured as:

* **structural pass** (per individual, shared by every batch of a group):
  Algorithm 2's sequential chip-status scan re-expressed densely — the
  status table "last (row, col) executed on chip c before step t" is a
  prefix-max over the schedule (``torch.cummax``), so weight-residency /
  liveness / write-out flags become gathers with no sequential dependency;
* **cost pass** (per batch x individual): the padded predecessor liveness
  masks contract with the per-batch byte tables into NoP/DRAM traffic,
  per-op ``T_proc`` (in table order) and energy;
* **pass A + pass B** (per batch x individual): the schedule-order gather
  of ``T_proc`` and the sequential makespan recurrence, through a
  :mod:`repro_torch.core.timing` backend: ``fused`` (the default — the
  pass-A + pass-B CUDA kernel, gathering in-kernel via the structural
  pass's ``sched_idx``), ``kernel`` (torch gather, then the pass-B CUDA
  kernel) or ``dense`` (torch gather, then the torch recurrence). On a CPU
  device ``kernel``/``fused`` run their kernels' plain torch versions.

The reference's vmaps are written out as leading population (P) and batch
(B) dimensions. Semantics match ``evaluator.evaluate`` (tested), and the
JAX package's evaluator within float32 reduction order.

``PopulationEvaluator`` (one graph) and ``GroupPopulationEvaluator`` (all
structurally-identical batches of a ``search_mapping`` group on a leading
batch axis — a whole GA generation is ONE call) share this body. Scheduled
orders come from ``encoding.ScheduledOrderCache``; per-batch cost tables are
uploaded once per distinct table content (module-level keyed cache) and the
device buffers persist across GA generations and ``search_mapping`` calls.

``device`` names where the population is evaluated
(:func:`~repro_torch.core.timing.resolve_devices`):
one device runs the whole population in one call; several devices split
it into contiguous chunks, one per device, padded as the JAX package's
``pad_population`` pads its sharded population. Every individual is
evaluated on its own, so the chunked results equal the one-device results
bit for bit. ``device=None`` means one CUDA device.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import mapping_eval as _me
from ..kernels import ops
from .encoding import ScheduledOrderCache, as_stacked
from .evaluator import CostTables
from .hardware import (
    DATAFLOWS,
    E_DRAM_PJ_PER_BYTE,
    E_NOP_PJ_PER_BYTE_HOP,
    HardwareConfig,
)
from .timing import (
    DenseTimingBackend,
    FusedTimingBackend,
    KernelTimingBackend,
    OracleTimingBackend,
    TimingBackend,
    TimingMatrix,
    attribute_group_violations,
    dense_pass_b,
    fold_request_timings,
    get_timing_backend,
    padded_predecessor_columns,
    record_backend_dispatch,
    resolve_devices,
)
from .workload import ExecutionGraph

_WS_IDX = DATAFLOWS.index("WS")


def _wsum(x):  # repro-lint: hot
    """Sum over the last (predecessor-lane) axis as a left-to-right chain
    of adds, the order of a sequential reduction."""
    acc = x[..., 0]
    for w in range(1, x.shape[-1]):
        acc = acc + x[..., w]
    return acc


def _structural_pass(order, lc, n_succ, hops, pred_cols, pred_valid,
                     n_chips: int) -> dict:  # repro-lint: hot
    """Mapping-only quantities for a population: Algorithm-2 flags as dense
    gathers plus the schedule-order index tensors the timing pass needs.
    ``order`` (P, T, 2) and ``lc`` (P, rows, M) int64. Predecessors are
    contiguous column intervals of width <= W, so everything stays on
    narrow (P, rows, M, W) tensors indexed by ``pred_cols``."""
    pop, rows, m_cols = lc.shape
    t_len = order.shape[1]
    dev = lc.device
    b_seq, l_seq = order[:, :, 0], order[:, :, 1]          # (P, T)
    sched = b_seq * m_cols + l_seq                          # flat (P, T)
    chip_seq = lc.reshape(pop, rows * m_cols).gather(1, sched)
    t_ids = torch.arange(t_len, device=dev)
    marked = torch.where(
        chip_seq[:, :, None] == torch.arange(n_chips, device=dev),
        t_ids[None, :, None], -1)                           # (P, T, C)
    last_incl = torch.cummax(marked, dim=1).values
    last_before = torch.cat(                                # strictly < t
        [torch.full((pop, 1, n_chips), -1, dtype=last_incl.dtype,
                    device=dev), last_incl[:, :-1]], dim=1)

    p_ids = torch.arange(pop, device=dev)
    pos = torch.zeros((pop, rows, m_cols), dtype=torch.long, device=dev)
    pos.index_put_((p_ids[:, None].expand(pop, t_len), b_seq, l_seq),
                   t_ids.expand(pop, t_len))                # (P, rows, M)

    # liveness of producer column pc[l, w] for consumer (b, l): the last op
    # on the producer's chip strictly before the consumer is the producer
    cpw = lc[:, :, pred_cols]                               # (P, rows, M, W)
    ppos_mat = pos[:, :, pred_cols]                         # (P, rows, M, W)
    lbp = last_before.reshape(pop, t_len * n_chips).gather(
        1, (pos[..., None] * n_chips + cpw).reshape(pop, -1)
    ).reshape(cpw.shape)
    live = (lbp == ppos_mat) & pred_valid

    # weight residency: previous op on the consumer's chip ran the same
    # column for a different micro-batch
    prev_t = last_before.gather(2, chip_seq[:, :, None]).squeeze(2)  # (P, T)
    safe_prev = prev_t.clamp(min=0)
    elide_t = (prev_t >= 0) & (l_seq.gather(1, safe_prev) == l_seq) \
        & (b_seq.gather(1, safe_prev) != b_seq)
    elide = torch.zeros((pop, rows, m_cols), dtype=torch.bool, device=dev)
    elide.index_put_((p_ids[:, None].expand(pop, t_len), b_seq, l_seq),
                     elide_t)

    # traffic masks: live producers on another chip arrive over the NoP
    # (hop-weighted), dead ones are re-read from DRAM
    diff_chip = cpw != lc[..., None]
    nop_mask = (live & diff_chip).to(torch.float32)
    hop_mask = nop_mask * hops[cpw, lc[..., None]]
    dram_mask = (pred_valid & ~live).to(torch.float32)

    # write-out elision: every successor consumed the output live (integer
    # scatter-add: exact and order-independent)
    consumed = torch.zeros((pop, rows, m_cols), dtype=torch.int32,
                           device=dev)
    r_ids = torch.arange(rows, device=dev)
    consumed.index_put_(
        (p_ids[:, None, None, None].expand(cpw.shape),
         r_ids[None, :, None, None].expand(cpw.shape),
         pred_cols.expand(cpw.shape)),
        live.to(torch.int32), accumulate=True)
    write_out = (n_succ - consumed > 0) | (n_succ == 0)

    # padded predecessor positions per schedule step (sentinel T -> the
    # zero slot of the end vector) — the layout every timing path consumes
    width = pred_cols.shape[-1]
    ppos = torch.where(
        pred_valid[l_seq],
        ppos_mat.reshape(pop, rows * m_cols, width).gather(
            1, sched[:, :, None].expand(pop, t_len, width)),
        t_len)

    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    return dict(chip_seq=i32(chip_seq), elide=elide, write_out=write_out,
                nop_mask=nop_mask, hop_mask=hop_mask, dram_mask=dram_mask,
                ppos=i32(ppos), sched_idx=i32(sched))


def _cost_pass(struct, lc, pred_cols, dram_hops, flow_of_chip, ws_resident,
               out_bytes, comp_s, comp_e, weight_b, psum_b, output_b, rr,
               stream_b, extra_w, dram_bw, nop_bw):  # repro-lint: hot
    """Per-op ``T_proc`` in *table* order (B, P, rows, M) + total energy
    (B, P) for every (batch, individual) pair. Tables carry a leading batch
    axis: (B, rows, M[, D]). The schedule-order gather (pass A) is left to
    the timing stage."""
    n_batch = out_bytes.shape[0]
    pop, rows, m_cols = lc.shape
    n_flows = comp_s.shape[-1]

    ob_w = out_bytes[:, :, pred_cols][:, None]              # (B,1,rows,M,W)
    nop_in = _wsum(struct["nop_mask"][None] * ob_w)         # (B,P,rows,M)
    nop_hops_in = _wsum(struct["hop_mask"][None] * ob_w)
    dram_in = _wsum(struct["dram_mask"][None] * ob_w)

    op_df = flow_of_chip[lc]                                # (P, rows, M)
    cell = torch.arange(rows * m_cols, device=lc.device) * n_flows
    flat_idx = cell + op_df.reshape(pop, rows * m_cols)     # (P, rows*M)

    def g(tab):            # (B, rows, M, D) -> (B, P, rows, M)
        return tab.reshape(n_batch, -1)[:, flat_idx].reshape(
            n_batch, pop, rows, m_cols)

    comp = g(comp_s)
    cene = g(comp_e)
    w_b = g(weight_b)
    ps_b = g(psum_b)
    o_b = g(output_b)
    rr_g = g(rr)

    elide_ok = struct["elide"][None] & (op_df == _WS_IDX)[None] \
        & ws_resident[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=lc.device)
    load_w = torch.where(elide_ok, zero, w_b)
    w_out = torch.where(struct["write_out"][None], o_b, zero)
    dram_bytes = (load_w + dram_in * rr_g + stream_b[:, None]
                  + w_out + ps_b + extra_w[:, None])
    t_dram = dram_bytes / dram_bw
    t_nop = nop_in / nop_bw
    t_proc = torch.maximum(comp, torch.maximum(t_dram, t_nop))

    e_dram = dram_bytes.sum(dim=(2, 3)) * E_DRAM_PJ_PER_BYTE
    e_nop = (nop_hops_in + dram_bytes * dram_hops[lc][None]).sum(dim=(2, 3)) \
        * E_NOP_PJ_PER_BYTE_HOP
    energy_pj = cene.sum(dim=(2, 3)) + e_dram + e_nop
    return t_proc, energy_pj


def _pass_ab(tproc_flat, sched_idx, chip_seq, ppos, n_chips: int,
             backend: str, grid_order: "str | None"):  # repro-lint: hot
    """Backend-dispatched pass A (gather) + pass B (timing recurrence):
    tproc_flat (B, P, L=rows*M), sched_idx (P, T), chip_seq (P, T),
    ppos (P, T, W) -> (end (B, P, T), chip_free (B, P, C)). ``fused``
    hands the un-gathered rows straight to the fused kernel."""
    if backend == "fused":
        return ops.mapping_eval_fused(tproc_flat, sched_idx, chip_seq, ppos,
                                      n_chips, grid_order=grid_order)
    tproc = _me.gather_sched(tproc_flat, sched_idx).contiguous()
    if backend == "kernel":
        return ops.mapping_eval(tproc, chip_seq, ppos, n_chips)
    record_backend_dispatch("dense")
    return dense_pass_b(tproc, chip_seq, ppos, n_chips)


def _front_passes(order_rc, l2c, n_chips: int, st: dict):  # repro-lint: hot
    """Structural pass once per individual, cost pass per (batch,
    individual): -> (struct, tproc_flat (B, P, L), energy_pj (B, P)).
    ``st`` holds the evaluator's device statics and stacked tables."""
    struct = _structural_pass(order_rc, l2c, st["n_succ"], st["hops"],
                              st["pred_cols"], st["pred_valid"], n_chips)
    tproc, energy = _cost_pass(
        struct, l2c, st["pred_cols"], st["dram_hops"], st["flow_of_chip"],
        st["ws_resident"], st["out_bytes"], st["comp_s"], st["comp_e"],
        st["weight_b"], st["psum_b"], st["output_b"], st["rr"],
        st["stream_b"], st["extra_w"], st["dram_bw"], st["nop_bw"])
    return struct, tproc.reshape(tproc.shape[:2] + (-1,)).contiguous(), energy


# repro-lint: hot
def _grouped_population_pass(order_rc, l2c, n_chips: int, st: dict,
                             backend: str = "fused", full: bool = False,
                             grid_order: "str | None" = None):
    """One GA generation against every batch of a group. Returns
    (lat (B, P), energy_pj (B, P)) and, with ``full``, also end (B, P, T),
    free (B, P, C) and tproc_sched (B, P, T)."""
    struct, tproc_flat, energy = _front_passes(order_rc, l2c, n_chips, st)
    end, free = _pass_ab(tproc_flat, struct["sched_idx"], struct["chip_seq"],
                         struct["ppos"], n_chips, backend, grid_order)
    lat = end.amax(dim=-1)
    if full:
        tproc_sched = _me.gather_sched(tproc_flat, struct["sched_idx"])
        return lat, energy, end, free, tproc_sched
    return lat, energy


def _shared_statics(graph: ExecutionGraph, hw: HardwareConfig,
                    device: torch.device) -> dict:
    pred_cols, pred_valid = padded_predecessor_columns(
        [m.pred_lo for m in graph.layers], [m.pred_hi for m in graph.layers])
    m_cols = graph.n_cols
    n_succ = np.zeros(m_cols, dtype=np.int32)
    for l in range(m_cols):
        n_succ[pred_cols[l][pred_valid[l]]] += 1
    n_chips = hw.n_chiplets
    hops = np.zeros((n_chips, n_chips), dtype=np.float32)
    for a in range(n_chips):
        for b in range(n_chips):
            hops[a, b] = hw.hops(a, b)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)  # noqa: E731
    return dict(
        n_succ=t(n_succ, torch.int32),
        pred_cols=t(pred_cols, torch.long),
        pred_valid=t(pred_valid, torch.bool),
        hops=t(hops, torch.float32),
        dram_hops=t(np.array([hw.dram_hops(c) for c in range(n_chips)],
                             np.float32), torch.float32),
        flow_of_chip=t(np.array([DATAFLOWS.index(f) for f in hw.layout]),
                       torch.long),
        dram_bw=t(np.float32(hw.dram_bw), torch.float32),
        nop_bw=t(np.float32(hw.nop_bw), torch.float32),
    )


def _table_arrays(t: CostTables) -> dict:
    return dict(
        ws_resident=t.ws_resident.astype(bool),
        out_bytes=t.out_act_bytes.astype(np.float32),
        comp_s=t.comp_seconds.astype(np.float32),
        comp_e=t.comp_energy_pj.astype(np.float32),
        weight_b=t.weight_bytes.astype(np.float32),
        psum_b=t.psum_bytes.astype(np.float32),
        output_b=t.output_bytes.astype(np.float32),
        rr=t.input_reread.astype(np.float32),
        stream_b=t.stream_bytes.astype(np.float32),
        extra_w=t.extra_write_bytes.astype(np.float32),
    )


# --------------------------------------------------------------------------
# Persistent device-resident table buffers
#
# The stacked (B, rows, M, D) table tensors are the heaviest host->device
# upload of a search. The cache key is the device plus a digest of the
# tables' CONTENT, so equal tables share one upload whatever their Python
# identity, and a recycled object id can never alias another entry.
# Eviction is LRU; lock-guarded for BO worker threads.
# --------------------------------------------------------------------------

_DEVICE_TABLE_CACHE: "OrderedDict" = OrderedDict()
_DEVICE_CACHE_CAPACITY = 64
_DEVICE_CACHE_STATS = {"hits": 0, "misses": 0}
_DEVICE_CACHE_LOCK = threading.Lock()


def _content_digest(per_batch: "list[dict]") -> str:
    h = hashlib.blake2b(digest_size=16)
    for arrs in per_batch:
        for k in sorted(arrs):
            v = np.ascontiguousarray(arrs[k])
            h.update(f"{k}:{v.dtype.str}:{v.shape};".encode())
            h.update(v.tobytes())
    return h.hexdigest()


def _stacked_device_tables(tables: "tuple[CostTables, ...]",
                           device: torch.device) -> dict:
    """(B, ...)-stacked device tensors of the tables' arrays."""
    per_batch = [_table_arrays(t) for t in tables]
    key = (str(device), _content_digest(per_batch))
    with _DEVICE_CACHE_LOCK:
        hit = _DEVICE_TABLE_CACHE.get(key)
        if hit is not None:
            _DEVICE_CACHE_STATS["hits"] += 1
            _DEVICE_TABLE_CACHE.move_to_end(key)
            return hit
        _DEVICE_CACHE_STATS["misses"] += 1
        if len(_DEVICE_TABLE_CACHE) >= _DEVICE_CACHE_CAPACITY:
            _DEVICE_TABLE_CACHE.popitem(last=False)               # LRU
        stacked = {k: torch.as_tensor(np.stack([a[k] for a in per_batch]),
                                      device=device)
                   for k in per_batch[0]}
        _DEVICE_TABLE_CACHE[key] = stacked
        return stacked


def device_table_cache_stats() -> dict:
    with _DEVICE_CACHE_LOCK:
        return dict(_DEVICE_CACHE_STATS, entries=len(_DEVICE_TABLE_CACHE))


def device_table_resident_bytes() -> "dict[str, int]":
    """Per-device resident bytes of the cached stacked table buffers."""
    with _DEVICE_CACHE_LOCK:
        entries = list(_DEVICE_TABLE_CACHE.values())
    out: "dict[str, int]" = {}
    for stacked in entries:
        for arr in stacked.values():
            dev = str(arr.device)
            out[dev] = out.get(dev, 0) + arr.numel() * arr.element_size()
    return out


def clear_device_table_cache() -> None:
    with _DEVICE_CACHE_LOCK:
        _DEVICE_TABLE_CACHE.clear()
        for k in _DEVICE_CACHE_STATS:
            _DEVICE_CACHE_STATS[k] = 0


def _long(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(a, device=device).long()


def _resolve_backend(backend) -> "tuple[str, str | None]":
    """(path name, grid order) for the population passes. The oracle
    backend has no device path — compass routes it to the numpy
    evaluator."""
    be = get_timing_backend(backend)
    if isinstance(be, OracleTimingBackend):
        raise ValueError(
            "the 'oracle' timing backend is the pure-numpy reference path; "
            "use evaluator.evaluate instead of the population evaluators")
    if isinstance(be, FusedTimingBackend):
        return "fused", be.grid_order
    if isinstance(be, KernelTimingBackend):
        return "kernel", None
    if isinstance(be, DenseTimingBackend):
        return "dense", None
    raise ValueError(f"timing backend {be!r} has no population path")


# --------------------------------------------------------------------------
# Population chunks over devices
#
# Every per-individual quantity is computed on its own, so splitting the
# population axis is pure data parallelism: each device runs the SAME
# passes on its contiguous chunk, and the gathered outputs equal the
# one-device outputs bit for bit. This is the JAX package's population
# sharding (``resolve_mesh``, ``pad_population``, ``_sharded_pass``) with a
# list of torch devices (``timing.resolve_devices``) in place of a 1-D
# mesh.
# --------------------------------------------------------------------------


def pad_population(orders: np.ndarray, l2c: np.ndarray,
                   multiple: int) -> "tuple[np.ndarray, np.ndarray, int]":
    """Pad the population axis (axis 0 of both arrays) up to a multiple of
    the device count by repeating the last individual. Individuals are
    evaluated independently, so the padding is removed by slicing every
    output back to the true population size before anything reads it.
    Returns ``(orders, l2c, true_population)``."""
    p = orders.shape[0]
    pad = (-p) % multiple
    if pad:
        orders = np.concatenate(
            [orders, np.repeat(orders[-1:], pad, axis=0)])
        l2c = np.concatenate([l2c, np.repeat(l2c[-1:], pad, axis=0)])
    return orders, l2c, p


@dataclass
class GroupPopulationEvaluator:
    """Evaluates a GA population against ALL structurally-identical batches
    of a ``search_mapping`` group in one device call per generation: the
    per-batch cost tables live on the device in a persistent keyed cache,
    while the mapping-structural pass runs once per individual. Returns
    (B, P) latency/energy; ``timing_matrix`` exposes the full per-op
    (B, P, T) matrix the SLO objectives fold.

    ``device`` (:func:`~.timing.resolve_devices`; ``None`` = one CUDA
    device; an int or a list, several) splits the population axis over several devices: the batch
    axis stays whole on each, with its own copy of the statics and the
    stacked tables (a repeated device shares one copy), and the outputs
    are gathered in population order onto the first device."""

    graphs: "list[ExecutionGraph]"
    tables: "list[CostTables]"
    hw: HardwareConfig
    backend: "TimingBackend | str | None" = None
    device: object = None

    def __post_init__(self):
        g0 = self.graphs[0]
        assert all(g.rows == g0.rows and g.n_cols == g0.n_cols
                   for g in self.graphs), "group batches must share (rows, M)"
        # the structural pass is shared, so the dependency structure must be
        # identical too — equal shape alone does not guarantee it
        preds0 = [(m.pred_lo, m.pred_hi) for m in g0.layers]
        assert all([(m.pred_lo, m.pred_hi) for m in g.layers] == preds0
                   for g in self.graphs), \
            "group batches must share predecessor intervals"
        self._devices = resolve_devices(self.device)
        self._device = self._devices[0]
        self._backend, self._grid_order = _resolve_backend(self.backend)
        self._statics = {}
        for dev in self._devices:
            if dev not in self._statics:
                self._statics[dev] = dict(
                    _shared_statics(g0, self.hw, dev),
                    **_stacked_device_tables(tuple(self.tables), dev))
        self._static = self._statics[self._device]
        self._n_chips = self.hw.n_chiplets
        self._order_cache = ScheduledOrderCache(g0.rows, g0.n_cols)
        self._scales = np.array([g.scale for g in self.graphs])

    @property
    def n_batches(self) -> int:
        return len(self.graphs)

    def _run(self, population, full: bool = False):
        pop = as_stacked(population)
        # function-level import: analysis depends on core submodules
        from ..analysis.mapping import assert_population_legal, \
            verify_env_enabled
        if verify_env_enabled():
            # host-side legality gate (REPRO_VERIFY_MAPPINGS=1): raise on
            # illegal encodings instead of letting the device gathers price
            # them silently wrong — every batch of the group shares one
            # dependency structure, so graphs[0] covers them all
            assert_population_legal(pop, self._n_chips,
                                    graph=self.graphs[0])

        def body(order_rc, l2c, st):
            return _grouped_population_pass(
                order_rc, l2c, self._n_chips, st, backend=self._backend,
                full=full, grid_order=self._grid_order)

        return self._split(pop, body, (1,) * (5 if full else 2))

    def _split(self, pop, body, axes):
        """``body(order_rc, l2c, statics)`` over the population: in one
        call on one device, else once per device on its contiguous chunk
        of the padded population. Every chunk's inputs are uploaded and
        every chunk's pass issued before any output is read, so chunks on
        different cards overlap; output k, whose population axis is
        ``axes[k]``, is gathered onto the first device and sliced back to
        the true population."""
        orders = np.asarray(self._order_cache.orders(pop.segmentation))
        l2c = np.asarray(pop.layer_to_chip)
        if len(self._devices) == 1:
            return body(_long(orders, self._device), _long(l2c, self._device),
                        self._static)
        orders, l2c, p0 = pad_population(orders, l2c, len(self._devices))
        n = orders.shape[0] // len(self._devices)
        ins = [(_long(orders[i * n:(i + 1) * n], dev),
                _long(l2c[i * n:(i + 1) * n], dev))
               for i, dev in enumerate(self._devices)]
        outs = [body(o, lc, self._statics[dev])
                for (o, lc), dev in zip(ins, self._devices)]
        return tuple(
            torch.cat([out[k].to(self._device) for out in outs],
                      dim=ax).narrow(ax, 0, p0)
            for k, ax in enumerate(axes))

    def evaluate_population(self, population
                            ) -> tuple[np.ndarray, np.ndarray]:
        """population (list of encodings or StackedPopulation) ->
        ((B, P) latency_s, (B, P) energy_j)."""
        lat, en_pj = self._run(population)
        scale = self._scales[:, None]
        return (lat.cpu().numpy().astype(np.float64) * scale,
                en_pj.cpu().numpy().astype(np.float64) * 1e-12 * scale)

    def timing_matrix(self, population) -> TimingMatrix:
        """Full (B, P, T) timing matrix, block scale applied."""
        _, _, end, free, tproc = self._run(population, full=True)
        scale = self._scales[:, None, None]
        end = end.cpu().numpy().astype(np.float64) * scale
        return TimingMatrix(
            op_start_s=end - tproc.cpu().numpy().astype(np.float64) * scale,
            op_end_s=end,
            chip_free_s=free.cpu().numpy().astype(np.float64) * scale)

    def pass_ab_inputs(self, population) -> dict:
        """The device tensors pass A/B receives for ``population``:
        ``t_proc`` (B, P, L) un-gathered cost rows, ``sched_idx``,
        ``chip`` (P, T) and ``ppos`` (P, T, W) — the kernels' inputs at
        the search's own shapes."""
        def body(order_rc, l2c, st):
            struct, tproc_flat, _ = _front_passes(order_rc, l2c,
                                                  self._n_chips, st)
            return (tproc_flat, struct["sched_idx"], struct["chip_seq"],
                    struct["ppos"])

        t_proc, sched_idx, chip, ppos = self._split(
            as_stacked(population), body, (1, 0, 0, 0))
        return dict(t_proc=t_proc, sched_idx=sched_idx, chip=chip,
                    ppos=ppos, n_chips=self._n_chips)


@dataclass
class PopulationEvaluator:
    """Evaluates GA populations against one graph; matches the numpy
    oracle. The single-batch case of :class:`GroupPopulationEvaluator`,
    with its ``device`` knob."""

    graph: ExecutionGraph
    tables: CostTables
    hw: HardwareConfig
    backend: "TimingBackend | str | None" = None
    device: object = None

    def __post_init__(self):
        self._group = GroupPopulationEvaluator(
            [self.graph], [self.tables], self.hw, backend=self.backend,
            device=self.device)

    def _run(self, population, full: bool = False):
        """The group pass without its batch axis: (lat, energy_pj) over the
        population and, with ``full``, also end, free and tproc_sched."""
        return tuple(o[0] for o in self._group._run(population, full=full))

    def evaluate_population(self, population
                            ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (latency_s, energy_j) arrays over the population."""
        lat, en = self._group.evaluate_population(population)
        return lat[0], en[0]

    def timing_matrix(self, population) -> TimingMatrix:
        """Full per-op timing matrix (P, T)/(P, C), block scale applied."""
        tm = self._group.timing_matrix(population)
        return TimingMatrix(op_start_s=tm.op_start_s[0],
                            op_end_s=tm.op_end_s[0],
                            chip_free_s=tm.chip_free_s[0])


@dataclass
class JointStreamEvaluator:
    """Whole-scenario SLO fitness for joint-mode cross-group co-search.

    A joint GA individual carries one encoding per structure group; this
    evaluator runs every group's population evaluator (one device call per
    group per generation), assembles the scenario's full (P, n_batches)
    per-iteration latency matrix — every batch's latency comes from the
    same joint candidate — and folds it into per-request timings on the
    device (``timing.fold_request_timings``), scored by the SLO objective.

    Each ``scores`` call also refreshes the per-group *violation
    attribution* of the generation's best candidate
    (``timing.attribute_group_violations`` over the objective's
    ``violations`` mask): :meth:`group_bias` exposes it so
    ``ga.joint_ga_search`` can bias its per-group mutation mask toward
    the group whose latencies dominate the current SLO violations.

    ``group_evals`` maps group key -> ``eval(pop) -> ((B, P) latency_s,
    (B, P) energy_j)``; ``groups`` maps group key -> rollout batch
    indices; ``device`` is where the fold runs."""

    group_evals: "dict[tuple, object]"
    groups: "dict[tuple, list[int]]"
    rollout: object
    objective: object
    # set False when the consumer will never read group_bias (e.g.
    # CoSearchConfig(violation_bias=0)): skips the per-generation
    # violation-mask + attribution work entirely
    track_bias: bool = True
    device: object = None

    def __post_init__(self):
        self._last_bias: "np.ndarray | None" = None

    @property
    def n_batches(self) -> int:
        return sum(len(v) for v in self.groups.values())

    def latency_matrix(self, pops: "dict[tuple, object]") -> np.ndarray:
        """(P, n_batches) per-iteration latencies of the joint population
        (``pops``: group key -> index-aligned ``StackedPopulation``)."""
        full = None
        for key, idxs in self.groups.items():
            lat, _ = self.group_evals[key](pops[key])    # (B, P)
            lat = np.asarray(lat, dtype=float)
            if full is None:
                full = np.empty((lat.shape[1], self.n_batches))
            full[:, idxs] = lat.T
        return full

    def scores(self, pops: "dict[tuple, object]") -> np.ndarray:
        """(P,) minimised SLO scores of the joint population."""
        from .streams import RequestTimings

        full = self.latency_matrix(pops)
        timings = fold_request_timings(self.rollout, full,
                                       device=self.device)
        s = np.asarray(self.objective.score_timings(timings), dtype=float)
        violations = getattr(self.objective, "violations", None)
        if self.track_bias and violations is not None and s.size:
            # attribution only needs the best candidate: slice its row out
            # BEFORE computing the violation mask
            best = int(np.argmin(s))
            bt = RequestTimings(
                ttft_s=timings.ttft_s[best], tpot_s=timings.tpot_s[best],
                finished=timings.finished[best], warm=timings.warm,
                makespan_s=float(np.asarray(timings.makespan_s)[best]),
                synthetic=timings.synthetic)
            viol = np.asarray(violations(bt), dtype=bool)
            self._last_bias = attribute_group_violations(
                self.rollout, full[best], viol,
                list(self.groups.values()))
        return s

    def group_bias(self) -> "np.ndarray | None":
        """Per-group violation weights of the latest generation's best
        candidate ((G,) in ``groups`` order, summing to 1), or ``None``
        before the first ``scores`` call / for non-SLO objectives."""
        return self._last_bias
