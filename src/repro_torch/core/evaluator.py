"""Evaluation engine (paper §V-C): latency, energy, monetary cost of a
(workload, hardware, mapping) triplet.

Two passes over the scheduled order:

1. Algorithm 2 flag scan (``access.data_access_flags``).
2. Timing/energy simulation under the double-buffering bound
   ``T_proc = max(T_comp, T_DRAM, T_NoP)`` with
   ``T_start = max(chip-available, predecessors-done)`` (paper's equations).

This module is the *numpy oracle*; ``torch_evaluator`` reproduces it
(tested) and evaluates whole GA populations in one device call. The
timing recurrence (pass B) is delegated to a pluggable
``repro_torch.core.timing`` backend — ``oracle`` (numpy, the default here),
``dense`` (torch recurrence), ``kernel`` or ``fused`` (hand-written CUDA
kernels) — all consuming the same padded predecessor-position layout and
returning the full timing matrix.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import dataflow as df
from .access import data_access_flags
from .encoding import MappingEncoding
from .hardware import (
    BYTES_PER_ELEM,
    DATAFLOWS,
    E_DRAM_PJ_PER_BYTE,
    E_NOP_PJ_PER_BYTE_HOP,
    E_VECTOR_PJ_PER_OP,
    HardwareConfig,
    monetary_cost,
)
from .timing import (
    OracleTimingBackend,
    padded_predecessor_columns,
    padded_predecessor_positions,
)
from .workload import ExecutionGraph

_BUILD_COUNT = 0


def cost_tables_build_count() -> int:
    """Process-lifetime count of ``CostTables.build`` calls — used to
    assert the persistent cost-table cache actually skips rebuilds."""
    return _BUILD_COUNT


@dataclass
class CostTables:
    """Per-op, per-dataflow cost components, precomputed once per
    (workload, chiplet-spec) pair — the GA inner loop only gathers."""

    comp_seconds: np.ndarray      # (rows, M, D)
    comp_energy_pj: np.ndarray    # (rows, M, D) MAC + GLB
    weight_bytes: np.ndarray      # (rows, M, D) DRAM weight traffic if loading
    psum_bytes: np.ndarray        # (rows, M, D) mandatory psum spill
    output_bytes: np.ndarray      # (rows, M, D) output write-back if flagged
    input_reread: np.ndarray      # (rows, M, D) DRAM input re-read factor
    stream_bytes: np.ndarray      # (rows, M) mandatory DRAM reads (KV/state)
    extra_write_bytes: np.ndarray  # (rows, M) mandatory DRAM writes
    out_act_bytes: np.ndarray     # (rows, M) activation output size
    ws_resident: np.ndarray       # (rows, M) weights fit WS resident budget
    has_weights: np.ndarray       # (M,) bool
    pred_lo: np.ndarray           # (M,)
    pred_hi: np.ndarray           # (M,)
    flops: np.ndarray             # (rows, M)

    @property
    def nbytes(self) -> int:
        """Host-resident bytes across every table array — feeds the
        unified ``repro_torch.core.cache_stats()`` memory accounting."""
        return sum(int(v.nbytes) for v in vars(self).values()
                   if isinstance(v, np.ndarray))

    @staticmethod
    def build(graph: ExecutionGraph, hw: HardwareConfig) -> "CostTables":
        """Vectorised table build: all GEMMs of the graph are flattened into
        padded descriptor arrays and costed with two ``gemm_cost_batch``
        sweeps (one per dataflow template), then scattered back per
        (row, col, dataflow) with ``bincount``. Semantics match
        ``build_reference`` (the original (rows x M x D) Python loop, kept
        for the equivalence test) to float round-off."""
        global _BUILD_COUNT
        _BUILD_COUNT += 1
        rows, m_cols, d = graph.rows, graph.n_cols, len(DATAFLOWS)
        n_ops = rows * m_cols
        spec = hw.spec

        stream = np.zeros((rows, m_cols))
        extraw = np.zeros((rows, m_cols))
        outb = np.zeros((rows, m_cols))
        flops = np.zeros((rows, m_cols))
        post = np.zeros(n_ops)
        post_count = np.zeros(n_ops)        # count of the op's first GEMM
        is_gemm = np.zeros(n_ops, dtype=bool)
        neutral = np.zeros(n_ops, dtype=bool)
        w_elems = np.zeros(n_ops, dtype=np.int64)
        gm, gk, gn, gcnt, gop = [], [], [], [], []
        for b in range(rows):
            for l in range(m_cols):
                op = graph.ops[b][l]
                i = b * m_cols + l
                stream[b, l] = op.stream_elems * BYTES_PER_ELEM
                extraw[b, l] = op.extra_write_elems * BYTES_PER_ELEM
                outb[b, l] = op.out_elems * BYTES_PER_ELEM
                flops[b, l] = op.flops
                post[i] = op.post_flops
                neutral[i] = op.dataflow_neutral
                w_elems[i] = op.weight_elems
                if op.gemms:
                    is_gemm[i] = True
                    post_count[i] = op.gemms[0].count
                    for g in op.gemms:
                        gm.append(g.m)
                        gk.append(g.k)
                        gn.append(g.n)
                        gcnt.append(g.count)
                        gop.append(i)

        gop = np.asarray(gop, dtype=np.int64)
        gcnt = np.asarray(gcnt, dtype=np.float64)
        batch = {flow: df.gemm_cost_batch(gm, gk, gn, spec, flow)
                 for flow in DATAFLOWS}

        shape = (rows, m_cols, d)
        comp_s = np.zeros(shape)
        comp_e = np.zeros(shape)
        w_b = np.zeros(shape)
        p_b = np.zeros(shape)
        o_b = np.zeros(shape)
        rr = np.ones(shape)
        outb_f = outb.reshape(n_ops)
        # scalar path folds post_flops into the FIRST GEMM's cost, which is
        # then multiplied by that GEMM's count
        post_eff = post * np.where(is_gemm, post_count, 0.0)

        # ws-residency is dataflow-independent (kn <= resident budget)
        res_ok = np.ones(n_ops, dtype=bool)
        if len(gop):
            np.logical_and.at(res_ok, gop, batch["WS"].ws_resident_ok)
        ws_res = (res_ok & (w_elems > 0) & is_gemm).reshape(rows, m_cols)

        for di, flow in enumerate(DATAFLOWS):
            if len(gop):
                # dataflow-neutral ops fall back to OS when scheduled on WS
                use_os = neutral[gop] & (flow == "WS")

                def sel(attr, use_os=use_os, flow=flow):
                    return np.where(use_os, getattr(batch["OS"], attr),
                                    getattr(batch[flow], attr))

                def acc(vals):
                    return np.bincount(gop, weights=vals, minlength=n_ops)

                cs = acc(sel("compute_cycles") * gcnt) \
                    + post_eff / df.VECTOR_LANES
                ce = acc((sel("mac_energy_pj") + sel("glb_energy_pj")) * gcnt) \
                    + post_eff * E_VECTOR_PJ_PER_OP
                wb = acc(sel("weight_bytes") * gcnt)
                pb = acc(sel("psum_spill_bytes") * gcnt)
                ob = acc(sel("output_bytes") * gcnt)
                rr_op = np.ones(n_ops)
                np.maximum.at(rr_op, gop, sel("input_reread_factor"))
            else:
                cs = ce = wb = pb = ob = np.zeros(n_ops)
                rr_op = np.ones(n_ops)

            # activation-activation GEMMs: weight traffic is the explicit
            # stream term instead
            wb = np.where(w_elems == 0, 0.0, wb)
            ob_eff = np.where(ob > 0, np.minimum(ob, outb_f), outb_f)

            # non-GEMM ops: post-processing vector unit only
            vec_cycles = post / df.VECTOR_LANES
            cs = np.where(is_gemm, cs, vec_cycles)
            ce = np.where(is_gemm, ce, post * E_VECTOR_PJ_PER_OP)
            wb = np.where(is_gemm, wb, 0.0)
            pb = np.where(is_gemm, pb, 0.0)
            rr_op = np.where(is_gemm, rr_op, 1.0)

            comp_s[:, :, di] = (cs / df.FREQ_HZ).reshape(rows, m_cols)
            comp_e[:, :, di] = ce.reshape(rows, m_cols)
            w_b[:, :, di] = wb.reshape(rows, m_cols)
            p_b[:, :, di] = pb.reshape(rows, m_cols)
            o_b[:, :, di] = ob_eff.reshape(rows, m_cols)
            rr[:, :, di] = rr_op.reshape(rows, m_cols)

        has_w = np.array([graph.ops[0][l].weight_elems > 0
                          for l in range(m_cols)])
        plo = np.array([m.pred_lo for m in graph.layers])
        phi = np.array([m.pred_hi for m in graph.layers])
        return CostTables(comp_s, comp_e, w_b, p_b, o_b, rr, stream, extraw,
                          outb, ws_res, has_w, plo, phi, flops)

    @staticmethod
    def build_reference(graph: ExecutionGraph, hw: HardwareConfig) -> "CostTables":
        rows, m_cols, d = graph.rows, graph.n_cols, len(DATAFLOWS)
        shape = (rows, m_cols, d)
        comp_s = np.zeros(shape)
        comp_e = np.zeros(shape)
        w_b = np.zeros(shape)
        p_b = np.zeros(shape)
        o_b = np.zeros(shape)
        rr = np.ones(shape)
        stream = np.zeros((rows, m_cols))
        extraw = np.zeros((rows, m_cols))
        outb = np.zeros((rows, m_cols))
        flops = np.zeros((rows, m_cols))
        ws_res = np.zeros((rows, m_cols), dtype=bool)
        spec = hw.spec
        for b in range(rows):
            for l in range(m_cols):
                op = graph.ops[b][l]
                stream[b, l] = op.stream_elems * BYTES_PER_ELEM
                extraw[b, l] = op.extra_write_elems * BYTES_PER_ELEM
                outb[b, l] = op.out_elems * BYTES_PER_ELEM
                flops[b, l] = op.flops
                for di, flow in enumerate(DATAFLOWS):
                    if not op.gemms:
                        c = df.vector_cost(op.post_flops, spec)
                    else:
                        flow_eff = "OS" if (op.dataflow_neutral and flow == "WS") else flow
                        cs = ce = wb = pb = ob = 0.0
                        rrs = 1.0
                        res_ok = True
                        post = op.post_flops
                        for g in op.gemms:
                            gc = df.gemm_cost(g.m, g.k, g.n, spec, flow_eff,
                                              post_flops=post)
                            post = 0.0
                            cs += gc.compute_cycles * g.count
                            ce += (gc.mac_energy_pj + gc.glb_energy_pj) * g.count
                            wb += gc.weight_bytes * g.count
                            pb += gc.psum_spill_bytes * g.count
                            ob += gc.output_bytes * g.count
                            rrs = max(rrs, gc.input_reread_factor)
                            res_ok = res_ok and gc.ws_resident_ok
                        if op.weight_elems == 0:
                            wb = 0.0  # activation-activation GEMM: KV/state
                            # traffic is the explicit stream term instead
                        comp_s[b, l, di] = cs / df.FREQ_HZ
                        comp_e[b, l, di] = ce
                        w_b[b, l, di] = wb
                        p_b[b, l, di] = pb
                        o_b[b, l, di] = min(ob, outb[b, l]) if ob else outb[b, l]
                        rr[b, l, di] = rrs
                        if flow == "WS":
                            ws_res[b, l] = res_ok and op.weight_elems > 0
                        continue
                    comp_s[b, l, di] = c.compute_cycles / df.FREQ_HZ
                    comp_e[b, l, di] = c.mac_energy_pj
                    o_b[b, l, di] = outb[b, l]
        has_w = np.array([graph.ops[0][l].weight_elems > 0 for l in range(m_cols)])
        plo = np.array([m.pred_lo for m in graph.layers])
        phi = np.array([m.pred_hi for m in graph.layers])
        return CostTables(comp_s, comp_e, w_b, p_b, o_b, rr, stream, extraw,
                          outb, ws_res, has_w, plo, phi, flops)


@dataclass
class EvalResult:
    latency_s: float
    energy_j: float
    mc_total: float
    t_comp_s: float      # sum of per-op compute times (bound components)
    t_dram_s: float
    t_nop_s: float
    e_comp_j: float
    e_dram_j: float
    e_nop_j: float
    chip_busy_s: np.ndarray  # per-chiplet busy time
    op_end_s: np.ndarray     # (rows, M)

    @property
    def edp(self) -> float:
        return self.latency_s * self.energy_j

    @property
    def edp_mc(self) -> float:
        return self.latency_s * self.energy_j * self.mc_total

    def utilization(self) -> float:
        if self.latency_s <= 0:
            return 0.0
        return float(np.mean(self.chip_busy_s) / self.latency_s)


def evaluate(
    graph: ExecutionGraph,
    enc: MappingEncoding,
    hw: HardwareConfig,
    tables: CostTables | None = None,
    backend=None,
    verify: bool | None = None,
) -> EvalResult:
    """Reference single-mapping evaluation. ``backend`` routes the timing
    recurrence (pass B) through any ``repro_torch.core.timing.TimingBackend``
    (default: the numpy oracle) — the shared parity suite runs this very
    function under all three backends.

    ``verify=True`` runs the static legality analyzer on ``enc`` first and
    raises ``repro_torch.analysis.MappingLegalityError`` on any violation —
    without it, an illegal encoding prices silently wrong (numpy fancy
    indexing wraps negative chiplet ids instead of failing). The default
    ``None`` follows the ``REPRO_VERIFY_MAPPINGS`` debug gate."""
    # function-level import: repro_torch.analysis depends on core submodules, so
    # a module-level import here would cycle through repro_torch.core.__init__
    from ..analysis.mapping import assert_legal, verify_env_enabled
    if verify is None:
        verify = verify_env_enabled()
    if verify:
        assert_legal(enc, hw.n_chiplets, graph=graph)
    if tables is None:
        tables = CostTables.build(graph, hw)
    flags = data_access_flags(graph, enc, hw)
    rows, m_cols = enc.rows, enc.n_cols

    flow_idx = np.array([DATAFLOWS.index(f) for f in hw.layout])
    l2c = enc.layer_to_chip
    op_df = flow_idx[l2c]                       # (rows, M)
    bi, li = np.meshgrid(np.arange(rows), np.arange(m_cols), indexing="ij")

    comp_s = tables.comp_seconds[bi, li, op_df]
    comp_e = tables.comp_energy_pj[bi, li, op_df]
    w_b = tables.weight_bytes[bi, li, op_df]
    psum_b = tables.psum_bytes[bi, li, op_df]
    out_b = tables.output_bytes[bi, li, op_df]
    rr = tables.input_reread[bi, li, op_df]

    # Algorithm-2 modulation: weight elision only on WS chiplets whose
    # resident GLB budget actually holds the layer's weight slice
    ws_idx = DATAFLOWS.index("WS")
    elide = ~flags.is_load_wei & (op_df == ws_idx) & tables.ws_resident
    load_w = np.where(elide, 0.0, w_b)
    write_out = np.where(flags.is_write_out, out_b, 0.0)

    dram_read = load_w + flags.dram_in_bytes * rr + tables.stream_bytes
    dram_write = write_out + psum_b + tables.extra_write_bytes
    dram_bytes = dram_read + dram_write
    t_dram = dram_bytes / hw.dram_bw
    t_nop = flags.nop_in_bytes / hw.nop_bw

    dram_hops = np.array([hw.dram_hops(c) for c in range(hw.n_chiplets)])[l2c]
    e_dram = dram_bytes * E_DRAM_PJ_PER_BYTE
    e_nop = (flags.nop_in_byte_hops + dram_bytes * dram_hops) * E_NOP_PJ_PER_BYTE_HOP

    t_proc = np.maximum(comp_s, np.maximum(t_dram, t_nop))

    # schedule simulation (pass B): padded predecessor-position layout
    # through a pluggable timing backend — numpy oracle by default
    order = enc.scheduled_order()
    b_seq, l_seq = order[:, 0], order[:, 1]
    pred_cols, pred_valid = padded_predecessor_columns(tables.pred_lo,
                                                       tables.pred_hi)
    ppos = padded_predecessor_positions(order, pred_cols, pred_valid)
    be = OracleTimingBackend() if backend is None else backend
    tm = be.timing_matrix(t_proc[b_seq, l_seq][None], l2c[b_seq, l_seq][None],
                          ppos[None], hw.n_chiplets)
    end = np.zeros((rows, m_cols))
    end[b_seq, l_seq] = tm.op_end_s[0]

    scale = graph.scale
    latency = float(end.max()) * scale
    e_comp_j = float(comp_e.sum()) * 1e-12 * scale
    e_dram_j = float(e_dram.sum()) * 1e-12 * scale
    e_nop_j = float(e_nop.sum()) * 1e-12 * scale

    busy = np.zeros(hw.n_chiplets)
    np.add.at(busy, l2c.ravel(), t_proc.ravel())

    return EvalResult(
        latency_s=latency,
        energy_j=e_comp_j + e_dram_j + e_nop_j,
        mc_total=monetary_cost(hw)["mc_total"],
        t_comp_s=float(comp_s.sum()) * scale,
        t_dram_s=float(t_dram.sum()) * scale,
        t_nop_s=float(t_nop.sum()) * scale,
        e_comp_j=e_comp_j,
        e_dram_j=e_dram_j,
        e_nop_j=e_nop_j,
        chip_busy_s=busy * scale,
        op_end_s=end * scale,
    )
