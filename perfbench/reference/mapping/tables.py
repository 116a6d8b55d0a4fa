"""Frozen copy of the port's cost-table build (``core/evaluator.py``,
``CostTables.build``): per-op, per-dataflow cost components of one
execution graph on one chiplet spec, in float64 numpy."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import dataflow as df
from .hardware import BYTES_PER_ELEM, DATAFLOWS, E_VECTOR_PJ_PER_OP, HardwareConfig
from .workload import ExecutionGraph


@dataclass
class CostTables:
    comp_seconds: np.ndarray      # (rows, M, D)
    comp_energy_pj: np.ndarray    # (rows, M, D) MAC + GLB
    weight_bytes: np.ndarray      # (rows, M, D)
    psum_bytes: np.ndarray        # (rows, M, D)
    output_bytes: np.ndarray      # (rows, M, D)
    input_reread: np.ndarray      # (rows, M, D)
    stream_bytes: np.ndarray      # (rows, M)
    extra_write_bytes: np.ndarray  # (rows, M)
    out_act_bytes: np.ndarray     # (rows, M)
    ws_resident: np.ndarray       # (rows, M) bool
    has_weights: np.ndarray       # (M,) bool
    pred_lo: np.ndarray           # (M,)
    pred_hi: np.ndarray           # (M,)
    flops: np.ndarray             # (rows, M)


def build_tables(graph: ExecutionGraph, hw: HardwareConfig) -> CostTables:
    """Vectorised table build: all GEMMs of the graph are flattened into
    padded descriptor arrays and costed with two ``gemm_cost_batch``
    sweeps (one per dataflow template), then scattered back per
    (row, col, dataflow) with ``bincount``. Semantics match
    ``build_reference`` (the original (rows x M x D) Python loop, kept
    for the equivalence test) to float round-off."""
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
