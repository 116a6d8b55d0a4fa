"""Plain numpy evaluation of a whole GA population over a group of
execution graphs: Algorithm 2's data-access flags (pass A) and the
double-buffered schedule recurrence (pass B), as the paper states them and
as the port's per-mapping numpy oracle (``core/evaluator.evaluate``)
computes them, vectorised over individuals and batches in float64.

``rounding`` rounds every intermediate the evaluation produces (gathered
costs, per-op times, bytes and energies, every step of the recurrence and
the sums) to a lower precision: ``"bfloat16"`` is the precision control of
the benchmark's check.
"""
from __future__ import annotations

import numpy as np

from .hardware import DATAFLOWS, E_DRAM_PJ_PER_BYTE, E_NOP_PJ_PER_BYTE_HOP, HardwareConfig
from .tables import CostTables
from .workload import ExecutionGraph


def round_bfloat16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to the nearest bfloat16 (ties to even), as float64."""
    f = np.asarray(x, dtype=np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _rounder(rounding: str | None):
    if rounding is None or rounding == "float64":
        return lambda a: a
    if rounding == "bfloat16":
        return round_bfloat16
    raise ValueError(f"unknown rounding {rounding!r}")


def scheduled_orders(seg: np.ndarray, rows: int, m_cols: int) -> np.ndarray:
    """(P, M-1) segmentation bits -> (P, rows*M, 2) scheduled (row, col)
    order: by segment, then micro-batch row, then column."""
    seg = np.asarray(seg)
    p = seg.shape[0]
    seg_id = np.zeros((p, m_cols), dtype=np.int64)
    if m_cols > 1:
        seg_id[:, 1:] = np.cumsum(seg[:, : m_cols - 1].astype(np.int64), axis=1)
    key = (seg_id[:, None, :] * rows + np.arange(rows)[None, :, None]) * m_cols \
        + np.arange(m_cols)[None, None, :]
    idx = np.argsort(key.reshape(p, rows * m_cols), axis=1, kind="stable")
    b, l = np.divmod(idx, m_cols)
    return np.stack([b, l], axis=-1)


def _pred_columns(pred_lo: np.ndarray, pred_hi: np.ndarray):
    m_cols = len(pred_lo)
    widths = np.where(pred_lo >= 0, pred_hi - pred_lo, 0)
    w = max(int(widths.max(initial=0)), 1)
    cols = np.zeros((m_cols, w), dtype=np.int64)
    valid = np.zeros((m_cols, w), dtype=bool)
    for l in range(m_cols):
        if pred_lo[l] >= 0:
            n = int(pred_hi[l] - pred_lo[l])
            cols[l, :n] = np.arange(pred_lo[l], pred_hi[l])
            valid[l, :n] = True
    return cols, valid


def _structure(graph: ExecutionGraph):
    rows, m_cols = graph.rows, graph.n_cols
    lo = np.array([m.pred_lo for m in graph.layers])
    hi = np.array([m.pred_hi for m in graph.layers])
    has_w = np.array([[graph.ops[b][l].weight_elems > 0 for l in range(m_cols)]
                      for b in range(rows)])
    return lo, hi, has_w


def access_flags(graph: ExecutionGraph, orders: np.ndarray, l2c: np.ndarray,
                 hw: HardwareConfig) -> dict:
    """Algorithm 2 for every individual at once. ``orders`` (P, T, 2),
    ``l2c`` (P, rows, M). Returns per-individual booleans and per-pred
    sourcing: ``load_wei``, ``write_out`` (P, rows, M); ``live``,
    ``valid``, ``hops`` (P, rows, M, W) and ``cols`` (M, W)."""
    rows, m_cols = graph.rows, graph.n_cols
    lo, hi, has_w = _structure(graph)
    cols, valid = _pred_columns(lo, hi)
    w = cols.shape[1]
    p = l2c.shape[0]
    ar = np.arange(p)
    n_succ = np.zeros(m_cols, dtype=np.int64)
    for l in range(m_cols):
        if lo[l] >= 0:
            n_succ[lo[l]:hi[l]] += 1
    remaining = np.tile(n_succ, (p, rows, 1))
    load_wei = np.ones((p, rows, m_cols), dtype=bool)
    write_out = np.ones((p, rows, m_cols), dtype=bool)
    live = np.zeros((p, rows, m_cols, w), dtype=bool)
    hops = np.zeros((p, rows, m_cols, w))
    state_row = np.full((p, hw.n_chiplets), -1, dtype=np.int64)
    state_col = np.full((p, hw.n_chiplets), -1, dtype=np.int64)
    coords = np.array([hw.coords(c) for c in range(hw.n_chiplets)])
    hop_mat = (np.abs(coords[:, None, 0] - coords[None, :, 0])
               + np.abs(coords[:, None, 1] - coords[None, :, 1])).astype(np.float64)
    for t in range(rows * m_cols):
        b, l = orders[:, t, 0], orders[:, t, 1]
        chip = l2c[ar, b, l]
        keep = (state_col[ar, chip] == l) & (state_row[ar, chip] != b) & has_w[b, l]
        load_wei[ar[keep], b[keep], l[keep]] = False
        for j in range(w):
            ok = valid[l, j]
            pc = cols[l, j]
            cp = l2c[ar, b, pc]
            lv = ok & (state_row[ar, cp] == b) & (state_col[ar, cp] == pc)
            remaining[ar, b, pc] -= lv
            gone = lv & (remaining[ar, b, pc] == 0)
            write_out[ar[gone], b[gone], pc[gone]] = False
            live[ar, b, l, j] = lv
            hops[ar, b, l, j] = hop_mat[cp, chip]
        state_row[ar, chip] = b
        state_col[ar, chip] = l
    return dict(load_wei=load_wei, write_out=write_out, live=live,
                hops=hops, cols=cols, pred_valid=valid)


def evaluate_population(graphs: "list[ExecutionGraph]", tables: "list[CostTables]",
                        hw: HardwareConfig, segmentation: np.ndarray,
                        layer_to_chip: np.ndarray, rounding: str | None = None,
                        chunk: int = 32
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Latency (s) and energy (J) of every individual on every graph: two
    (B, P) arrays. The graphs must share one structure (rows, columns and
    predecessor intervals), as a structure group of the search does."""
    r = _rounder(rounding)
    g0 = graphs[0]
    rows, m_cols = g0.rows, g0.n_cols
    l2c = np.asarray(layer_to_chip, dtype=np.int64)
    p = l2c.shape[0]
    ar = np.arange(p)
    orders = scheduled_orders(segmentation, rows, m_cols)
    fl = access_flags(g0, orders, l2c, hw)
    lo0, hi0, hw0 = _structure(g0)
    for g in graphs[1:]:
        lo, hi, hwg = _structure(g)
        if not (np.array_equal(lo, lo0) and np.array_equal(hi, hi0)
                and np.array_equal(hwg, hw0)):
            raise ValueError("graphs of one group differ in structure")
    cols, pvalid = fl["cols"], fl["pred_valid"]
    live, hops = fl["live"], fl["hops"]
    valid = pvalid[None, None]                                # (1, 1, M, W)
    differs = live & (hops > 0)           # fetched over the NoP from another chip
    from_dram = valid & ~live
    flow_idx = np.array([DATAFLOWS.index(f) for f in hw.layout])
    op_df = flow_idx[l2c]                                     # (P, rows, M)
    ws = DATAFLOWS.index("WS")
    dram_hops = np.array([hw.dram_hops(c) for c in range(hw.n_chiplets)],
                         dtype=np.float64)[l2c]
    bi = np.arange(rows)[None, :, None]
    li = np.arange(m_cols)[None, None, :]
    t_len = rows * m_cols
    b_seq, l_seq = orders[:, :, 0], orders[:, :, 1]
    chip_seq = l2c[ar[:, None], b_seq, l_seq]                 # (P, T)
    pos = np.zeros((p, rows, m_cols), dtype=np.int64)
    pos[ar[:, None], b_seq, l_seq] = np.arange(t_len)[None, :]
    ppos = np.where(pvalid[None, None], pos[:, :, cols], t_len)
    ppos_seq = ppos[ar[:, None], b_seq, l_seq]                # (P, T, W)

    lat = np.zeros((len(graphs), p))
    en = np.zeros((len(graphs), p))
    for c0 in range(0, len(graphs), chunk):
        gs, ts = graphs[c0:c0 + chunk], tables[c0:c0 + chunk]
        nb = len(gs)
        stack = {k: np.stack([getattr(t, k) for t in ts]) for k in (
            "comp_seconds", "comp_energy_pj", "weight_bytes", "psum_bytes",
            "output_bytes", "input_reread", "stream_bytes",
            "extra_write_bytes", "ws_resident")}
        out_b = np.stack([[[g.ops[b][l].out_elems * 2 for l in range(m_cols)]
                           for b in range(rows)] for g in gs]).astype(np.float64)
        pred_b = (out_b[:, :, cols] * pvalid[None, None])[:, None]  # (nb,1,rows,M,W)
        nop_in = r(np.where(differs[None], pred_b, 0.0).sum(-1))
        nop_hops = r(np.where(differs[None], pred_b * hops[None], 0.0).sum(-1))
        dram_in = r(np.where(from_dram[None], pred_b, 0.0).sum(-1))

        def gather(k):
            return r(stack[k][:, bi, li, op_df])              # (nb, P, rows, M)
        comp_s, comp_e = gather("comp_seconds"), gather("comp_energy_pj")
        w_b, psum_b = gather("weight_bytes"), gather("psum_bytes")
        o_b, rr = gather("output_bytes"), gather("input_reread")
        elide = ~fl["load_wei"][None] & (op_df == ws)[None] \
            & stack["ws_resident"][:, None]
        load_w = np.where(elide, 0.0, w_b)
        write = np.where(fl["write_out"][None], o_b, 0.0)
        dram_read = r(r(load_w + r(dram_in * rr)) + r(stack["stream_bytes"])[:, None])
        dram_write = r(r(write + psum_b) + r(stack["extra_write_bytes"])[:, None])
        dram_bytes = r(dram_read + dram_write)
        t_dram = r(dram_bytes / hw.dram_bw)
        t_nop = r(nop_in / hw.nop_bw)
        e_dram = r(dram_bytes * E_DRAM_PJ_PER_BYTE)
        e_nop = r(r(nop_hops + r(dram_bytes * dram_hops[None])) * E_NOP_PJ_PER_BYTE_HOP)
        t_proc = np.maximum(comp_s, np.maximum(t_dram, t_nop))

        tp_seq = t_proc[:, ar[:, None], b_seq, l_seq]         # (nb, P, T)
        end = np.zeros((nb, p, t_len + 1))
        free = np.zeros((nb, p, hw.n_chiplets))
        for k in range(t_len):
            c = chip_seq[:, k]
            ready = end[:, ar[:, None], ppos_seq[:, k]].max(axis=2)
            fin = r(np.maximum(free[:, ar, c], ready) + tp_seq[:, :, k])
            end[:, :, k] = fin
            free[:, ar, c] = fin
        scale = np.array([g.scale for g in gs])[:, None]
        lat[c0:c0 + nb] = r(end[:, :, :t_len].max(axis=2) * scale)
        e_sum = r(comp_e.reshape(nb, p, -1).sum(-1)) \
            + r(e_dram.reshape(nb, p, -1).sum(-1)) + r(e_nop.reshape(nb, p, -1).sum(-1))
        en[c0:c0 + nb] = r(r(e_sum) * 1e-12 * scale)
    return lat, en
