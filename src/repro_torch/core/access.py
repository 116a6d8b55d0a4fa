"""Algorithm 2 — data-access-flag determination (paper §V-C).

A single scan over the scheduled op order maintains a chiplet status table
(last (row, col) executed per chiplet) and derives, from the mapping alone:

* ``is_load_wei[b, l]`` — False when the op's chiplet just executed the same
  layer column for a different micro-batch (weights still resident). Applied
  by the evaluator only on WS chiplets — weights are the resident operand
  there; an OS chiplet evicts weights every output pass (DESIGN.md §6).
* ``is_write_out[b, l]`` — False when every successor consumed the output
  while it was still live on the producing chiplet (no DRAM write-back).
* per-op NoP vs DRAM sourcing of each predecessor activation: a predecessor
  still live on its chiplet is fetched over the NoP (hop-weighted), otherwise
  from DRAM.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .encoding import MappingEncoding
from .hardware import HardwareConfig
from .workload import ExecutionGraph


@dataclass
class AccessFlags:
    is_load_wei: np.ndarray     # (rows, M) bool
    is_write_out: np.ndarray    # (rows, M) bool
    nop_in_bytes: np.ndarray    # (rows, M) activation bytes arriving via NoP
    nop_in_byte_hops: np.ndarray  # (rows, M) hop-weighted NoP bytes (energy)
    dram_in_bytes: np.ndarray   # (rows, M) activation bytes fetched from DRAM


def data_access_flags(
    graph: ExecutionGraph,
    enc: MappingEncoding,
    hw: HardwareConfig,
) -> AccessFlags:
    rows, m_cols = enc.rows, enc.n_cols
    bpe_out = np.zeros((rows, m_cols))
    for b in range(rows):
        for l in range(m_cols):
            bpe_out[b, l] = graph.ops[b][l].out_elems * 2  # bf16

    is_load_wei = np.ones((rows, m_cols), dtype=bool)
    is_write_out = np.ones((rows, m_cols), dtype=bool)
    nop_in = np.zeros((rows, m_cols))
    nop_hops = np.zeros((rows, m_cols))
    dram_in = np.zeros((rows, m_cols))

    # chip status table: last (row, col) per chiplet
    state_row = np.full(hw.n_chiplets, -1, dtype=np.int64)
    state_col = np.full(hw.n_chiplets, -1, dtype=np.int64)
    # remaining unconsumed successors per op (successors = columns whose pred
    # interval contains this column, same row)
    n_succ = np.zeros(m_cols, dtype=np.int64)
    for meta in graph.layers:
        if meta.pred_lo >= 0:
            n_succ[meta.pred_lo:meta.pred_hi] += 1
    remaining = np.tile(n_succ, (rows, 1))

    l2c = enc.layer_to_chip
    for b, l in enc.scheduled_order():
        chip = int(l2c[b, l])
        meta = graph.layers[l]
        # weight residency (same column, different row, consecutively on chip)
        if (state_col[chip] == l and state_row[chip] != b
                and graph.ops[b][l].weight_elems > 0):
            is_load_wei[b, l] = False
        # predecessor sourcing
        if meta.pred_lo >= 0:
            for p in range(meta.pred_lo, meta.pred_hi):
                cp = int(l2c[b, p])
                live = state_row[cp] == b and state_col[cp] == p
                nbytes = bpe_out[b, p]
                if live:
                    remaining[b, p] -= 1
                    if remaining[b, p] == 0:
                        is_write_out[b, p] = False
                    if cp != chip:
                        nop_in[b, l] += nbytes
                        nop_hops[b, l] += nbytes * hw.hops(cp, chip)
                else:
                    dram_in[b, l] += nbytes
        state_row[chip], state_col[chip] = b, l

    return AccessFlags(is_load_wei, is_write_out, nop_in, nop_hops, dram_in)
