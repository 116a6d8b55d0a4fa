"""Frozen copy of the port's ``core/dataflow.py`` (pure Python and numpy), kept
beside the benchmark so that the reference rebuilds what the port derives
(rollouts, execution graphs, cost tables) with code that later changes to
the port cannot move. The original docstring follows.

ZigZag-lite intra-chiplet cost model (paper §V-C "Intra-Chiplet Evaluation").

Models a GEMM of (M x K) @ (K x N) on one chiplet under a weight-stationary
(WS) or output-stationary (OS) dataflow template with a capacity-aware tile
search (the paper's "temporal tiling"; "spatial tiling" — tensor parallelism —
is handled one level up in the execution graph).

GLB budget split: 1/2 for the dataflow's resident operand, 1/4 each for the
two streaming operands (double-buffered).

WS template — weight tile (Tk x Tn) resident; M streamed in chunks Mc sized
so the psum strip (Mc x Tn) stays GLB-resident (psums never spill to DRAM,
they revisit the GLB per array-K-pass):
    DRAM: weights K*N (x n_chunks when the full weight matrix exceeds the
          resident budget — the weight-rotation penalty that grows with M),
          inputs M*K (x ceil(N/Tn) when the input chunk cannot be cached),
          outputs M*N.
    cycles: ceil(K/a)*ceil(N/a) array tiles x (M + a) — per-tile pipeline
          fill `a`, so WS loses utilisation on short sequences but streams
          long ones at full rate.

OS template — output tile (Tm x Tn) resident; K streamed:
    DRAM: outputs M*N once, weights K*N (x ceil(M/Tm) when weights exceed
          the stream cache — the weight-restream penalty that also grows
          with M but with the *output* tile amortising it), inputs M*K
          (x ceil(N/Tn) uncached).
    cycles: ceil(M/a)*ceil(N/a) array tiles x (K + 2a) — fill + drain, so OS
          loses utilisation when K dominates (e.g. GEMV-ish decode slices).

The big *serving-level* asymmetry — WS chiplets retain weights across
micro-batches (Algorithm 2's isLoadWei) whenever the layer's weight slice
fits the resident budget, OS chiplets cannot (outputs occupy the GLB) — is
applied by the evaluation engine, not here. See DESIGN.md §6 for the
calibration discussion vs the paper's Table I.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .hardware import (
    BYTES_PER_ELEM,
    E_GLB_PJ_PER_BYTE,
    E_MAC_PJ,
    E_VECTOR_PJ_PER_OP,
    FREQ_HZ,
    ChipletSpec,
)

RESIDENT_FRACTION = 0.5   # GLB share of the dataflow's resident operand
STREAM_FRACTION = 0.25    # GLB share of each streaming operand
VECTOR_LANES = 256        # post-processing vector unit width (ops/cycle)

_TILE_GRID = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class GemmCost:
    """Cost components for one GEMM on one chiplet. Times in cycles,
    traffic in bytes, energy in pJ."""

    compute_cycles: float
    mac_energy_pj: float
    glb_energy_pj: float
    weight_bytes: float       # DRAM weight traffic (elidable via isLoadWei)
    input_bytes: float        # DRAM input traffic if sourced from DRAM
    output_bytes: float       # DRAM output write-back (elidable, isWriteOut)
    psum_spill_bytes: float   # kept for API compat; 0 under these templates
    input_reread_factor: float
    ws_resident_ok: bool      # weight slice fits the resident GLB budget

    @property
    def compute_seconds(self) -> float:
        return self.compute_cycles / FREQ_HZ


def gemm_cost(
    m: int, k: int, n: int,
    spec: ChipletSpec,
    dataflow: str,
    post_flops: float = 0.0,
) -> GemmCost:
    m, k, n = max(1, int(m)), max(1, int(k)), max(1, int(n))
    a = spec.array_dim
    glb_elems = spec.glb_bytes // BYTES_PER_ELEM
    cap_res = int(glb_elems * RESIDENT_FRACTION)
    cap_str = int(glb_elems * STREAM_FRACTION)
    macs = float(m) * k * n
    kn = float(k) * n
    mk = float(m) * k
    mn = float(m) * n

    psum_glb = 2.0 * mn * max(0, _ceil_div(k, a) - 1)  # array-depth revisits,
    # identical for both dataflows (psums accumulate through the GLB whenever
    # K exceeds the array depth)
    best = None
    if dataflow == "WS":
        cycles = _ceil_div(k, a) * _ceil_div(n, a) * (m + a)
        for tk in _TILE_GRID:
            tk = min(tk, k)
            tn = min(n, max(1, cap_res // tk))
            ck, cn = _ceil_div(k, tk), _ceil_div(n, tn)
            mc = min(m, max(1, cap_str // tn))          # psum strip chunk
            n_chunks = _ceil_div(m, mc)
            w = kn if kn <= cap_res else kn * n_chunks  # weight rotation
            inp_cached = mc * k <= cap_str
            rr = 1.0 if inp_cached else float(cn)
            inp = mk * rr
            glb = kn + mk * cn + psum_glb + mn
            tot = w + inp + mn
            if best is None or tot < best[0]:
                best = (tot, w, inp, mn, rr, glb)
    elif dataflow == "OS":
        cycles = _ceil_div(m, a) * _ceil_div(n, a) * (k + a)
        for tm in _TILE_GRID:
            tm = min(tm, m)
            tn = min(n, max(1, cap_res // tm))
            cm, cn = _ceil_div(m, tm), _ceil_div(n, tn)
            w = kn if kn <= cap_str else kn * cm        # weight restream
            inp_cached = mk <= cap_str
            rr = 1.0 if inp_cached else float(cn)
            inp = mk * rr
            glb = mn + mk * cn + kn * cm + psum_glb
            tot = w + inp + mn
            if best is None or tot < best[0]:
                best = (tot, w, inp, mn, rr, glb)
    else:
        raise ValueError(f"unknown dataflow {dataflow!r}")

    _, w, inp, out, rr, glb = best
    cycles += post_flops / VECTOR_LANES
    glb_energy = glb * BYTES_PER_ELEM * E_GLB_PJ_PER_BYTE

    return GemmCost(
        compute_cycles=float(cycles),
        mac_energy_pj=macs * E_MAC_PJ + post_flops * E_VECTOR_PJ_PER_OP,
        glb_energy_pj=glb_energy,
        weight_bytes=w * BYTES_PER_ELEM,
        input_bytes=inp * BYTES_PER_ELEM,
        output_bytes=out * BYTES_PER_ELEM,
        psum_spill_bytes=0.0,
        input_reread_factor=rr,
        ws_resident_ok=kn <= cap_res,
    )


@dataclass(frozen=True)
class GemmCostBatch:
    """``gemm_cost`` over a whole descriptor batch — every field is a (G,)
    float64/bool array. Semantics match the scalar path exactly (same tile
    grid, same first-strict-minimum tie-break); ``post_flops`` is *not*
    folded in here — it is separable (added after tile selection) and the
    batched caller accounts it per op."""

    compute_cycles: np.ndarray
    mac_energy_pj: np.ndarray
    glb_energy_pj: np.ndarray
    weight_bytes: np.ndarray
    input_bytes: np.ndarray
    output_bytes: np.ndarray
    psum_spill_bytes: np.ndarray
    input_reread_factor: np.ndarray
    ws_resident_ok: np.ndarray


def gemm_cost_batch(m, k, n, spec: ChipletSpec, dataflow: str) -> GemmCostBatch:
    """Vectorised ``gemm_cost`` over (G,) GEMM-shape arrays: the 8-entry
    tile grid is evaluated as one (G, 8) array sweep and reduced with a
    first-minimum ``argmin`` (== the scalar loop's strict-< update)."""
    m = np.maximum(1, np.asarray(m, dtype=np.int64))
    k = np.maximum(1, np.asarray(k, dtype=np.int64))
    n = np.maximum(1, np.asarray(n, dtype=np.int64))
    a = spec.array_dim
    glb_elems = spec.glb_bytes // BYTES_PER_ELEM
    cap_res = int(glb_elems * RESIDENT_FRACTION)
    cap_str = int(glb_elems * STREAM_FRACTION)
    macs = m.astype(np.float64) * k * n
    kn = k.astype(np.float64) * n
    mk = m.astype(np.float64) * k
    mn = m.astype(np.float64) * n
    psum_glb = 2.0 * mn * np.maximum(0, _ceil_div(k, a) - 1)

    grid = np.asarray(_TILE_GRID, dtype=np.int64)[None, :]          # (1, T)
    kc, nc, mc2 = k[:, None], n[:, None], m[:, None]
    knc, mkc, mnc = kn[:, None], mk[:, None], mn[:, None]
    if dataflow == "WS":
        cycles = (_ceil_div(k, a) * _ceil_div(n, a) * (m + a)).astype(np.float64)
        tk = np.minimum(grid, kc)
        tn = np.minimum(nc, np.maximum(1, cap_res // tk))
        cn = _ceil_div(nc, tn)
        mc = np.minimum(mc2, np.maximum(1, cap_str // tn))          # psum strip
        n_chunks = _ceil_div(mc2, mc)
        w = np.where(knc <= cap_res, knc, knc * n_chunks)           # rotation
        rr = np.where(mc * kc <= cap_str, 1.0, cn.astype(np.float64))
        inp = mkc * rr
        glb = knc + mkc * cn + psum_glb[:, None] + mnc
    elif dataflow == "OS":
        cycles = (_ceil_div(m, a) * _ceil_div(n, a) * (k + a)).astype(np.float64)
        tm = np.minimum(grid, mc2)
        tn = np.minimum(nc, np.maximum(1, cap_res // tm))
        cm = _ceil_div(mc2, tm)
        cn = _ceil_div(nc, tn)
        w = np.where(knc <= cap_str, knc, knc * cm)                 # restream
        rr = np.where(mkc <= cap_str, 1.0, cn.astype(np.float64))
        inp = mkc * rr
        glb = mnc + mkc * cn + knc * cm + psum_glb[:, None]
    else:
        raise ValueError(f"unknown dataflow {dataflow!r}")

    tot = w + inp + mnc
    best = np.argmin(tot, axis=1)
    pick = (np.arange(len(best)), best)
    w, inp, rr, glb = w[pick], inp[pick], rr[pick], glb[pick]

    return GemmCostBatch(
        compute_cycles=cycles,
        mac_energy_pj=macs * E_MAC_PJ,
        glb_energy_pj=glb * BYTES_PER_ELEM * E_GLB_PJ_PER_BYTE,
        weight_bytes=w * BYTES_PER_ELEM,
        input_bytes=inp * BYTES_PER_ELEM,
        output_bytes=mn * BYTES_PER_ELEM,
        psum_spill_bytes=np.zeros_like(mn),
        input_reread_factor=rr,
        ws_resident_ok=kn <= cap_res,
    )


def vector_cost(flops: float, spec: ChipletSpec) -> GemmCost:  # noqa: ARG001
    # `spec` mirrors gemm_cost's signature so cost functions dispatch uniformly
    """Post-processing-unit-only op (reduction / normalisation / router)."""
    return GemmCost(
        compute_cycles=flops / VECTOR_LANES,
        mac_energy_pj=flops * E_VECTOR_PJ_PER_OP,
        glb_energy_pj=0.0,
        weight_bytes=0.0,
        input_bytes=0.0,
        output_bytes=0.0,
        psum_spill_bytes=0.0,
        input_reread_factor=1.0,
        ws_resident_ok=True,
    )
