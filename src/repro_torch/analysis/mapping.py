"""Static mapping-legality analyzer — the encoding contract of paper §IV.

The GA breeds ``(segmentation, layer_to_chip)`` pairs and the timing
backends consume their derived scheduled orders and padded
predecessor-position tensors. Nothing in between re-checks the contract,
and the numpy/XLA gathers do not fail loudly on violations (negative
chiplet ids wrap, non-binary segmentation bits silently reshuffle the
Algorithm-2 loop nest) — an illegal encoding prices *wrong*, not *noisily*.
This module checks the whole contract statically and reports structured
:class:`~repro_torch.analysis.diagnostics.Diagnostic` records:

=======  ===================================================================
rule     meaning
=======  ===================================================================
MAP001   segmentation/encoding shape mismatch (not (M-1,), or encoding
         shape differs from the graph it is checked against)
MAP002   segmentation bit not 0/1
MAP003   chiplet id outside ``[0, n_chiplets)``
MAP004   scheduled order is not a permutation of the graph's ops
         (wrong length, out-of-range op, duplicate/missing op)
MAP005   scheduled order violates a dependency: an op runs no later than
         one of its predecessors (columns ``[pred_lo, pred_hi)`` of the
         same micro-batch row)
MAP006   padded predecessor-position contract violated: an entry is
         neither the sentinel ``T`` (the permanently-zero slot every
         backend indexes for "no predecessor") nor an earlier step
MAP007   decode/prefill request contract violated: a decode request must
         process exactly one new token (``q_len == 1``) against an
         existing context (``kv_len >= 1`` — its KV must precede it), a
         prefill must satisfy ``kv_len >= q_len >= 1``
=======  ===================================================================

Entry points: :func:`verify_encoding` (one individual),
:func:`verify_population` (stacked population, vectorised),
:func:`population_legal_mask` (the vectorised boolean fast path the GA
pre-filter uses), :func:`verify_order` / :func:`verify_ppos` (explicit
schedule artefacts, e.g. hand-built orders in tests), and
:func:`assert_legal` which raises :class:`MappingLegalityError`.

Derived orders of *any* segmentation are topological whenever the graph's
predecessor intervals point to strictly earlier columns (the Algorithm-2
loop nest schedules earlier columns of a row first), so on GA-bred
encodings the binding rules are MAP002/MAP003 — MAP004–006 guard
hand-built schedules and the padding machinery itself.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..core.encoding import (
    MappingEncoding,
    StackedPopulation,
    as_stacked,
    scheduled_orders,
)
from ..core.timing import (
    padded_predecessor_columns,
    padded_predecessor_positions,
)
from .diagnostics import ERROR, Diagnostic, format_diagnostics, is_legal

__all__ = [
    "MappingLegalityError", "verify_encoding", "verify_population",
    "verify_order", "verify_ppos", "verify_requests",
    "population_legal_mask", "assert_legal", "assert_population_legal",
    "is_legal", "VERIFY_ENV", "verify_env_enabled",
]

# evaluator-side debug gate: when set (and not "0"), every evaluation —
# the numpy oracle and the torch population evaluators alike — runs the
# analyzer on its inputs before pricing and raises MappingLegalityError
# instead of silently mispricing an illegal encoding
VERIFY_ENV = "REPRO_VERIFY_MAPPINGS"


def verify_env_enabled() -> bool:
    """True when the ``REPRO_VERIFY_MAPPINGS`` debug gate is on."""
    return os.environ.get(VERIFY_ENV, "0") not in ("", "0")

# cap on per-rule diagnostic records: populations are large and a single
# systematic bug (e.g. an unclamped mutation) violates every individual —
# the first few loci identify it, the count is in the summary record
MAX_PER_RULE = 16


class MappingLegalityError(ValueError):
    """Raised by :func:`assert_legal` / the ``REPRO_VERIFY_MAPPINGS``
    evaluator gates; carries the structured diagnostics."""

    def __init__(self, diagnostics: "list[Diagnostic]"):
        self.diagnostics = list(diagnostics)
        super().__init__(
            "illegal mapping encoding:\n" + format_diagnostics(self.diagnostics))


def _pred_intervals(graph, pred_lo, pred_hi, m_cols: int):
    """Resolve predecessor intervals from an ``ExecutionGraph`` or explicit
    arrays; ``(None, None)`` when the caller has no dependency structure
    (MAP004-006 are skipped)."""
    if graph is not None:
        pred_lo = np.array([m.pred_lo for m in graph.layers], dtype=np.int64)
        pred_hi = np.array([m.pred_hi for m in graph.layers], dtype=np.int64)
    if pred_lo is None:
        return None, None
    pred_lo = np.asarray(pred_lo, dtype=np.int64)
    pred_hi = np.asarray(pred_hi, dtype=np.int64)
    if pred_lo.shape != (m_cols,) or pred_hi.shape != (m_cols,):
        raise ValueError(
            f"predecessor intervals have shape {pred_lo.shape}/{pred_hi.shape},"
            f" expected ({m_cols},)")
    return pred_lo, pred_hi


def _population_violations(pop: StackedPopulation, n_chiplets: int,
                           pred_lo, pred_hi):
    """Vectorised per-rule violation arrays over a stacked population.

    Returns ``(violations, pred_cols)`` where ``violations`` maps rule id
    to a boolean array (``MAP001`` is a scalar — shape errors are
    population-wide) and ``pred_cols`` is the padded predecessor-column
    matrix (for diagnostic messages), or ``None`` when no dependency
    structure was supplied."""
    seg, l2c = pop.segmentation, pop.layer_to_chip
    p, rows, m_cols = l2c.shape
    out: dict = {}
    out["MAP001"] = seg.shape != (p, max(m_cols - 1, 0))
    if not out["MAP001"]:
        out["MAP002"] = (seg != 0) & (seg != 1)
    out["MAP003"] = (l2c < 0) | (l2c >= int(n_chiplets))
    pred_cols = None
    if pred_lo is not None and not out["MAP001"]:
        pred_cols, pred_valid = padded_predecessor_columns(pred_lo, pred_hi)
        # truthiness semantics, matching MappingEncoding.scheduled_order:
        # a non-binary bit (already a MAP002 error) still acts as a boundary
        orders = scheduled_orders((seg != 0).astype(np.uint8), rows, m_cols)
        t_len = rows * m_cols
        pos = np.empty((p, rows, m_cols), dtype=np.int64)
        pos[np.arange(p)[:, None], orders[:, :, 0], orders[:, :, 1]] = \
            np.arange(t_len, dtype=np.int64)[None, :]
        # op at (row, l) must run strictly after every valid predecessor
        # column of the same row: (P, rows, M, W)
        out["MAP005"] = pred_valid[None, None] & \
            (pos[:, :, pred_cols] >= pos[:, :, :, None])
    return out, pred_cols


def population_legal_mask(population, n_chiplets: int, *, graph=None,
                          pred_lo=None, pred_hi=None) -> np.ndarray:
    """(P,) bool — True where the individual satisfies the encoding
    contract. The GA pre-filter fast path: one vectorised sweep, no
    ``Diagnostic`` objects materialised."""
    pop = as_stacked(population)
    p, _, m_cols = pop.layer_to_chip.shape
    pred_lo, pred_hi = _pred_intervals(graph, pred_lo, pred_hi, m_cols)
    v, _ = _population_violations(pop, n_chiplets, pred_lo, pred_hi)
    if v["MAP001"]:
        return np.zeros(p, dtype=bool)
    ok = ~v["MAP002"].any(axis=1)
    ok &= ~v["MAP003"].any(axis=(1, 2))
    if "MAP005" in v:
        ok &= ~v["MAP005"].any(axis=(1, 2, 3))
    return ok


def verify_population(population, n_chiplets: int, *, graph=None,
                      pred_lo=None, pred_hi=None,
                      max_per_rule: int = MAX_PER_RULE) -> "list[Diagnostic]":
    """Check a stacked population (or encoding list) against the full
    contract; diagnostics carry the population index in ``individual``.
    With ``graph`` supplied, the dependency rules (MAP005) and the
    request contract (MAP007) are checked too."""
    pop = as_stacked(population)
    seg, l2c = pop.segmentation, pop.layer_to_chip
    p, _, m_cols = l2c.shape
    pred_lo, pred_hi = _pred_intervals(graph, pred_lo, pred_hi, m_cols)
    v, pred_cols = _population_violations(pop, n_chiplets, pred_lo, pred_hi)
    diags: list[Diagnostic] = []
    if v["MAP001"]:
        diags.append(Diagnostic(
            "MAP001",
            f"segmentation shape {seg.shape} does not match"
            f" (P, M-1) = {(p, max(m_cols - 1, 0))}"))
        return diags  # every downstream rule keys off the segmentation
    for i, c in _capped(v["MAP002"], max_per_rule):
        diags.append(Diagnostic(
            "MAP002", f"segmentation bit {int(seg[i, c])} is not 0/1",
            col=int(c), individual=int(i)))
    for i, b, l in _capped(v["MAP003"], max_per_rule):
        diags.append(Diagnostic(
            "MAP003",
            f"chiplet id {int(l2c[i, b, l])} outside [0, {int(n_chiplets)})",
            row=int(b), col=int(l), individual=int(i)))
    for i, b, l, w in _capped(v.get("MAP005"), max_per_rule):
        diags.append(Diagnostic(
            "MAP005",
            f"op (row {int(b)}, col {int(l)}) is scheduled no later than its"
            f" predecessor col {int(pred_cols[l, w])}",
            row=int(b), col=int(l), individual=int(i)))
    if graph is not None:
        diags.extend(verify_requests(graph))
    return diags


def _capped(viol, max_per_rule: int):
    """First ``max_per_rule`` violation loci (index tuples) of a boolean
    array; the total count is visible via ``format_diagnostics``'s
    truncation note when callers render more findings than the cap."""
    if viol is None or not viol.any():
        return []
    return [tuple(ix) for ix in np.argwhere(viol)[:max_per_rule]]


def verify_encoding(enc: MappingEncoding, n_chiplets: int, *, graph=None,
                    pred_lo=None, pred_hi=None,
                    max_per_rule: int = MAX_PER_RULE) -> "list[Diagnostic]":
    """Check one encoding. Beyond the population rules this also derives
    the scheduled order and its padded predecessor positions and verifies
    the artefacts the timing backends would actually consume (MAP004/006
    self-check of the padding machinery)."""
    if graph is not None and (enc.rows, enc.n_cols) != (graph.rows,
                                                        graph.n_cols):
        return [Diagnostic(
            "MAP001",
            f"encoding shape {(enc.rows, enc.n_cols)} does not match graph"
            f" shape {(graph.rows, graph.n_cols)}")]
    pop = StackedPopulation(enc.segmentation[None], enc.layer_to_chip[None])
    diags = [dataclasses.replace(d, individual=None)
             for d in verify_population(pop, n_chiplets, graph=graph,
                                        pred_lo=pred_lo, pred_hi=pred_hi,
                                        max_per_rule=max_per_rule)]
    pred_lo, pred_hi = _pred_intervals(graph, pred_lo, pred_hi, enc.n_cols)
    if pred_lo is not None and is_legal(diags):
        diags.extend(verify_order(enc.scheduled_order(), enc.rows,
                                  enc.n_cols, pred_lo=pred_lo,
                                  pred_hi=pred_hi))
    return diags


def verify_order(order, rows: int, m_cols: int, *, graph=None,
                 pred_lo=None, pred_hi=None,
                 max_per_rule: int = MAX_PER_RULE) -> "list[Diagnostic]":
    """Check an explicit scheduled order (T, 2): MAP004 (permutation of
    the graph's ops), then — when dependency structure is supplied —
    MAP005 (topological) and MAP006 (the padded predecessor positions
    derived from it honour the sentinel/backpointer contract)."""
    order = np.asarray(order)
    t_len = rows * m_cols
    if order.ndim != 2 or order.shape != (t_len, 2):
        return [Diagnostic(
            "MAP004",
            f"scheduled order shape {order.shape} != ({t_len}, 2)")]
    b_seq, l_seq = order[:, 0], order[:, 1]
    diags: list[Diagnostic] = []
    oob = (b_seq < 0) | (b_seq >= rows) | (l_seq < 0) | (l_seq >= m_cols)
    if oob.any():
        for (step,) in _capped(oob, max_per_rule):
            diags.append(Diagnostic(
                "MAP004",
                f"step {int(step)} references op ({int(b_seq[step])},"
                f" {int(l_seq[step])}) outside the ({rows}, {m_cols}) graph",
                row=int(b_seq[step]), col=int(l_seq[step])))
        return diags
    counts = np.bincount(b_seq * m_cols + l_seq, minlength=t_len)
    if (counts != 1).any():
        for (flat,) in _capped(counts != 1, max_per_rule):
            b, l = divmod(int(flat), m_cols)
            diags.append(Diagnostic(
                "MAP004",
                f"op ({b}, {l}) appears {int(counts[flat])} times in the"
                " scheduled order (expected exactly once)",
                row=b, col=l))
        return diags
    pred_lo, pred_hi = _pred_intervals(graph, pred_lo, pred_hi, m_cols)
    if pred_lo is None:
        return diags
    pred_cols, pred_valid = padded_predecessor_columns(pred_lo, pred_hi)
    pos = np.empty((rows, m_cols), dtype=np.int64)
    pos[b_seq, l_seq] = np.arange(t_len, dtype=np.int64)
    viol = pred_valid & (pos[:, pred_cols] >= pos[:, :, None])
    for b, l, w in _capped(viol, max_per_rule):
        diags.append(Diagnostic(
            "MAP005",
            f"op (row {int(b)}, col {int(l)}) at step {int(pos[b, l])} is"
            f" scheduled no later than its predecessor col"
            f" {int(pred_cols[l, w])} at step {int(pos[b, pred_cols[l, w]])}",
            row=int(b), col=int(l)))
    ppos = padded_predecessor_positions(order.astype(np.int32), pred_cols,
                                        pred_valid)
    diags.extend(verify_ppos(ppos, t_len, max_per_rule=max_per_rule))
    return diags


def verify_ppos(ppos, t_len: int, *,
                max_per_rule: int = MAX_PER_RULE) -> "list[Diagnostic]":
    """Check a padded predecessor-position tensor (T, W) against the
    backend contract: every entry is either the sentinel ``t_len`` (the
    permanently-zero end-vector slot) or a strictly earlier step index —
    a self/forward reference would make the pass-B recurrence read an
    end time that has not been written yet."""
    ppos = np.asarray(ppos)
    steps = np.arange(ppos.shape[0], dtype=np.int64)[:, None]
    bad = ~((ppos == t_len) | ((ppos >= 0) & (ppos < steps)))
    diags = []
    for t, w in _capped(bad, max_per_rule):
        diags.append(Diagnostic(
            "MAP006",
            f"padded predecessor position {int(ppos[t, w])} at step {int(t)}"
            f" (slot {int(w)}) is neither the sentinel {t_len} nor an"
            " earlier step"))
    return diags


def verify_requests(graph, *,
                    max_per_rule: int = MAX_PER_RULE) -> "list[Diagnostic]":
    """MAP007 — the decode/prefill precedence contract on the graph's
    serving requests: a decode step processes exactly one new token whose
    KV context already exists (``q_len == 1``, ``kv_len >= 1`` — prefill
    precedes decode by construction), a prefill chunk attends at least
    its own tokens (``kv_len >= q_len >= 1``)."""
    from ..core.workload import DECODE, PREFILL

    diags: list[Diagnostic] = []
    for b, reqs in enumerate(getattr(graph, "requests_per_row", []) or []):
        for r in reqs:
            if len(diags) >= max_per_rule:
                return diags
            if r.kind == DECODE:
                if r.q_len != 1:
                    diags.append(Diagnostic(
                        "MAP007",
                        f"decode request has q_len={r.q_len} (a decode step"
                        " processes exactly one new token)", row=b))
                elif r.kv_len < 1:
                    diags.append(Diagnostic(
                        "MAP007",
                        f"decode request has kv_len={r.kv_len} (its context"
                        " must already hold the token being decoded)", row=b))
            elif r.kind == PREFILL:
                if not (1 <= r.q_len <= r.kv_len):
                    diags.append(Diagnostic(
                        "MAP007",
                        f"prefill request has q_len={r.q_len},"
                        f" kv_len={r.kv_len} (requires kv_len >= q_len >= 1)",
                        row=b))
            else:
                diags.append(Diagnostic(
                    "MAP007", f"unknown request kind {r.kind!r}", row=b))
    return diags


def assert_legal(enc: MappingEncoding, n_chiplets: int, *, graph=None,
                 pred_lo=None, pred_hi=None) -> None:
    """Raise :class:`MappingLegalityError` when ``enc`` violates the
    contract — the ``REPRO_VERIFY_MAPPINGS=1`` evaluator gate."""
    diags = [d for d in verify_encoding(enc, n_chiplets, graph=graph,
                                        pred_lo=pred_lo, pred_hi=pred_hi)
             if d.severity == ERROR]
    if diags:
        raise MappingLegalityError(diags)


def assert_population_legal(population, n_chiplets: int, *, graph=None,
                            pred_lo=None, pred_hi=None) -> None:
    """Population form of :func:`assert_legal` — the population evaluators'
    ``REPRO_VERIFY_MAPPINGS=1`` gate (checked host-side, before
    dispatch, so the device passes stay pure)."""
    diags = [d for d in verify_population(population, n_chiplets,
                                          graph=graph, pred_lo=pred_lo,
                                          pred_hi=pred_hi)
             if d.severity == ERROR]
    if diags:
        raise MappingLegalityError(diags)
