"""Float64 numpy references of the mapping-evaluation kernels: the
straightforward sequential implementations every other version of pass B
is held against."""
from __future__ import annotations

import numpy as np


def mapping_eval_reference(
    t_proc: np.ndarray,  # [B, P, T] per-op processing time in scheduled order
    chip: np.ndarray,    # [P, T]    chiplet of each scheduled op
    ppos: np.ndarray,    # [P, T, W] padded predecessor positions (sentinel T)
    n_chips: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Sequential timing recurrence (evaluation-engine pass B):
    start = max(chip_free, max over predecessor end times), predecessors
    given as padded positions into the scheduled order (the sentinel T
    indexes a permanently-zero slot). Returns the full timing matrix —
    (end [B, P, T], chip free [B, P, C]) — per (batch, population) member."""
    n_batch, pop, t_len = t_proc.shape
    end = np.zeros((n_batch, pop, t_len))
    free = np.zeros((n_batch, pop, n_chips))
    for bi in range(n_batch):
        for pi in range(pop):
            endv = np.zeros(t_len + 1)
            chip_free = np.zeros(n_chips)
            for t in range(t_len):
                c = chip[pi, t]
                pred_end = endv[ppos[pi, t]].max()
                start = max(chip_free[c], pred_end)
                fin = start + t_proc[bi, pi, t]
                endv[t] = fin
                chip_free[c] = fin
            end[bi, pi] = endv[:t_len]
            free[bi, pi] = chip_free
    return end, free


def mapping_eval_fused_reference(
    t_proc: np.ndarray,    # [B, P, L] un-gathered per-individual cost rows
    sched_idx: np.ndarray,  # [P, T] flat cost-row index per schedule step
    chip: np.ndarray,      # [P, T]
    ppos: np.ndarray,      # [P, T, W]
    n_chips: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Fused-contract reference (float64): pass A as a numpy gather of the
    un-gathered cost rows, then :func:`mapping_eval_reference` pass B."""
    t_proc = np.asarray(t_proc)
    sched_idx = np.asarray(sched_idx)
    n_batch, pop, _ = t_proc.shape
    idx = np.broadcast_to(sched_idx[None],
                          (n_batch,) + sched_idx.shape)
    tproc_sched = np.take_along_axis(t_proc, idx, axis=-1)
    return mapping_eval_reference(tproc_sched, chip, ppos, n_chips)
