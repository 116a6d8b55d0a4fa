"""Float64 numpy references of the hand-written kernels: the
straightforward implementations every other version is held against
(sequential pass B for the mapping-evaluation kernels, one dense softmax
for the attention kernels, the position-by-position recurrence for the SSD
scan)."""
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


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def flash_attention_reference(
    q: np.ndarray,  # [B, Hq, Lq, D]
    k: np.ndarray,  # [B, Hkv, Lk, D]
    v: np.ndarray,  # [B, Hkv, Lk, D]
    causal: bool = True,
    scale: float | None = None,
) -> np.ndarray:
    """GQA attention in float64: query head h reads kv head h // rep;
    causal queries occupy the LAST Lq positions of the Lk-long context."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    lq, d = q.shape[2], q.shape[3]
    rep = q.shape[1] // k.shape[1]
    scale = 1.0 / np.sqrt(d) if scale is None else scale
    k = np.repeat(k, rep, axis=1)
    v = np.repeat(v, rep, axis=1)
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        qi = np.arange(lq)[:, None] + (k.shape[2] - lq)
        ki = np.arange(k.shape[2])[None, :]
        logits = np.where(ki <= qi, logits, -np.inf)
    return np.einsum("bhqk,bhkd->bhqd", _softmax(logits), v)


def decode_attention_reference(
    q: np.ndarray,        # [B, Hq, D] — one new token per sequence
    k_cache: np.ndarray,  # [B, S, Hkv, D]
    v_cache: np.ndarray,  # [B, S, Hkv, D]
    lengths: np.ndarray,  # [B] valid context length per sequence
    scale: float | None = None,
) -> np.ndarray:
    """One-token GQA decode in float64 over the first ``lengths[b]``
    cache positions of each sequence."""
    q, k_cache, v_cache = (np.asarray(a, np.float64)
                           for a in (q, k_cache, v_cache))
    s, d = k_cache.shape[1], q.shape[-1]
    rep = q.shape[1] // k_cache.shape[2]
    scale = 1.0 / np.sqrt(d) if scale is None else scale
    kk = np.repeat(k_cache, rep, axis=2)
    vv = np.repeat(v_cache, rep, axis=2)
    logits = np.einsum("bhd,bshd->bhs", q, kk) * scale
    mask = np.arange(s)[None, None, :] < np.asarray(lengths)[:, None, None]
    logits = np.where(mask, logits, -np.inf)
    return np.einsum("bhs,bshd->bhd", _softmax(logits), vv)


def ssd_reference(
    x: np.ndarray,      # [B, L, H, P]
    dt: np.ndarray,     # [B, L, H]  (softplus-activated step size)
    a: np.ndarray,      # [H]        (negative decay rate, A = -exp(a_log))
    b_mat: np.ndarray,  # [B, L, N]
    c_mat: np.ndarray,  # [B, L, N]
    init_state: np.ndarray | None = None,  # [B, H, N, P]
) -> tuple[np.ndarray, np.ndarray]:
    """The Mamba-2 SSD recurrence in float64, one position at a time (one
    B/C group shared by all heads):

        S_t = exp(a * dt_t) * S_{t-1} + dt_t * B_t^T x_t
        y_t = C_t S_t

    Returns (y [B, L, H, P], final state [B, H, N, P])."""
    x, dt, a, b_mat, c_mat = (np.asarray(v, np.float64)
                              for v in (x, dt, a, b_mat, c_mat))
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    state = (np.zeros((bsz, h, n, p)) if init_state is None
             else np.asarray(init_state, np.float64).copy())
    y = np.zeros((bsz, l, h, p))
    for t in range(l):
        decay = np.exp(a[None, :] * dt[:, t])                    # [B, H]
        upd = np.einsum("bn,bhp->bhnp", b_mat[:, t],
                        x[:, t] * dt[:, t][..., None])
        state = state * decay[:, :, None, None] + upd
        y[:, t] = np.einsum("bn,bhnp->bhp", c_mat[:, t], state)
    return y, state
