"""Hardware sampling engine — Bayesian optimisation (paper §V-B).

Searches the discrete joint configuration tensor Z = [z_sys, z_shape,
z_layout]:

* z_shape — uniform chiplet capacity (S/M/L). The total-compute target is a
  hard constraint, so the capacity dictates the chiplet count and thus the
  package array dimension (H, W).
* z_layout — a dataflow type (WS/OS) per array slot.
* z_sys — NoP bandwidth, per-chip DRAM bandwidth, prefill/decode micro-batch
  sizes, tensor parallelism (Table IV).

Surrogate: Gaussian process with the hardware-aware composite kernel
(Eqs. 2-4):

    K(Z, Z') = K_sys(z_sys, z'_sys) * (1 + 1[z_shape == z'_shape]
                                           * K_layout(z_layout, z'_layout))

K_layout cross-compares all slot pairs, weighting same-type matches by
exp(-Manhattan(u, v) / lambda) — routing-hop-aware similarity. sigma^2 and
lambda (and the z_sys RBF length-scale) are fitted by marginal-likelihood
grid search each round. Acquisition: expected improvement, maximised by a
two-tier simulated-annealing proposer (outer: z_shape / z_sys macro moves
with layout reallocation on shape change; inner: single-slot replacement or
dual-slot swap on z_layout).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from .hardware import (
    CHIPLET_LIBRARY,
    DATAFLOWS,
    DRAM_BW_CANDIDATES_GBPS,
    MICRO_BATCH_DECODE_CANDIDATES,
    MICRO_BATCH_PREFILL_CANDIDATES,
    NOP_BW_CANDIDATES_GBPS,
    TENSOR_PARALLEL_CANDIDATES,
    HardwareConfig,
    grid_for_count,
    n_chiplets_for_target,
)

SYS_CANDIDATES = (
    NOP_BW_CANDIDATES_GBPS,
    DRAM_BW_CANDIDATES_GBPS,
    MICRO_BATCH_PREFILL_CANDIDATES,
    MICRO_BATCH_DECODE_CANDIDATES,
    TENSOR_PARALLEL_CANDIDATES,
)
SYS_NAMES = ("nop_bw", "dram_bw", "micro_batch_prefill", "micro_batch_decode",
             "tensor_parallel")
SPEC_NAMES = tuple(CHIPLET_LIBRARY.keys())


@dataclass(frozen=True)
class HardwarePoint:
    spec_name: str
    sys_idx: tuple[int, ...]      # indices into SYS_CANDIDATES
    layout: tuple[int, ...]       # dataflow index per slot

    def key(self) -> tuple:
        return (self.spec_name, self.sys_idx, self.layout)

    def to_config(self, target_tops: float) -> HardwareConfig:
        spec = CHIPLET_LIBRARY[self.spec_name]
        n = n_chiplets_for_target(target_tops, spec)
        grid = grid_for_count(n)
        vals = [SYS_CANDIDATES[i][j] for i, j in enumerate(self.sys_idx)]
        return HardwareConfig(
            spec_name=self.spec_name,
            grid=grid,
            layout=tuple(DATAFLOWS[t] for t in self.layout),
            nop_bw_gbps=vals[0],
            dram_bw_gbps=vals[1],
            micro_batch_prefill=vals[2],
            micro_batch_decode=vals[3],
            tensor_parallel=vals[4],
        )


def random_point(rng: np.random.Generator, target_tops: float) -> HardwarePoint:
    spec_name = SPEC_NAMES[rng.integers(len(SPEC_NAMES))]
    n = n_chiplets_for_target(target_tops, CHIPLET_LIBRARY[spec_name])
    return HardwarePoint(
        spec_name=spec_name,
        sys_idx=tuple(int(rng.integers(len(c))) for c in SYS_CANDIDATES),
        layout=tuple(int(rng.integers(len(DATAFLOWS))) for _ in range(n)),
    )


# --------------------------------------------------------------------------
# Composite kernel (Eqs. 2-4)
# --------------------------------------------------------------------------


def _sys_features(points: Sequence[HardwarePoint]) -> np.ndarray:
    """Normalised z_sys feature matrix (candidate index / (len-1))."""
    feats = np.zeros((len(points), len(SYS_CANDIDATES) + 1))
    for i, p in enumerate(points):
        for d, j in enumerate(p.sys_idx):
            feats[i, d] = j / max(len(SYS_CANDIDATES[d]) - 1, 1)
        feats[i, -1] = SPEC_NAMES.index(p.spec_name) / max(len(SPEC_NAMES) - 1, 1)
    return feats


def _layout_w(grid: tuple[int, int], lam: float) -> np.ndarray:
    """Positional similarity W_{u,v} = exp(-Manhattan(u,v)/lambda) (Eq. 4)."""
    h, w = grid
    ys, xs = np.divmod(np.arange(h * w), w)
    man = np.abs(xs[:, None] - xs[None, :]) + np.abs(ys[:, None] - ys[None, :])
    return np.exp(-man / lam)


def _layout_kernel(points: Sequence[HardwarePoint], target_tops: float,
                   sigma2: float, lam: float) -> np.ndarray:
    """Normalised K_layout (Eq. 3) with block support for differing shapes."""
    n = len(points)
    grids = {}
    for p in points:
        if p.spec_name not in grids:
            cnt = n_chiplets_for_target(target_tops, CHIPLET_LIBRARY[p.spec_name])
            grids[p.spec_name] = grid_for_count(cnt)
    w_cache = {s: _layout_w(g, lam) for s, g in grids.items()}
    layouts = [np.asarray(p.layout) for p in points]

    raw = np.zeros((n, n))
    for i in range(n):
        for j in range(i, n):
            if points[i].spec_name != points[j].spec_name:
                continue
            w = w_cache[points[i].spec_name]
            match = layouts[i][:, None] == layouts[j][None, :]
            raw[i, j] = raw[j, i] = float((match * w).sum())
    diag = np.sqrt(np.maximum(np.diag(raw), 1e-12))
    k = raw / np.outer(diag, diag)
    k[raw == 0] = 0.0
    return sigma2 * k


def composite_kernel(points: Sequence[HardwarePoint], target_tops: float,
                     ell: float, sigma2: float, lam: float) -> np.ndarray:
    feats = _sys_features(points)
    d2 = ((feats[:, None, :] - feats[None, :, :]) ** 2).sum(-1)
    k_sys = np.exp(-0.5 * d2 / ell**2)
    same_shape = np.array(
        [[pi.spec_name == pj.spec_name for pj in points] for pi in points],
        dtype=float,
    )
    k_layout = _layout_kernel(points, target_tops, sigma2, lam)
    return k_sys * (1.0 + same_shape * k_layout)


# --------------------------------------------------------------------------
# Gaussian process + EI
# --------------------------------------------------------------------------


@dataclass
class GPModel:
    points: list[HardwarePoint]
    y: np.ndarray
    target_tops: float
    ell: float = 0.7
    sigma2: float = 1.0
    lam: float = 2.0
    noise: float = 1e-4
    _chol: np.ndarray | None = None
    _alpha: np.ndarray | None = None
    _ymean: float = 0.0
    _ystd: float = 1.0

    def fit(self):
        """Marginal-likelihood grid search over (ell, sigma2, lambda)."""
        self._ymean = float(np.mean(self.y))
        self._ystd = float(np.std(self.y)) or 1.0
        yn = (self.y - self._ymean) / self._ystd
        best = None
        for ell in (0.3, 0.7, 1.5):
            for sigma2 in (0.3, 1.0):
                for lam in (1.0, 2.0, 4.0):
                    k = composite_kernel(self.points, self.target_tops,
                                         ell, sigma2, lam)
                    k = k + np.eye(len(k)) * (self.noise + 1e-8)
                    try:
                        chol = np.linalg.cholesky(k)
                    except np.linalg.LinAlgError:
                        continue
                    alpha = np.linalg.solve(
                        chol.T, np.linalg.solve(chol, yn))
                    ll = (-0.5 * yn @ alpha
                          - np.log(np.diag(chol)).sum()
                          - 0.5 * len(yn) * math.log(2 * math.pi))
                    if best is None or ll > best[0]:
                        best = (ll, ell, sigma2, lam, chol, alpha)
        _, self.ell, self.sigma2, self.lam, self._chol, self._alpha = best

    def predict(self, cands: Sequence[HardwarePoint]) -> tuple[np.ndarray, np.ndarray]:
        all_pts = list(self.points) + list(cands)
        k_full = composite_kernel(all_pts, self.target_tops,
                                  self.ell, self.sigma2, self.lam)
        n = len(self.points)
        k_star = k_full[:n, n:]
        k_ss = np.diag(k_full[n:, n:])
        mu = k_star.T @ self._alpha
        v = np.linalg.solve(self._chol, k_star)
        var = np.maximum(k_ss - (v**2).sum(0), 1e-12)
        return (mu * self._ystd + self._ymean, np.sqrt(var) * self._ystd)

    def expected_improvement(self, cands: Sequence[HardwarePoint],
                             xi: float = 0.01) -> np.ndarray:
        mu, sd = self.predict(cands)
        f_best = float(np.min(self.y))
        imp = f_best - mu - xi * abs(f_best)
        z = imp / sd
        phi = np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
        cdf = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
        return imp * cdf + sd * phi


# --------------------------------------------------------------------------
# Two-tier simulated-annealing acquisition maximiser
# --------------------------------------------------------------------------


def _outer_move(rng, p: HardwarePoint, target_tops: float) -> HardwarePoint:
    """Macro perturbation: z_shape or one z_sys dimension; shape change
    triggers layout reallocation."""
    if rng.random() < 0.3:  # shape move
        spec_name = SPEC_NAMES[rng.integers(len(SPEC_NAMES))]
        n = n_chiplets_for_target(target_tops, CHIPLET_LIBRARY[spec_name])
        old = np.asarray(p.layout)
        layout = tuple(int(old[i % len(old)]) for i in range(n))  # tile-remap
        return HardwarePoint(spec_name, p.sys_idx, layout)
    d = int(rng.integers(len(SYS_CANDIDATES)))
    idx = list(p.sys_idx)
    step = 1 if rng.random() < 0.5 else -1
    idx[d] = int(np.clip(idx[d] + step, 0, len(SYS_CANDIDATES[d]) - 1))
    return HardwarePoint(p.spec_name, tuple(idx), p.layout)


def _inner_move(rng, p: HardwarePoint) -> HardwarePoint:
    """Fine layout adjustment: single-slot replacement or dual-slot swap."""
    layout = list(p.layout)
    if rng.random() < 0.5 or len(layout) < 2:
        i = int(rng.integers(len(layout)))
        layout[i] = int(rng.integers(len(DATAFLOWS)))
    else:
        i, j = rng.choice(len(layout), size=2, replace=False)
        layout[i], layout[j] = layout[j], layout[i]
    return HardwarePoint(p.spec_name, p.sys_idx, tuple(layout))


def propose_next(gp: GPModel, rng: np.random.Generator, target_tops: float,
                 seen: set, outer_iters: int = 20, inner_iters: int = 6,
                 restarts: int = 3) -> HardwarePoint:
    best_p, best_ei = None, -np.inf
    for r in range(restarts):
        cur = (gp.points[int(np.argmin(gp.y))] if r == 0
               else random_point(rng, target_tops))
        cur_ei = float(gp.expected_improvement([cur])[0])
        for it in range(outer_iters):
            t = max(1e-3, 1.0 - it / outer_iters)
            cand = _outer_move(rng, cur, target_tops)
            inner = cand
            inner_ei = float(gp.expected_improvement([inner])[0])
            for _ in range(inner_iters):
                nxt = _inner_move(rng, inner)
                ei = float(gp.expected_improvement([nxt])[0])
                if ei > inner_ei or rng.random() < 0.1 * t:
                    inner, inner_ei = nxt, ei
            if inner_ei > cur_ei or rng.random() < 0.2 * t:
                cur, cur_ei = inner, inner_ei
            if cur_ei > best_ei and cur.key() not in seen:
                best_p, best_ei = cur, cur_ei
    return best_p if best_p is not None else random_point(rng, target_tops)


def propose_next_batch(gp: GPModel, rng: np.random.Generator,
                       target_tops: float, seen: set, k: int,
                       outer_iters: int = 20, inner_iters: int = 6,
                       restarts: int = 3) -> list[HardwarePoint]:
    """K candidates for one BO round, proposed against the same (stale) GP
    posterior: each proposal joins a local copy of ``seen`` so the batch is
    duplicate-free — EI is re-maximised with earlier batch members
    excluded, the liar-free variant of batch EI. ``k=1`` draws exactly the
    ``propose_next`` rng sequence, so a batch size of one is bit-identical
    to the serial proposer."""
    local = set(seen)
    out: list[HardwarePoint] = []
    for _ in range(max(int(k), 1)):
        p = propose_next(gp, rng, target_tops, local,
                         outer_iters, inner_iters, restarts)
        local.add(p.key())
        out.append(p)
    return out


@dataclass
class BOResult:
    best_point: HardwarePoint
    best_score: float
    history: list[float] = field(default_factory=list)
    points: list[HardwarePoint] = field(default_factory=list)
    scores: list[float] = field(default_factory=list)


def bo_search(
    objective: Callable[[HardwarePoint], float],
    target_tops: float,
    iters: int = 20,
    init_points: int = 6,
    seed: int = 0,
    batch: int = 1,
    evaluate_batch: "Callable[[list[HardwarePoint]], Sequence[float]] | None"
        = None,
) -> BOResult:
    """Minimise ``objective`` over the hardware space.

    ``batch`` proposes K candidates per GP round (``propose_next_batch``)
    under the SAME total evaluation budget — ``iters`` points are still
    evaluated, in ceil(iters/batch) GP fits, so ``history`` has one entry
    per *round* (plus the init entry). ``evaluate_batch(points) ->
    scores`` prices a whole proposal batch at once when given (compass
    fans the points out across devices); it also prices the init sample.
    ``batch=1`` with no ``evaluate_batch`` is bit-identical to the
    historical serial loop."""
    rng = np.random.default_rng(seed)
    pts: list[HardwarePoint] = []
    seen: set = set()
    while len(pts) < init_points:
        p = random_point(rng, target_tops)
        if p.key() not in seen:
            pts.append(p)
            seen.add(p.key())
    ys = [float(v) for v in evaluate_batch(pts)] if evaluate_batch \
        else [objective(p) for p in pts]
    history = [float(np.min(ys))]

    done = 0
    while done < iters:
        k = min(max(int(batch), 1), iters - done)
        gp = GPModel(list(pts), np.asarray(ys), target_tops)
        gp.fit()
        nxt = propose_next_batch(gp, rng, target_tops, seen, k)
        for p in nxt:
            seen.add(p.key())
            pts.append(p)
        if evaluate_batch:
            ys.extend(float(v) for v in evaluate_batch(nxt))
        else:
            ys.extend(objective(p) for p in nxt)
        history.append(float(np.min(ys)))
        done += k

    best_i = int(np.argmin(ys))
    return BOResult(best_point=pts[best_i], best_score=float(ys[best_i]),
                    history=history, points=pts, scores=[float(v) for v in ys])


def random_hardware_search(
    objective: Callable[[HardwarePoint], float],
    target_tops: float,
    iters: int = 20,
    init_points: int = 6,
    seed: int = 0,
) -> BOResult:
    """Random hardware sampling with the same budget (ablation, Fig. 11)."""
    rng = np.random.default_rng(seed)
    pts = [random_point(rng, target_tops) for _ in range(iters + init_points)]
    ys = [objective(p) for p in pts]
    history = [float(np.min(ys[: i + 1])) for i in range(len(ys))]
    best_i = int(np.argmin(ys))
    return BOResult(best_point=pts[best_i], best_score=float(ys[best_i]),
                    history=history, points=pts, scores=[float(v) for v in ys])
