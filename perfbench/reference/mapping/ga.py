"""The mapping search's genetic algorithm in plain numpy (paper §V-A): the
initial population, tournament selection, crossover and the Table III
mutations, each drawing from one ``numpy.random.Generator`` in the order
the search defines, so that a seed fixes every population.

``replay`` follows a finished search one generation at a time from the
populations and fitness the search reported: each step the reference
makes from generation g is held against the search's generation g + 1,
and the search's answer against the best of its last generation."""
from __future__ import annotations

import numpy as np

# impact class per Table III operator: 0 layer, 1 subgraph, 2 graph level
OP_IMPACT = (0, 0, 0, 1, 1, 2, 2)


def segments(seg_bits: np.ndarray, n_cols: int) -> list[tuple[int, int]]:
    """Column intervals [lo, hi) cut by the segmentation bits."""
    bounds = [0] + [i + 1 for i in range(len(seg_bits)) if seg_bits[i]] + [n_cols]
    return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)
            if bounds[i] < bounds[i + 1]]


def initial_population(rng, rows: int, n_cols: int, n_chips: int, size: int):
    """Algorithm 1's pipeline- and model-parallel mappings, then random
    ones (a boundary after each column with probability 0.2)."""
    seg = np.zeros((size, max(n_cols - 1, 0)), dtype=np.uint8)
    l2c = np.zeros((size, rows, n_cols), dtype=np.int32)
    cols = np.arange(n_cols) % n_chips
    for i in range(min(2, size)):
        l2c[i] = cols[None, :]
    if size > 0:
        # pipeline parallel: a segment boundary every n_chips columns
        seg[0] = ((np.arange(n_cols - 1) + 1) % n_chips == 0).astype(np.uint8)
    for i in range(2, size):
        seg[i] = (rng.random(max(n_cols - 1, 0)) < 0.2).astype(np.uint8)
        l2c[i] = rng.integers(0, n_chips, size=(rows, n_cols), dtype=np.int32)
    return seg, l2c


def _distinct(rng, n: int, k: int, size: int) -> np.ndarray:
    """(size, k) draws from [0, n), distinct within each row."""
    k = min(k, n)
    return np.argpartition(rng.random((size, n)), k - 1, axis=1)[:, :k]


def tournament(rng, fitness: np.ndarray, k: int, n: int) -> np.ndarray:
    """Winners (lowest fitness) of n tournaments of k distinct entrants."""
    cand = _distinct(rng, len(fitness), k, n)
    return cand[np.arange(n), np.argmin(fitness[cand], axis=1)]


def crossover(rng, seg_a, l2c_a, seg_b, l2c_b):
    """Each segmentation bit from either parent; each (row, segment) slice
    of the child's own segments whole from either parent."""
    n, m_sub = seg_a.shape
    _, rows, n_cols = l2c_a.shape
    if m_sub:
        take_a = rng.integers(0, 2, size=(n, m_sub)).astype(bool)
        seg = np.where(take_a, seg_a, seg_b).astype(np.uint8)
    else:
        seg = seg_a.copy()
    seg_id = np.zeros((n, n_cols), dtype=np.int64)
    if n_cols > 1:
        seg_id[:, 1:] = np.cumsum(seg[:, : n_cols - 1], axis=1)
    from_a = rng.random((n, rows, n_cols)) < 0.5
    pick = from_a[np.arange(n)[:, None, None], np.arange(rows)[None, :, None],
                  seg_id[:, None, :]]
    return seg, np.where(pick, l2c_a, l2c_b).astype(np.int32)


def op_weights(progress: float) -> np.ndarray:
    """Operator probabilities: graph-level early, layer-level late."""
    class_w = np.array([0.2 + 0.6 * progress, 0.3, max(0.05, 0.5 - 0.5 * progress)])
    w = np.array([class_w[c] for c in OP_IMPACT])
    return w / w.sum()


def _pick_subgraph(rng, seg_bits, rows, n_cols):
    segs = segments(seg_bits, n_cols)
    lo, hi = segs[rng.integers(len(segs))]
    return rng.integers(rows), lo, hi


def mutate(rng, seg, l2c, n_chips: int, progress: float, rate: float) -> None:
    """Table III's seven operators on ``l2c`` and a bit flip or swap of
    neighbours on ``seg`` (probability 0.3), in place; each individual
    mutates with probability ``rate``."""
    p, rows, n_cols = l2c.shape
    do = rng.random(p) < rate
    ops = rng.choice(len(OP_IMPACT), size=p, p=op_weights(progress))

    idx = np.nonzero(do & (ops == 0))[0]        # one entry to a random chip
    if idx.size:
        b = rng.integers(rows, size=idx.size)
        col = rng.integers(n_cols, size=idx.size)
        l2c[idx, b, col] = rng.integers(n_chips, size=idx.size)
    idx = np.nonzero(do & (ops == 1))[0]        # swap neighbouring columns
    if idx.size and n_cols >= 2:
        b = rng.integers(rows, size=idx.size)
        col = rng.integers(n_cols - 1, size=idx.size)
        a = l2c[idx, b, col]
        l2c[idx, b, col] = l2c[idx, b, col + 1]
        l2c[idx, b, col + 1] = a
    idx = np.nonzero(do & (ops == 2))[0]        # swap neighbouring rows
    if idx.size and rows >= 2:
        b = rng.integers(rows - 1, size=idx.size)
        col = rng.integers(n_cols, size=idx.size)
        a = l2c[idx, b, col]
        l2c[idx, b, col] = l2c[idx, b + 1, col]
        l2c[idx, b + 1, col] = a
    idx = np.nonzero(do & (ops == 6))[0]        # swap two whole rows
    if idx.size and rows >= 2:
        pair = _distinct(rng, rows, 2, idx.size)
        i, j = pair[:, 0], pair[:, 1]
        a = l2c[idx, i].copy()
        l2c[idx, i] = l2c[idx, j]
        l2c[idx, j] = a
    for i in np.nonzero(do & np.isin(ops, (3, 4, 5)))[0]:
        if ops[i] == 3:                          # permute one subgraph
            b, lo, hi = _pick_subgraph(rng, seg[i], rows, n_cols)
            l2c[i, b, lo:hi] = rng.permutation(l2c[i, b, lo:hi])
        elif ops[i] == 4:                        # redraw one subgraph
            b, lo, hi = _pick_subgraph(rng, seg[i], rows, n_cols)
            l2c[i, b, lo:hi] = rng.integers(n_chips, size=hi - lo)
        else:                                    # swap two segments' columns
            segs = segments(seg[i], n_cols)
            if len(segs) < 2:
                continue
            a, c = rng.choice(len(segs), size=2, replace=False)
            (lo1, hi1), (lo2, hi2) = segs[a], segs[c]
            w = min(hi1 - lo1, hi2 - lo2)
            t = l2c[i, :, lo1:lo1 + w].copy()
            l2c[i, :, lo1:lo1 + w] = l2c[i, :, lo2:lo2 + w]
            l2c[i, :, lo2:lo2 + w] = t
    if n_cols > 1:
        idx = np.nonzero(do & (rng.random(p) < 0.3))[0]
        if idx.size:
            flip = rng.random(idx.size) < 0.5
            fi = idx[flip]
            if fi.size:
                pos = rng.integers(n_cols - 1, size=fi.size)
                seg[fi, pos] ^= 1
            si = idx[~flip]
            if si.size and n_cols >= 3:
                pos = rng.integers(n_cols - 2, size=si.size)
                a = seg[si, pos]
                seg[si, pos] = seg[si, pos + 1]
                seg[si, pos + 1] = a


def step(rng, seg, l2c, fitness, gen: int, ga: dict, n_chips: int):
    """Generation ``gen``'s successor: the elite kept, the rest children of
    two tournaments, crossed over and mutated."""
    progress = gen / max(ga["generations"] - 1, 1)
    elite = np.argsort(fitness)[: ga["elite"]]
    n_child = max(0, len(fitness) - ga["elite"])
    p1 = tournament(rng, fitness, ga["tournament_k"], n_child)
    p2 = tournament(rng, fitness, ga["tournament_k"], n_child)
    c_seg, c_l2c = crossover(rng, seg[p1], l2c[p1], seg[p2], l2c[p2])
    do_cx = rng.random(n_child) < ga["crossover_rate"]
    c_seg = np.where(do_cx[:, None], c_seg, seg[p1])
    c_l2c = np.where(do_cx[:, None, None], c_l2c, l2c[p1])
    c_seg = np.ascontiguousarray(c_seg, dtype=np.uint8)
    c_l2c = np.ascontiguousarray(c_l2c, dtype=np.int32)
    mutate(rng, c_seg, c_l2c, n_chips, progress, ga["mutation_rate"])
    return (np.concatenate([seg[elite], c_seg]),
            np.concatenate([l2c[elite], c_l2c]))


def _differing(a, b) -> int:
    """Individuals of population ``a`` that differ from ``b``'s."""
    (sa, la), (sb, lb) = a, b
    if sa.shape != sb.shape or la.shape != lb.shape:
        return max(len(la), len(lb))
    same = (sa == sb).all(axis=1) & (la == lb).reshape(len(la), -1).all(axis=1)
    return int((~same).sum())


def replay(seed: int, ga: dict, n_chips: int, pops, fitness) -> tuple[int, tuple]:
    """Follow one search: ``pops`` are its populations in the order it had
    them evaluated, (segmentation, layer_to_chip) each, and ``fitness``
    their fitness. Returns how many individuals differ from the reference's
    (the initial population and each step), and the reference's best
    mapping of the last generation."""
    rng = np.random.default_rng(seed)
    _, rows, n_cols = pops[0][1].shape
    bad = _differing(initial_population(rng, rows, n_cols, n_chips, ga["population"]),
                     pops[0])
    if len(pops) != ga["generations"] + 1:
        bad += ga["population"] * abs(ga["generations"] + 1 - len(pops))
    for g in range(min(len(pops) - 1, ga["generations"])):
        nxt = step(rng, pops[g][0], pops[g][1], fitness[g], g, ga, n_chips)
        bad += _differing(nxt, pops[g + 1])
    last = int(np.argmin(fitness[-1]))
    return bad, (pops[-1][0][last], pops[-1][1][last])


# the search's objectives over (batches, population) latency and energy:
# the fitness the GA ranks a population by, and the score of a mapping's
# totals over every batch
FITNESS = {"edp": lambda lat, en: (lat * en).mean(axis=0),
           "latency": lambda lat, en: lat.mean(axis=0),
           "energy": lambda lat, en: en.mean(axis=0)}
SCORE = {"edp": lambda lat, en: lat * en,
         "latency": lambda lat, en: lat,
         "energy": lambda lat, en: en}
