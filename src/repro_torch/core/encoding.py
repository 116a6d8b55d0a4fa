"""Mapping encoding scheme (paper §IV).

A mapping of an execution graph with ``rows`` micro-batches and ``M`` layer
columns onto ``C`` chiplets is the triple:

* ``micro_batch_size`` — carried by the workload/hardware level (changing it
  re-fuses the graph, so the GA treats it as fixed; the BO engine searches it
  as a ``z_sys`` parameter — paper §V-A);
* ``segmentation`` — binary vector of length M-1; bit i = segment boundary
  after column i;
* ``layer_to_chip`` — (rows x M) integer matrix, entry = chiplet id.

The *scheduling order* is Algorithm 2's loop nest: segments outermost (layer
dim), micro-batches next, layers within the segment innermost. All-zeros
segmentation => row-wise (layer-first); all-ones => column-wise
(micro-batch-first); data/model/pipeline parallelism are the Algorithm-1
special cases below.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np


@dataclass
class MappingEncoding:
    segmentation: np.ndarray   # (M-1,) uint8
    layer_to_chip: np.ndarray  # (rows, M) int32

    def __post_init__(self):
        self.segmentation = np.asarray(self.segmentation, dtype=np.uint8)
        self.layer_to_chip = np.asarray(self.layer_to_chip, dtype=np.int32)
        rows, m = self.layer_to_chip.shape
        assert self.segmentation.shape == (max(m - 1, 0),), (
            f"segmentation {self.segmentation.shape} vs M={m}")

    @property
    def rows(self) -> int:
        return self.layer_to_chip.shape[0]

    @property
    def n_cols(self) -> int:
        return self.layer_to_chip.shape[1]

    def validate(self, n_chiplets: int) -> bool:
        """Deprecated bool form of the encoding contract check.

        Use ``repro_torch.analysis.verify_encoding`` (structured diagnostics —
        rule ids, loci, severities) or ``repro_torch.analysis.is_legal`` on its
        result; the bool form made every caller swallow *why* an encoding
        was illegal."""
        warnings.warn(
            "MappingEncoding.validate(n_chiplets) is deprecated; use "
            "repro_torch.analysis.verify_encoding(enc, n_chiplets) for "
            "structured diagnostics (is_legal(...) for the bool verdict)",
            DeprecationWarning, stacklevel=2)
        from ..analysis.diagnostics import is_legal
        from ..analysis.mapping import verify_encoding
        return is_legal(verify_encoding(self, n_chiplets))

    def copy(self) -> "MappingEncoding":
        return MappingEncoding(self.segmentation.copy(), self.layer_to_chip.copy())

    def segments(self) -> list[tuple[int, int]]:
        """Column intervals [lo, hi) induced by the segmentation bits."""
        bounds = [0] + [i + 1 for i in range(len(self.segmentation))
                        if self.segmentation[i]] + [self.n_cols]
        return [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)
                if bounds[i] < bounds[i + 1]]

    def scheduled_order(self) -> np.ndarray:
        """Flat op order: (segment, micro_batch, layer-within-segment).

        Returns an array of shape (rows * M, 2) of (row, col) pairs.
        """
        order = []
        for lo, hi in self.segments():
            for b in range(self.rows):
                for l in range(lo, hi):
                    order.append((b, l))
        return np.asarray(order, dtype=np.int32)


# --------------------------------------------------------------------------
# Stacked populations (array-of-structs -> struct-of-arrays boundary)
# --------------------------------------------------------------------------


@dataclass
class StackedPopulation:
    """A GA population as stacked arrays: (P, M-1) segmentation matrix and
    (P, rows, M) layer_to_chip tensor. ``MappingEncoding`` remains the
    single-individual boundary API; this is the population-batched carrier
    the vectorised GA operators and the JAX evaluators exchange."""

    segmentation: np.ndarray   # (P, M-1) uint8
    layer_to_chip: np.ndarray  # (P, rows, M) int32

    def __post_init__(self):
        self.segmentation = np.asarray(self.segmentation, dtype=np.uint8)
        self.layer_to_chip = np.asarray(self.layer_to_chip, dtype=np.int32)

    def __len__(self) -> int:
        return self.layer_to_chip.shape[0]

    @property
    def rows(self) -> int:
        return self.layer_to_chip.shape[1]

    @property
    def n_cols(self) -> int:
        return self.layer_to_chip.shape[2]

    @staticmethod
    def from_encodings(pop: "list[MappingEncoding]") -> "StackedPopulation":
        return StackedPopulation(
            np.stack([e.segmentation for e in pop]),
            np.stack([e.layer_to_chip for e in pop]))

    def to_encodings(self) -> "list[MappingEncoding]":
        return [MappingEncoding(self.segmentation[i], self.layer_to_chip[i])
                for i in range(len(self))]

    def individual(self, i: int) -> MappingEncoding:
        return MappingEncoding(self.segmentation[i].copy(),
                               self.layer_to_chip[i].copy())

    def top_k(self, scores, k: int) -> "StackedPopulation":
        """The k best individuals under ``scores`` (lower = better) as a
        new population — the elite carrier between co-search rounds."""
        order = np.argsort(np.asarray(scores, dtype=float))[: max(int(k), 0)]
        return StackedPopulation(self.segmentation[order].copy(),
                                 self.layer_to_chip[order].copy())


def as_stacked(population) -> StackedPopulation:
    if isinstance(population, StackedPopulation):
        return population
    return StackedPopulation.from_encodings(list(population))


# --------------------------------------------------------------------------
# Population-level scheduled orders (vectorised Algorithm 2 loop nest)
# --------------------------------------------------------------------------


def scheduled_orders(segmentations: np.ndarray, rows: int,
                     m_cols: int) -> np.ndarray:
    """``MappingEncoding.scheduled_order`` for a whole population at once.

    The scheduling order (segment, micro_batch, layer-within-segment) is the
    lexicographic sort of ops by key (seg_id[l], b, l), where seg_id is the
    prefix-sum of segmentation bits — one argsort over the (P, rows*M) key
    matrix replaces the per-individual triple Python loop.

    segmentations: (P, M-1) 0/1 array -> (P, rows*M, 2) int32 (row, col).
    """
    seg = np.asarray(segmentations)
    if seg.ndim == 1:
        seg = seg[None, :]
    p = seg.shape[0]
    seg_id = np.zeros((p, m_cols), dtype=np.int64)
    if m_cols > 1:
        np.cumsum(seg[:, : m_cols - 1], axis=1, out=seg_id[:, 1:])
    b_ids = np.arange(rows, dtype=np.int64)[None, :, None]
    l_ids = np.arange(m_cols, dtype=np.int64)[None, None, :]
    key = (seg_id[:, None, :] * rows + b_ids) * m_cols + l_ids
    idx = np.argsort(key.reshape(p, rows * m_cols), axis=1)
    b, l = np.divmod(idx, m_cols)
    return np.stack([b, l], axis=-1).astype(np.int32)


class ScheduledOrderCache:
    """Per-individual memoisation of scheduled orders keyed on the
    segmentation bits: across GA generations most individuals keep their
    segmentation (elites, children without a seg mutation), so their (T, 2)
    order tensors are reused and only the changed rows are re-derived (in
    one vectorised ``scheduled_orders`` call)."""

    def __init__(self, rows: int, m_cols: int, capacity: int = 8192):
        self.rows, self.m_cols = rows, m_cols
        self.capacity = capacity
        self._cache: dict[bytes, np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    def orders(self, segmentations: np.ndarray) -> np.ndarray:
        seg = np.ascontiguousarray(np.asarray(segmentations, dtype=np.uint8))
        p = seg.shape[0]
        out = np.empty((p, self.rows * self.m_cols, 2), dtype=np.int32)
        missing: list[int] = []
        keys = [seg[i].tobytes() for i in range(p)]
        for i, kb in enumerate(keys):
            hit = self._cache.get(kb)
            if hit is None:
                missing.append(i)
            else:
                out[i] = hit
                self.hits += 1
        if missing:
            self.misses += len(missing)
            fresh = scheduled_orders(seg[missing], self.rows, self.m_cols)
            if len(self._cache) + len(missing) > self.capacity:
                self._cache.clear()
            for j, i in enumerate(missing):
                out[i] = fresh[j]
                self._cache[keys[i]] = fresh[j]
        return out


# --------------------------------------------------------------------------
# Algorithm 1 — common parallelism paradigms as encodings
# --------------------------------------------------------------------------


def data_parallel(rows: int, m_cols: int, n_chiplets: int) -> MappingEncoding:
    """Each micro-batch row executes all layers on one chiplet."""
    seg = np.zeros(max(m_cols - 1, 0), dtype=np.uint8)
    l2c = np.zeros((rows, m_cols), dtype=np.int32)
    for b in range(rows):
        l2c[b, :] = b % n_chiplets
    return MappingEncoding(seg, l2c)


def model_parallel(rows: int, m_cols: int, n_chiplets: int) -> MappingEncoding:
    """All rows fused conceptually; layers round-robin across chiplets.

    (Paper's Algorithm 1 uses micro_batch_size = B so the graph has one row;
    with more rows we replicate the same column->chip map on every row.)
    """
    seg = np.zeros(max(m_cols - 1, 0), dtype=np.uint8)
    l2c = np.zeros((rows, m_cols), dtype=np.int32)
    for l in range(m_cols):
        l2c[:, l] = l % n_chiplets
    return MappingEncoding(seg, l2c)


def pipeline_parallel(rows: int, m_cols: int, n_chiplets: int) -> MappingEncoding:
    """Fixed layer->chiplet assignment, segment boundary every C layers,
    micro-batches stream through like a pipeline."""
    seg = np.zeros(max(m_cols - 1, 0), dtype=np.uint8)
    for i in range(m_cols - 1):
        if (i + 1) % n_chiplets == 0:
            seg[i] = 1
    l2c = np.zeros((rows, m_cols), dtype=np.int32)
    for l in range(m_cols):
        l2c[:, l] = l % n_chiplets
    return MappingEncoding(seg, l2c)


def random_encoding(rng: np.random.Generator, rows: int, m_cols: int,
                    n_chiplets: int, p_seg: float = 0.2) -> MappingEncoding:
    seg = (rng.random(max(m_cols - 1, 0)) < p_seg).astype(np.uint8)
    l2c = rng.integers(0, n_chiplets, size=(rows, m_cols), dtype=np.int32)
    return MappingEncoding(seg, l2c)
