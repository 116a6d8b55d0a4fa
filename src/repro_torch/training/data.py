"""Deterministic, resumable synthetic token pipeline, a copy of the JAX
package's ``training/data.py``.

Every batch is a pure function of (seed, step) via counter-based PRNG
(numpy's Philox, so the same bytes as the reference's) — the iterator
state is a single integer, so checkpoint/restart resumes the exact stream
with no skipped or repeated batches. The data is synthesised from the
seed: nothing is downloaded.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenStream:
    """state = step counter; next(stream) -> (tokens [B, L+1] int32)."""

    def __init__(self, cfg: DataConfig, step: int = 0):
        self.cfg = cfg
        self.step = step

    def state(self) -> int:
        return self.step

    def restore(self, step: int):
        self.step = step

    def _synthesise(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.Generator(np.random.Philox(key=cfg.seed, counter=step))
        # zipf-ish marginal over the vocab so the loss curve is non-trivial
        z = rng.zipf(1.3, size=(cfg.global_batch, cfg.seq_len + 1))
        return np.minimum(z - 1, cfg.vocab - 1).astype(np.int32)

    def __next__(self):
        batch = self._synthesise(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self


def shard_batch(batch: np.ndarray, device) -> torch.Tensor:
    """A host batch placed as the mesh places tokens
    (:func:`repro_torch.dist.sharding.token_sharding`): the port's launcher
    runs on the (1, 1) mesh (ROADMAP R6 a), whose placement is the whole
    batch on its one ``device``."""
    return torch.as_tensor(batch, device=device)
