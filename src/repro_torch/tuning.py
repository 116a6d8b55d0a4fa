"""Environment knobs of the port: the readers of the JAX package's
``tuning.py`` that the port reads, with the same variable names and the
same defaults, so one environment sets both packages alike.

REPRO_CACHE_QUANT   = 0 | 1           (int8 KV / latent cache)
REPRO_MOE_CAP       = 1.25            (MoE expert capacity factor)

What reads them:

* ``cache_quant``: ``models.attention.cache_dtype``, through which
  ``init_attn_cache`` makes an int8 cache with per-(token, head) scales,
  whatever dtype was asked for, and the serving loops refuse one;
* ``moe_capacity_factor``: ``models.moe.apply_moe`` and ``route`` when no
  capacity factor is passed.

The reference's other readers come with the code that reads them: its
training knobs (``REPRO_TRAIN_MICROBATCH``, ``REPRO_GRAD_ACCUM``,
``REPRO_TRAIN_COMPRESS``) with the port's training loop, and
``REPRO_CACHE_SHARD`` with its distributed package. ``REPRO_CACHE_UPDATE``
has no counterpart: the port writes a decode row in place by index
(``models.attention._scatter_cache``), which for finite values equals both
the reference's one-hot ``blend`` and its ``scatter``.
"""
from __future__ import annotations

import os


def cache_quant() -> bool:
    """int8 KV / latent cache with per-(token, head) scales
    (REPRO_CACHE_QUANT=1)."""
    return os.environ.get("REPRO_CACHE_QUANT", "0") == "1"


def moe_capacity_factor() -> float:
    return float(os.environ.get("REPRO_MOE_CAP", "1.25"))
