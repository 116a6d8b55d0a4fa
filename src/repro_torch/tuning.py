"""Environment knobs of the port: the readers of the JAX package's
``tuning.py`` that the port reads, with the same variable names and the
same defaults, so one environment sets both packages alike.

REPRO_CACHE_QUANT      = 0 | 1        (int8 KV / latent cache)
REPRO_MOE_CAP          = 1.25         (MoE expert capacity factor)
REPRO_TRAIN_MICROBATCH = 8            (microbatches of a dry-run train step)
REPRO_GRAD_ACCUM       = float32 | bfloat16 (their gradient sum's type)
REPRO_TRAIN_COMPRESS   = 0 | 1        (int8 gradient compression with error
                                       feedback in a dry-run train step)

What reads them:

* ``cache_quant``: ``models.attention.cache_dtype``, through which
  ``init_attn_cache`` makes an int8 cache with per-(token, head) scales,
  whatever dtype was asked for, and the serving loops refuse one;
* ``moe_capacity_factor``: ``models.moe.apply_moe`` and ``route`` when no
  capacity factor is passed;
* ``train_microbatches``, ``grad_accum_dtype`` and ``train_compress``:
  ``launch.dryrun``'s train step, as in the reference (whose training loop
  reads none of them either).

``REPRO_CACHE_SHARD`` has no reader: the reference defines it, but no code
of the JAX package reads it (its sharding rules do not import ``tuning``).
``REPRO_CACHE_UPDATE`` has no counterpart: the port writes a decode row in
place by index (``models.attention._scatter_cache``), which for finite
values equals both the reference's one-hot ``blend`` and its ``scatter``.
"""
from __future__ import annotations

import os


def cache_quant() -> bool:
    """int8 KV / latent cache with per-(token, head) scales
    (REPRO_CACHE_QUANT=1)."""
    return os.environ.get("REPRO_CACHE_QUANT", "0") == "1"


def moe_capacity_factor() -> float:
    return float(os.environ.get("REPRO_MOE_CAP", "1.25"))


def train_compress() -> bool:
    return os.environ.get("REPRO_TRAIN_COMPRESS", "0") == "1"


def grad_accum_dtype() -> str:
    return os.environ.get("REPRO_GRAD_ACCUM", "float32")


def train_microbatches() -> int:
    return int(os.environ.get("REPRO_TRAIN_MICROBATCH", "8"))
