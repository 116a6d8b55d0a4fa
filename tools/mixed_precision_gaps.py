#!/usr/bin/env python3
"""How far the port's reduced-precision serving paths land from the JAX
package on the CPU, beyond the pass/fail bounds of
``tests/test_torch_mixed_precision.py`` (whose models and helpers it reuses).

Prints one JSON line per case:

* float32 weights over a bfloat16 cache, per config and impl pair: the
  largest logit gap (of the largest JAX logit) over prefill, decode_step
  with ``active``, padded extend and decode_step, once free-running (each
  package from its own caches) and once step by step (each step from the
  JAX package's cache), and the number of cache entries whose bfloat16
  value differs between the packages at the end of the free run;
* bfloat16 weights and cache for the hybrid: the prefill logit gaps
  between the JAX package's own ``xla`` and ``pallas`` paths and between
  each port impl and its JAX partner.

Run from the repository root:  PYTHONPATH=src python tools/mixed_precision_gaps.py
"""
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import test_torch_mixed_precision as T  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

CPU = "cpu"


def _gap(got, want) -> float:
    got, want = T._np(got), T._np(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _steps(arch, impl, j_impl, carry):
    """The four steps of the test; returns (largest logit gap, entries of
    the final K/V caches that differ)."""
    j_cfg, j_params, cfg, params = T._model(arch, "float32")
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, size=(2, 12))
    more = None
    j_cache = T.j_init_cache(j_cfg, 2, 32, dtype=jnp.bfloat16)
    cache = T.t_models.init_cache(cfg, 2, 32, dtype=torch.bfloat16,
                                  device=CPU)
    gaps = []
    for step in ("prefill", "decode", "extend", "decode_all"):
        if step == "prefill":
            j_out = T.j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache,
                                impl=j_impl)
            out = T.t_models.prefill(params, cfg, torch.as_tensor(toks),
                                     cache, impl=impl, device=CPU)
        elif step == "extend":
            more = np.concatenate([rng.integers(0, cfg.vocab, size=(2, 5)),
                                   np.zeros((2, 3), np.int64)], axis=1)
            j_out = T.j_extend(j_params, j_cfg, jnp.asarray(more), j_cache,
                               impl=j_impl, length=jnp.asarray(5))
            out = T.t_models.extend(params, cfg, torch.as_tensor(more),
                                    cache, impl=impl, length=5, device=CPU)
        else:
            active = np.array([True, False]) if step == "decode" else None
            tok = np.array(jnp.argmax(j_logits, -1))
            j_out = T.j_decode(
                j_params, j_cfg, jnp.asarray(tok), j_cache, impl=j_impl,
                active=None if active is None else jnp.asarray(active))
            out = T.t_models.decode_step(
                params, cfg, torch.as_tensor(tok), cache, impl=impl,
                active=None if active is None else torch.as_tensor(active),
                device=CPU)
        (j_logits, j_cache), (logits, cache) = j_out, out
        gaps.append(_gap(logits, j_logits))
        if carry:
            cache = T.cache_from_jax(jax.tree.map(np.asarray, j_cache), CPU)
    differ = sum(int((T._np(c[k]) != T._np(jc[k])).sum())
                 for c, jc in zip(cache, j_cache) for k in ("k", "v")
                 if k in c)
    return max(gaps), differ


def main() -> int:
    for arch in T.MIXED_ARCHS:
        for impl, j_impl in T.IMPLS:
            free, differ = _steps(arch, impl, j_impl, carry=False)
            carried, _ = _steps(arch, impl, j_impl, carry=True)
            print(json.dumps({"weights": "float32", "cache": "bfloat16",
                              "arch": arch, "impl": f"{impl}/{j_impl}",
                              "free_running_gap": free,
                              "step_by_step_gap": carried,
                              "cache_entries_differing": differ}),
                  flush=True)
    j_cfg, j_params, cfg, params = T._model("hybrid", "bfloat16")
    toks = np.random.default_rng(len("hybrid")).integers(0, cfg.vocab,
                                                         size=(2, 12))
    out = {}
    for impl, j_impl in T.IMPLS:
        j_cache = T.j_init_cache(j_cfg, 2, 32, dtype=jnp.bfloat16)
        cache = T.t_models.init_cache(cfg, 2, 32, dtype=torch.bfloat16,
                                      device=CPU)
        out[j_impl] = T.j_prefill(j_params, j_cfg, jnp.asarray(toks),
                                  j_cache, impl=j_impl)[0]
        out[impl] = T.t_models.prefill(params, cfg, torch.as_tensor(toks),
                                       cache, impl=impl, device=CPU)[0]
    print(json.dumps({"weights": "bfloat16", "cache": "bfloat16",
                      "arch": "hybrid", "step": "prefill",
                      "xla_vs_pallas": _gap(out["pallas"], out["xla"]),
                      "eager_vs_xla": _gap(out["eager"], out["xla"]),
                      "kernel_vs_pallas": _gap(out["kernel"],
                                               out["pallas"])}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
