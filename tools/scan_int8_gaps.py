"""Print how far the port's scanned entry points and int8 cache lie from the
JAX package's, and how far the JAX package's own scanned and unscanned
paths lie from each other, on reduced configs on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/scan_int8_gaps.py

Each line is one JSON object:

* ``jax_scan_vs_unscan``: the JAX package's ``forward_scanned`` /
  ``prefill_scanned`` / ``decode_step_scanned`` (3 greedy steps) against
  ``forward`` / ``prefill`` / ``decode_step``, relative to the largest
  |logit|, per model and impl;
* ``port_vs_jax_decode``: at jamba with 8 layers, the port's unscanned
  ``decode_step`` against the JAX package's (each on its own cache after
  its own ``prefill``), and one port ``decode_step_scanned`` from the JAX
  package's own scanned cache at each step;
* ``order_only``: at jamba with 8 layers, each package against itself
  on one weight set and one token stream: the port's ``prefill`` and 3
  ``decode_step``s under ``impl="kernel"`` (the kernels' plain versions)
  against ``impl="eager"``, and the JAX package's under ``pallas``
  (interpret mode) against ``xla``. The two impls differ only in the
  order of their float32 sums, so these gaps are the size that order
  alone gives at this model;
* ``int8_scales``: after an int8 ``prefill``, the largest relative gap of
  the port's scales to the JAX package's and the largest gap of the int8
  rows, per model.

The tolerances of ``tests/test_torch_stacked.py`` and
``tests/test_torch_int8_cache.py`` rest on these numbers.
"""
from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import all_archs as j_archs
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_model as j_init_model
from repro.models import prefill as j_prefill
from repro.models.stacked import stack_cache as j_stack_cache
from repro.models.stacked import stack_params as j_stack_params
from repro.models.stacked import unstack_cache as j_unstack_cache
from repro.models.transformer import decode_step_scanned as j_decode_scanned
from repro.models.transformer import forward_scanned as j_forward_scanned
from repro.models.transformer import prefill_scanned as j_prefill_scanned
from repro_torch import configs as t_configs
from repro_torch import models as t_models
from repro_torch.core.interop import cache_from_jax, params_from_jax

CPU = "cpu"
IMPLS = (("eager", "xla"), ("kernel", "pallas"))


def _configs(name):
    """(JAX cfg, port cfg): a reduced config, ``@8`` for 8 layers,
    ``@kv64`` for MLA at kv_rank 64."""
    arch, _, variant = name.partition("@")
    j_cfg, cfg = j_archs()[arch].reduced(), t_configs.get(arch).reduced()
    if variant == "8":
        j_cfg = dataclasses.replace(j_cfg, n_layers=8)
        cfg = dataclasses.replace(cfg, n_layers=8)
    elif variant == "kv64":
        j_cfg = dataclasses.replace(j_cfg, mla_kv_rank=64)
        cfg = dataclasses.replace(cfg, mla_kv_rank=64)
    return j_cfg, cfg


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_scan_vs_unscan(name: str, j_impl: str) -> dict:
    j_cfg, _ = _configs(name)
    full = "xla" if j_cfg.attn_kind == "mla" else j_impl
    params = j_init_model(jax.random.PRNGKey(0), j_cfg)
    sp = j_stack_params(params, j_cfg)
    toks = jnp.asarray(np.random.default_rng(6).integers(
        0, j_cfg.vocab, size=(2, 10)))
    gaps = {"forward": _rel(
        j_forward_scanned(sp, j_cfg, toks, impl=full, remat=False),
        j_forward(params, j_cfg, toks, impl=full))}
    cache = j_init_cache(j_cfg, 2, 16, dtype=jnp.float32)
    slots = j_stack_cache(j_init_cache(j_cfg, 2, 16, dtype=jnp.float32),
                          j_cfg)
    logits, cache = j_prefill(params, j_cfg, toks, cache, impl=full)
    s_logits, slots = j_prefill_scanned(sp, j_cfg, toks, slots, impl=full)
    gaps["prefill"] = _rel(s_logits, logits)
    for step in range(3):
        tok = jnp.argmax(logits, -1)
        logits, cache = j_decode(params, j_cfg, tok, cache, impl=j_impl)
        s_logits, slots = j_decode_scanned(sp, j_cfg, tok, slots,
                                           impl=j_impl)
        gaps[f"decode_{step}"] = _rel(s_logits, logits)
    return {"record": "jax_scan_vs_unscan", "model": name, "impl": j_impl,
            **gaps}


def port_vs_jax_decode(name: str, impl: str, j_impl: str) -> dict:
    j_cfg, cfg = _configs(name)
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0),
                                                 j_cfg))
    j_params = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, CPU)
    j_sp, sp = j_stack_params(j_params, j_cfg), t_models.stack_params(
        params, cfg)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 10))
    j_cache = j_init_cache(j_cfg, 2, 16, dtype=jnp.float32)
    j_slots = j_stack_cache(j_init_cache(j_cfg, 2, 16, dtype=jnp.float32),
                            j_cfg)
    cache = t_models.init_cache(cfg, 2, 16, torch.float32, CPU)
    j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks),
                                  j_cache, impl=j_impl)
    j_s_logits, j_slots = j_prefill_scanned(j_sp, j_cfg, jnp.asarray(toks),
                                            j_slots, impl=j_impl)
    logits, cache = t_models.prefill(params, cfg, torch.as_tensor(toks),
                                     cache, impl=impl, device=CPU)
    unscanned, from_jax_cache = [], []
    for _ in range(3):
        tok = np.array(jnp.argmax(j_s_logits, -1))
        slots = t_models.stack_cache(cache_from_jax(jax.tree.map(
            np.asarray, j_unstack_cache(j_slots, j_cfg)), CPU), cfg)
        s_logits, _ = t_models.decode_step_scanned(
            sp, cfg, torch.as_tensor(tok), slots, impl=impl, device=CPU)
        j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok),
                                     j_cache, impl=j_impl)
        j_s_logits, j_slots = j_decode_scanned(j_sp, j_cfg, jnp.asarray(tok),
                                               j_slots, impl=j_impl)
        logits, cache = t_models.decode_step(params, cfg,
                                             torch.as_tensor(tok), cache,
                                             impl=impl, device=CPU)
        unscanned.append(_rel(logits.numpy(), j_logits))
        from_jax_cache.append(_rel(s_logits.numpy(), j_s_logits))
    return {"record": "port_vs_jax_decode", "model": name, "impl": impl,
            "unscanned_decode_vs_jax": unscanned,
            "scanned_step_from_jax_scanned_cache": from_jax_cache}


def order_only(name: str) -> dict:
    j_cfg, cfg = _configs(name)
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0),
                                                 j_cfg))
    j_params = jax.tree.map(jnp.asarray, tree)
    params = params_from_jax(tree, cfg, CPU)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 10))
    out = {}
    for label, (a, b) in (("port_kernel_vs_eager", IMPLS[1]),
                          ("jax_pallas_vs_xla", IMPLS[0])):
        runs = {}
        for impl in (("kernel", "eager") if label.startswith("port")
                     else ("pallas", "xla")):
            if label.startswith("port"):
                cache = t_models.init_cache(cfg, 2, 16, torch.float32, CPU)
                logits, cache = t_models.prefill(
                    params, cfg, torch.as_tensor(toks), cache, impl=impl,
                    device=CPU)
                steps = [logits.numpy()]
            else:
                cache = j_init_cache(j_cfg, 2, 16, dtype=jnp.float32)
                logits, cache = j_prefill(j_params, j_cfg, jnp.asarray(toks),
                                          cache, impl=impl)
                steps = [np.asarray(logits)]
            runs[impl] = [steps, cache]
        ref = runs["eager" if label.startswith("port") else "xla"]
        feed = []
        for _ in range(3):
            feed.append(np.argmax(ref[0][-1], -1))
            for impl, (steps, cache) in runs.items():
                if label.startswith("port"):
                    logits, cache = t_models.decode_step(
                        params, cfg, torch.as_tensor(feed[-1]), cache,
                        impl=impl, device=CPU)
                    steps.append(logits.numpy())
                else:
                    logits, cache = j_decode(j_params, j_cfg,
                                             jnp.asarray(feed[-1]), cache,
                                             impl=impl)
                    steps.append(np.asarray(logits))
                runs[impl][1] = cache
        (a_steps, _), (b_steps, _) = runs.values()
        out[label] = [_rel(x, y) for x, y in zip(a_steps, b_steps)]
    return {"record": "order_only", "model": name,
            "steps": ["prefill", "decode_0", "decode_1", "decode_2"], **out}


def int8_scales(name: str) -> dict:
    j_cfg, cfg = _configs(name)
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0),
                                                 j_cfg))
    params = params_from_jax(tree, cfg, CPU)
    toks = np.random.default_rng(len(name)).integers(0, cfg.vocab,
                                                     size=(2, 12))
    _, j_cache = j_prefill(jax.tree.map(jnp.asarray, tree), j_cfg,
                           jnp.asarray(toks),
                           j_init_cache(j_cfg, 2, 32, dtype=jnp.int8))
    _, cache = t_models.prefill(
        params, cfg, torch.as_tensor(toks),
        t_models.init_cache(cfg, 2, 32, torch.int8, CPU), impl="eager",
        device=CPU)
    scale_rel, row_gap = 0.0, 0
    for tc, jc in zip(cache, j_cache):
        for key, t in tc.items():
            want = np.asarray(jc[key])
            if key.endswith("_scale"):
                got = t.numpy().astype(np.float64)
                nz = want > 0
                scale_rel = max(scale_rel, float(np.max(
                    np.abs(got[nz] - want[nz]) / want[nz])))
            elif t.dtype == torch.int8:
                row_gap = max(row_gap, int(np.abs(
                    t.numpy().astype(np.int32) - want.astype(np.int32))
                    .max()))
    return {"record": "int8_scales", "model": name,
            "max_rel_scale_gap": scale_rel, "max_int8_row_gap": row_gap}


def main() -> None:
    os.environ.pop("REPRO_CACHE_QUANT", None)
    for name in ("deepseek-v2-236b", "jamba-v0.1-52b", "jamba-v0.1-52b@8",
                 "mamba2-2.7b"):
        for _, j_impl in IMPLS:
            print(json.dumps(jax_scan_vs_unscan(name, j_impl)), flush=True)
    for impl, j_impl in IMPLS:
        print(json.dumps(port_vs_jax_decode("jamba-v0.1-52b@8", impl,
                                            j_impl)), flush=True)
    print(json.dumps(order_only("jamba-v0.1-52b@8")), flush=True)
    for name in ("llama3.2-3b", "deepseek-v2-236b", "deepseek-v2-236b@kv64",
                 "jamba-v0.1-52b"):
        print(json.dumps(int8_scales(name)), flush=True)


if __name__ == "__main__":
    main()
