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

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/scan_int8_gaps.py --float64

prints instead the float64 reading of ROADMAP F5 (~2 minutes), for jamba
with 8 layers (``@8``: the reduced config, attention every 4th layer) and
for jamba's own pattern (``@pattern``: the narrow config of
``tests/test_torch_jamba.py``, attention at layer 4 of 8, P 128, N 16, 16
experts top 2, seeded decay). Both packages are copied into a temporary
directory with every float32 of their models and kernels read as float64
(nothing of ``src/`` changes), and each reading runs in a process of its
own on one weight set:

* ``float64_reading``: per token seed, impl and path (``forward``,
  ``prefill``, 3 ``decode_step``s fed fixed tokens), relative to the
  largest float64 |logit|: the port against the JAX package in float32,
  each against its own float64 copy, and the two float64 copies against
  each other;
* ``block_rounding``: each block of the float64 ``forward`` trajectory
  run in float32 by each package on that block's float64 input (cast),
  its distance from the float64 block output, of the block's largest
  update;
* ``aligned_ssd``: the port's float32 ``forward`` / ``prefill`` gap to
  the JAX package's (eager / xla) with the port's chunked SSD replaced in
  every Mamba layer by the JAX package's ``_ssd_xla`` on the same inputs
  (the chunked sums then identical), beside the gap without, and each
  Mamba layer's smallest row rms at the gated RMSNorm's input.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile

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
from repro_torch.models.transformer import MoECfg

CPU = "cpu"
IMPLS = (("eager", "xla"), ("kernel", "pallas"))


# jamba's own pattern, narrow (tests/test_torch_jamba.py's NARROW)
PATTERN = dict(name="jamba-v0.1-52b-narrow", vocab=256, d_model=64,
               n_layers=8, n_heads=4, n_kv_heads=1, head_dim=128, d_ff=96,
               moe_every=2, attn_every=8, d_inner=256, ssm_state=16,
               mamba_heads=2, max_seq=256)
PATTERN_MOE = dict(n_routed=16, n_shared=0, top_k=2, d_expert=32)


def _configs(name):
    """(JAX cfg, port cfg): a reduced config, ``@8`` for 8 layers,
    ``@kv64`` for MLA at kv_rank 64, ``@pattern`` for the narrow config
    with jamba's own layer pattern."""
    arch, _, variant = name.partition("@")
    if variant == "pattern":
        from repro.models.transformer import MoECfg as JMoECfg
        return (dataclasses.replace(j_archs()[arch].model,
                                    moe=JMoECfg(**PATTERN_MOE), **PATTERN),
                dataclasses.replace(t_configs.get(arch).model,
                                    moe=MoECfg(**PATTERN_MOE), **PATTERN))
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


# --------------------------------------------------------------------------
# the float64 reading (ROADMAP F5)
# --------------------------------------------------------------------------

F64_MODELS = ("jamba-v0.1-52b@8", "jamba-v0.1-52b@pattern")
F64_SEEDS = (8, 1, 2, 3, 4)
PATHS = ("forward", "prefill", "decode_0", "decode_1", "decode_2")


def _float64_copy(root: str) -> str:
    """Both packages copied under ``root``, every float32 of their models
    and kernels read as float64; returns the copy's ``src``."""
    src = os.path.join(root, "src")
    here = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    subs = {"repro_torch": (("torch.float32", "torch.float64"),
                            (".float()", ".double()"),
                            ("np.float32", "np.float64")),
            "repro": (("jnp.float32", "jnp.float64"),
                      ("np.float32", "np.float64"))}
    for pkg, pairs in subs.items():
        shutil.copytree(os.path.join(here, pkg), os.path.join(src, pkg))
        for dirpath, _, names in os.walk(os.path.join(src, pkg)):
            if pkg == "repro" and not dirpath.endswith(("models", "kernels")):
                continue
            for n in names:
                if n.endswith(".py"):
                    path = os.path.join(dirpath, n)
                    with open(path) as f:
                        text = f.read()
                    for a, b in pairs:
                        text = text.replace(a, b)
                    with open(path, "w") as f:
                        f.write(text)
    return src


def _weights(name: str, path: str) -> None:
    """The JAX initialiser's float32 weights of ``name`` (its Mamba decay
    seeded for ``@pattern``, as tests/test_torch_jamba.py does), saved in
    ``jax.tree.leaves`` order."""
    j_cfg, _ = _configs(name)
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(0),
                                                 j_cfg))
    if name.endswith("@pattern"):
        rng = np.random.default_rng(0)
        for blk in tree["blocks"]:
            if "mamba" in blk:
                h = blk["mamba"]["a_log"].shape[0]
                blk["mamba"]["a_log"] = (0.5 * rng.standard_normal(h)
                                         ).astype(np.float32)
                blk["mamba"]["dt_bias"] = (0.5 * rng.standard_normal(h)
                                           - 1.0).astype(np.float32)
    np.savez(path, *jax.tree.leaves(tree))


def _loaded(name: str, path: str, bits: int):
    """(JAX cfg, JAX params, port cfg, port params) from the saved
    weights, in float32 or float64."""
    j_cfg, cfg = _configs(name)
    tdef = jax.tree.structure(j_init_model(jax.random.PRNGKey(0), j_cfg))
    w = np.load(path)
    fdt = np.float64 if bits == 64 else np.float32
    tree = jax.tree.unflatten(tdef, [w[f"arr_{i}"].astype(fdt)
                                     for i in range(tdef.num_leaves)])
    params = params_from_jax(tree, cfg, CPU, dtype=torch.float64
                             if bits == 64 else torch.float32)
    return j_cfg, jax.tree.map(jnp.asarray, tree), cfg, params


def _reading(name: str, weights: str, bits: int, out: str) -> None:
    """One process's logits of every path, impl and seed (``float64_
    reading``) and, in float64, the forward trajectory's block inputs and
    outputs (``block_rounding``), saved to ``out``."""
    from repro_torch.models import transformer as t_tr

    j_cfg, j_params, cfg, params = _loaded(name, weights, bits)
    fdt = torch.float64 if bits == 64 else torch.float32
    jdt = jnp.float64 if bits == 64 else jnp.float32
    res = {}
    for seed in F64_SEEDS:
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab, size=(2, 13))
        feed = rng.integers(0, cfg.vocab, size=(3, 2))
        for impl, j_impl in IMPLS:
            key = f"{seed}/{impl}"
            res[f"port/{key}/forward"] = t_models.forward(
                params, cfg, torch.as_tensor(toks), impl=impl,
                device=CPU).double().numpy()
            res[f"jax/{key}/forward"] = np.asarray(j_forward(
                j_params, j_cfg, jnp.asarray(toks), impl=j_impl), np.float64)
            cache = t_models.init_cache(cfg, 2, 32, fdt, CPU)
            j_cache = j_init_cache(j_cfg, 2, 32, dtype=jdt)
            logits, cache = t_models.prefill(params, cfg, torch.as_tensor(
                toks), cache, impl=impl, device=CPU)
            j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks),
                                          j_cache, impl=j_impl)
            res[f"port/{key}/prefill"] = logits.double().numpy()
            res[f"jax/{key}/prefill"] = np.asarray(j_logits, np.float64)
            for step in range(3):
                logits, cache = t_models.decode_step(
                    params, cfg, torch.as_tensor(feed[step]), cache,
                    impl=impl, device=CPU)
                j_logits, j_cache = j_decode(j_params, j_cfg,
                                             jnp.asarray(feed[step]), j_cache,
                                             impl=j_impl)
                res[f"port/{key}/decode_{step}"] = logits.double().numpy()
                res[f"jax/{key}/decode_{step}"] = np.asarray(j_logits,
                                                             np.float64)
    if bits == 64:
        toks = np.random.default_rng(F64_SEEDS[0]).integers(
            0, cfg.vocab, size=(2, 13))
        x = params.embed.e[torch.as_tensor(toks)]
        rope = t_tr._rope(cfg, cfg.max_seq, CPU)
        pos = torch.arange(toks.shape[1]).expand(*toks.shape)
        for i, blk in enumerate(params.blocks):
            y = t_tr._block_train(blk, cfg, i, x, pos, rope, True, "eager")
            res[f"block/{i}/in"], res[f"block/{i}/out"] = x.numpy(), y.numpy()
            x = y
    np.savez(out, **res)


def _block_rounding(name: str, weights: str, f64: dict) -> dict:
    """Each block in float32, per package, on the float64 trajectory's
    input: its distance from the float64 block, of the block's update."""
    from repro.models import transformer as j_tr
    from repro.models.layers import rope_freqs as j_rope
    from repro_torch.models import transformer as t_tr

    j_cfg, j_params, cfg, params = _loaded(name, weights, 32)
    b, l = f64["block/0/in"].shape[:2]
    rope, j_rope_t = t_tr._rope(cfg, cfg.max_seq, CPU), j_rope(
        cfg.head_dim, cfg.max_seq, cfg.rope_theta)
    pos = torch.arange(l).expand(b, l)
    j_pos = jnp.broadcast_to(jnp.arange(l), (b, l))
    port, ref = [], []
    for i, (blk, j_blk) in enumerate(zip(params.blocks, j_params["blocks"])):
        x64, y64 = f64[f"block/{i}/in"], f64[f"block/{i}/out"]
        x32 = x64.astype(np.float32)
        upd = np.abs(y64 - x64).max()
        got = t_tr._block_train(blk, cfg, i, torch.as_tensor(x32), pos, rope,
                                True, "eager").numpy()
        want = j_tr._block_train(j_blk, j_cfg, i, jnp.asarray(x32), j_pos,
                                 j_rope_t, True, "xla")
        port.append(float(np.abs(got - y64).max() / upd))
        ref.append(float(np.abs(np.asarray(want, np.float64) - y64).max()
                         / upd))
    return {"record": "block_rounding", "model": name,
            "kinds": [f"{cfg.mixer_kind(i)}+{cfg.ffn_kind(i)}"
                      for i in range(cfg.n_layers)],
            "port_of_update": port, "jax_of_update": ref}


def _aligned_ssd(name: str, weights: str) -> list:
    """The port's float32 forward / prefill against the JAX package's
    (eager / xla), its chunked SSD as it is and replaced in every Mamba
    layer by the JAX package's ``_ssd_xla``; and each Mamba layer's
    smallest row rms at the gated RMSNorm's input (seed 8's forward)."""
    import torch.nn.functional as F

    from repro.models.mamba2 import _ssd_xla
    from repro_torch.models import mamba2

    j_cfg, j_params, cfg, params = _loaded(name, weights, 32)
    own, gate_out = mamba2.ssd_chunked, mamba2._gate_out
    rms = []

    def jax_sums(x, dt, a, b_mat, c_mat, init, chunk=128):
        y, s = _ssd_xla(*(jnp.asarray(t.float().numpy()) for t in
                          (x, dt, a, b_mat, c_mat, init)), chunk)
        return torch.as_tensor(np.array(y)), torch.as_tensor(np.array(s))

    def spied(p, y, z, x, cfg):
        g = y.reshape(*y.shape[:2], cfg.d_inner) * F.silu(z)
        rms.append(float(g.pow(2).mean(-1).sqrt().min()))
        return gate_out(p, y, z, x, cfg)

    out = []
    for seed in F64_SEEDS:
        toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                    size=(2, 13))
        want = j_forward(j_params, j_cfg, jnp.asarray(toks), impl="xla")
        j_logits, _ = j_prefill(j_params, j_cfg, jnp.asarray(toks),
                                j_init_cache(j_cfg, 2, 32,
                                             dtype=jnp.float32), impl="xla")
        rec = {"record": "aligned_ssd", "model": name, "seed": seed}
        for label, fn in (("own_sums", own), ("jax_sums", jax_sums)):
            mamba2.ssd_chunked = fn
            if seed == F64_SEEDS[0] and label == "own_sums":
                mamba2._gate_out = spied
            try:
                got = t_models.forward(params, cfg, torch.as_tensor(toks),
                                       impl="eager", device=CPU)
                logits, _ = t_models.prefill(
                    params, cfg, torch.as_tensor(toks),
                    t_models.init_cache(cfg, 2, 32, torch.float32, CPU),
                    impl="eager", device=CPU)
            finally:
                mamba2.ssd_chunked, mamba2._gate_out = own, gate_out
            rec[label] = {"forward": _rel(got.numpy(), want),
                          "prefill": _rel(logits.numpy(), j_logits)}
        if seed == F64_SEEDS[0]:
            rec["gated_rms_smallest_per_mamba_layer"] = rms[
                :cfg.n_layers - sum(cfg.mixer_kind(i) == "attn"
                                    for i in range(cfg.n_layers))]
        out.append(rec)
    return out


def float64_main() -> None:
    root = tempfile.mkdtemp(prefix="f5_float64_")
    try:
        f64_src = _float64_copy(root)
        here = os.path.abspath(__file__)
        for name in F64_MODELS:
            weights = os.path.join(root, "weights.npz")
            _weights(name, weights)
            runs = {}
            for bits, src in ((32, os.environ.get("PYTHONPATH", "src")),
                              (64, f64_src)):
                out = os.path.join(root, f"r{bits}.npz")
                env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
                           JAX_ENABLE_X64="1" if bits == 64 else "0")
                subprocess.run([sys.executable, here, "--reading", name,
                                weights, str(bits), out], env=env,
                               check=True)
                runs[bits] = dict(np.load(out))
            r32, r64 = runs[32], runs[64]
            for seed in F64_SEEDS:
                for impl, _ in IMPLS:
                    rec = {"record": "float64_reading", "model": name,
                           "seed": seed, "impl": impl}
                    for path in PATHS:
                        key = f"{seed}/{impl}/{path}"
                        t32, j32 = r32[f"port/{key}"], r32[f"jax/{key}"]
                        t64, j64 = r64[f"port/{key}"], r64[f"jax/{key}"]
                        top = np.abs(j64).max()
                        rec[path] = {
                            "port_vs_jax": float(np.abs(t32 - j32).max() / top),
                            "port_vs_f64": float(np.abs(t32 - t64).max() / top),
                            "jax_vs_f64": float(np.abs(j32 - j64).max() / top),
                            "f64_port_vs_jax": float(np.abs(t64 - j64).max()
                                                     / top)}
                    print(json.dumps(rec), flush=True)
            print(json.dumps(_block_rounding(name, weights, r64)), flush=True)
            for rec in _aligned_ssd(name, weights):
                print(json.dumps(rec), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> None:
    os.environ.pop("REPRO_CACHE_QUANT", None)
    if sys.argv[1:2] == ["--reading"]:
        name, weights, bits, out = sys.argv[2:6]
        _reading(name, weights, int(bits), out)
        return
    if sys.argv[1:2] == ["--float64"]:
        float64_main()
        return
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
