"""The port's serving paths in mixed and reduced precision against the JAX
package on identical weights (``params_from_jax``) and inputs, at the
reduced configs: the five dense configs of ``tests/test_torch_models.py``
and the MoE-free attention + Mamba-2 hybrid of
``tests/test_torch_mamba.py``.

* **float32 weights, bfloat16 KV cache** — what the JAX package's
  ``init_cache`` defaults to. ``prefill``, ``decode_step`` with an
  ``active`` mask, a padded ``extend`` and an all-active ``decode_step``
  give logits within 1e-4 of the largest JAX logit, under both impl pairs
  (``eager``/``xla`` and ``kernel``/``pallas``), each step from the JAX
  package's cache carried across. The new cache entries are held to one
  bfloat16 rounding step (2^-7 of the entry) of JAX's, plus the float32
  difference before the rounding (1e-5 of the largest), and a Mamba
  layer's float32 state to 1e-4 of the largest. Why step by step: a
  float32 difference of ~1e-7 between the packages flips the bfloat16
  rounding of an entry that lies on a rounding boundary, and a later step
  reads it. Free-running, up to 8 such entries out of thousands put later
  logits up to 3.2e-4 of the largest apart (the hybrid under
  ``eager``/``xla``; reduced qwen2-1.5b under ``kernel``/``pallas``:
  2.0e-4); from the JAX cache every step stays within 1.6e-5
  (``tools/mixed_precision_gaps.py`` prints these gaps).
  ``ServingEngine(cache_dtype=bfloat16)`` gives the JAX engine's greedy
  tokens under vllm, orca and chunked_prefill, free-running.
* **bfloat16 weights**, over a bfloat16 cache or over a float32 one (the
  engines' default cache type) — the same paths within 2e-2 of the
  largest JAX value (the tolerance of ``tests/test_kernels.py`` in
  bfloat16), for the five dense configs and the reduced mamba2-2.7b: the
  two packages round the activations at different places. The hybrid is
  not among them: there the JAX package's own two paths (``xla`` and
  ``pallas``) end 5.5e-2 of the largest logit apart after prefill (the
  same tool), so no implementation can be within 2e-2 of both.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs as j_archs  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.transformer import extend as j_extend  # noqa: E402
from repro.serving import SCHEDULERS as J_SCHEDULERS  # noqa: E402
from repro.serving import ServeRequest as JServeRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.core.interop import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import SCHEDULERS, ServeRequest  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

DENSE = ("llama3.2-3b", "qwen1.5-0.5b", "qwen2-1.5b", "gpt3-7b",
         "llama3-70b")
MIXED_ARCHS = DENSE + ("hybrid",)
BF16_ARCHS = DENSE + ("mamba2-2.7b",)
IMPLS = (("eager", "xla"), ("kernel", "pallas"))
MIXED_REL = 1e-4         # float32 weights, bfloat16 cache: of the largest
BF16_REL = 2e-2          # bfloat16 weights and cache: of the largest
BF16_STEP = 2.0 ** -7    # one bfloat16 rounding step, relative
F32_REL = 1e-5           # float32 sums in another order: of the largest
CPU = "cpu"


def _configs(arch):
    """(JAX cfg, port cfg): a reduced config from both registries, or the
    hybrid as jamba's reduced config without MoE."""
    if arch != "hybrid":
        return j_archs()[arch].reduced(), t_configs.get(arch).reduced()
    j_cfg = dataclasses.replace(j_archs()["jamba-v0.1-52b"].reduced(),
                                moe=None)
    return j_cfg, t_models.ModelConfig(**dataclasses.asdict(j_cfg))


@functools.cache
def _model(arch, weights):
    """(JAX cfg, JAX params, port cfg, port params) with ``weights`` of
    "float32" or "bfloat16". A Mamba layer's ``a_log`` and ``dt_bias``
    (float32 in both packages) get seeded per-head values in place of the
    JAX package's zeros, so a per-head error shows."""
    j_cfg, cfg = _configs(arch)
    j_dtype = getattr(jnp, weights)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        j_init_model(jax.random.PRNGKey(0), j_cfg, j_dtype))
    rng = np.random.default_rng(0)
    for blk in tree["blocks"]:
        if "mamba" in blk:
            h = blk["mamba"]["a_log"].shape[0]
            blk["mamba"]["a_log"] = rng.normal(0.0, 0.5, h).astype(np.float32)
            blk["mamba"]["dt_bias"] = rng.normal(-1.0, 0.5,
                                                 h).astype(np.float32)
    # the bfloat16 leaves are exact in float32 and go back exactly
    j_params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(a, jnp.float32 if _is_decay(path)
                                    else j_dtype), tree)
    params = params_from_jax(tree, cfg, CPU, dtype=getattr(torch, weights))
    return j_cfg, j_params, cfg, params


def _is_decay(path) -> bool:
    return getattr(path[-1], "key", None) in ("a_log", "dt_bias")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _close(got, want, what, rel):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= rel * np.abs(want).max(), \
        (what, err, np.abs(want).max())


def _caches_close(t_cache, j_cache, what, rel, kv_step):
    """K/V entries within ``rel`` of the largest (``kv_step=None``) or, for
    float32 K/V rounded into a bfloat16 cache, within one rounding step
    (``kv_step`` of the entry) plus the float32 difference before the
    rounding (F32_REL of the largest: an entry near 0 is a small
    difference of large terms); a Mamba state within ``rel`` of the
    largest; lengths equal."""
    for i, (tc, jc) in enumerate(zip(t_cache, j_cache)):
        assert set(tc) == set(jc), (what, i, set(tc), set(jc))
        for key in sorted(set(tc) - {"len"}):
            if key == "state" or kv_step is None:
                _close(tc[key], jc[key], f"{what} layer {i} {key}", rel)
                continue
            assert tc[key].dtype == torch.bfloat16, (what, i, key)
            got, want = _np(tc[key]), _np(jc[key])
            err = np.abs(got - want)
            bound = kv_step * np.abs(want) + F32_REL * np.abs(want).max()
            assert (err <= bound).all(), (what, i, key, err.max())
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))


def _run_paths(arch, impl, j_impl, weights, rel, kv_step, carry,
               cache_dtype="bfloat16"):
    """prefill -> decode_step (second slot inactive) -> padded extend ->
    decode_step (all active), each held to JAX. With ``carry`` every step
    after prefill starts from the JAX package's cache carried across
    (``cache_from_jax``), so each step is held to JAX on its own."""
    j_cfg, j_params, cfg, params = _model(arch, weights)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, size=(2, 12))
    ops.clear_dispatch_stats()

    def check(what, logits, j_logits, cache, j_cache):
        _close(logits, j_logits, f"{what} logits", rel)
        _caches_close(cache, j_cache, what, rel, kv_step)
        if carry:
            return cache_from_jax(jax.tree.map(np.asarray, j_cache), CPU)
        return cache

    j_cache = j_init_cache(j_cfg, 2, 32, dtype=getattr(jnp, cache_dtype))
    cache = t_models.init_cache(cfg, 2, 32, dtype=getattr(torch, cache_dtype),
                                device=CPU)
    j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache,
                                  impl=j_impl)
    logits, cache = t_models.prefill(params, cfg, torch.as_tensor(toks), cache,
                                     impl=impl, device=CPU)
    cache = check("prefill", logits, j_logits, cache, j_cache)

    active = np.array([True, False])
    tok = np.array(jnp.argmax(j_logits, -1))
    j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok), j_cache,
                                 impl=j_impl, active=jnp.asarray(active))
    logits, cache = t_models.decode_step(
        params, cfg, torch.as_tensor(tok), cache, impl=impl,
        active=torch.as_tensor(active), device=CPU)
    cache = check("decode", logits, j_logits, cache, j_cache)

    more = np.concatenate([rng.integers(0, cfg.vocab, size=(2, 5)),
                           np.zeros((2, 3), np.int64)], axis=1)
    j_logits, j_cache = j_extend(j_params, j_cfg, jnp.asarray(more), j_cache,
                                 impl=j_impl, length=jnp.asarray(5))
    logits, cache = t_models.extend(params, cfg, torch.as_tensor(more), cache,
                                    impl=impl, length=5, device=CPU)
    cache = check("extend", logits, j_logits, cache, j_cache)

    tok = np.array(jnp.argmax(j_logits, -1))
    j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok), j_cache,
                                 impl=j_impl)
    logits, cache = t_models.decode_step(params, cfg, torch.as_tensor(tok),
                                         cache, impl=impl, device=CPU)
    check("decode (all active)", logits, j_logits, cache, j_cache)
    assert logits.dtype == getattr(torch, weights)

    paths = set(ops.dispatch_stats())
    if impl == "kernel":
        kinds = {cfg.mixer_kind(i) for i in range(cfg.n_layers)}
        want = {"flash_attention:plain", "decode_attention:plain"} \
            if "attn" in kinds else set()
        assert paths == want | ({"ssd_scan:plain"} if "mamba" in kinds
                                else set())
    else:
        assert paths == set()


@pytest.mark.parametrize("impl,j_impl", IMPLS)
@pytest.mark.parametrize("arch", MIXED_ARCHS)
def test_bf16_cache_paths_match_jax(arch, impl, j_impl):
    """float32 weights with a bfloat16 cache, step by step."""
    _run_paths(arch, impl, j_impl, "float32", MIXED_REL, BF16_STEP,
               carry=True)


@pytest.mark.parametrize("cache", ["bfloat16", "float32"])
@pytest.mark.parametrize("impl,j_impl", IMPLS)
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_model_paths_match_jax(arch, impl, j_impl, cache):
    """bfloat16 weights over a bfloat16 cache or over a float32 one (the
    engines' default cache type), each package from its own caches."""
    _run_paths(arch, impl, j_impl, "bfloat16", BF16_REL, None, carry=False,
               cache_dtype=cache)


def _specs(seed, n, max_new):
    """(prompt, max_new, arrival iteration) per request, as in
    ``tests/test_torch_serving.py``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, size=int(rng.integers(5, 30))).tolist(),
             max_new, i // 2) for i in range(n)]


def _scheduler(table, name):
    return table[name](chunk=8) if name == "chunked_prefill" \
        else table[name]()


@functools.cache
def _jax_engine_tokens(sched):
    j_cfg, j_params, _, _ = _model("qwen1.5-0.5b", "float32")
    reqs = [JServeRequest(i, list(p), m, arrived_iter=a)
            for i, (p, m, a) in enumerate(_specs(0, 6, 5))]
    res = JServingEngine(j_params, j_cfg, max_batch=3, max_len=64,
                         cache_dtype=jnp.bfloat16).run(
        reqs, _scheduler(J_SCHEDULERS, sched))
    return {r.rid: r.generated for r in res.finished}


@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("sched", ["vllm", "orca", "chunked_prefill"])
def test_bf16_cache_engine_matches_jax_engine(sched, impl):
    """float32 weights, ``cache_dtype=bfloat16`` in both engines: the same
    greedy tokens for every request."""
    _, _, cfg, params = _model("qwen1.5-0.5b", "float32")
    reqs = [ServeRequest(i, list(p), m, arrived_iter=a)
            for i, (p, m, a) in enumerate(_specs(0, 6, 5))]
    eng = ServingEngine(params, cfg, max_batch=3, max_len=64, impl=impl,
                        cache_dtype=torch.bfloat16, device=CPU)
    assert all(layer["k"].dtype == torch.bfloat16 for layer in eng.cache)
    res = eng.run(reqs, _scheduler(SCHEDULERS, sched))
    assert not res.truncated and len(res.finished) == 6
    assert {r.rid: r.generated for r in res.finished} == \
        _jax_engine_tokens(sched)
