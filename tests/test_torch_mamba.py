"""The port's Mamba-2 and hybrid model stacks against the JAX package on
identical weights (``params_from_jax``) and inputs, at reduced configs.

Two models: ``mamba2-2.7b``'s ``reduced()`` (2 Mamba layers, no FFN) and
a hybrid, ``jamba-v0.1-52b``'s ``reduced()`` without its MoE FFNs on both
sides (4 layers, attention at index 2, dense gated FFNs, untied head);
and jamba as published (MoE FFNs on the odd layers) through the same
checks.
The JAX package initialises ``a_log`` and ``dt_bias`` to zeros, which
gives every head the same decay; the tree both sides use overwrites them
with seeded values, so a per-head error shows. ``forward``, ``prefill``,
``decode_step`` with an ``active`` mask, a padded ``extend`` and an
all-active ``decode_step`` give logits and caches (``state``, ``k``,
``v``, ``len``) within 1e-5 of the largest reference value:
``impl="eager"`` against JAX ``impl="xla"``, and ``impl="kernel"`` (the
kernels' plain versions on the CPU) against JAX ``impl="pallas"``
(interpret mode). The only differences are float32 sums taken in another
order.
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
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.transformer import extend as j_extend  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.core.interop import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

MODELS = ("mamba2-2.7b", "hybrid")
IMPLS = (("eager", "xla"), ("kernel", "pallas"))
REL = 1e-5
CPU = "cpu"


def _configs(name):
    """(JAX cfg, port cfg) of a reduced model: mamba2-2.7b and jamba (as
    published, with MoE) from both registries, the hybrid as jamba's
    reduced config without MoE."""
    if name in ("mamba2-2.7b", "jamba"):
        arch = "jamba-v0.1-52b" if name == "jamba" else name
        return j_archs()[arch].reduced(), t_configs.get(arch).reduced()
    j_cfg = dataclasses.replace(j_archs()["jamba-v0.1-52b"].reduced(),
                                moe=None)
    return j_cfg, t_models.ModelConfig(**dataclasses.asdict(j_cfg))


def _seeded_decay(tree, seed=0):
    """Per-head ``a_log`` and ``dt_bias`` from numpy ``seed`` in place of
    the JAX package's zeros (a numpy tree, changed in place)."""
    rng = np.random.default_rng(seed)
    for blk in tree["blocks"]:
        if "mamba" in blk:
            h = blk["mamba"]["a_log"].shape[0]
            blk["mamba"]["a_log"] = rng.normal(0.0, 0.5, h).astype(np.float32)
            blk["mamba"]["dt_bias"] = rng.normal(-1.0, 0.5,
                                                 h).astype(np.float32)
    return tree


@functools.cache
def _model(name):
    """(JAX cfg, JAX params, port cfg, port params), built once per model."""
    j_cfg, cfg = _configs(name)
    tree = _seeded_decay(jax.tree.map(
        np.asarray, j_init_model(jax.random.PRNGKey(0), j_cfg)))
    j_params = jax.tree.map(jnp.asarray, tree)
    return j_cfg, j_params, cfg, params_from_jax(tree, cfg, CPU)


def _close(got, want, what, rel=REL):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _caches_close(t_cache, j_cache, what):
    for i, (tc, jc) in enumerate(zip(t_cache, j_cache)):
        assert set(tc) == set(jc), (what, i, set(tc), set(jc))
        for key in sorted(set(tc) - {"len"}):
            _close(tc[key], jc[key], f"{what} layer {i} {key}")
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_reduced_configs():
    j_cfg, cfg = _configs("mamba2-2.7b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    _, hybrid = _configs("hybrid")
    assert [hybrid.mixer_kind(i) for i in range(hybrid.n_layers)] == \
        ["mamba", "mamba", "attn", "mamba"]
    full = t_configs.get("mamba2-2.7b").model
    assert (full.d_model, full.n_layers, full.d_inner, full.ssm_state,
            full.mamba_heads, full.vocab) == (2560, 64, 5120, 128, 80, 50280)


@pytest.mark.parametrize("impl,j_impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_serving_paths_match_jax(name, impl, j_impl):
    _check_serving_paths(name, impl, j_impl)


def _check_serving_paths(name, impl, j_impl):
    j_cfg, j_params, cfg, params = _model(name)
    rng = np.random.default_rng(len(name))
    toks = rng.integers(0, cfg.vocab, size=(2, 12))
    ops.clear_dispatch_stats()

    want = j_forward(j_params, j_cfg, jnp.asarray(toks), impl=j_impl)
    got = t_models.forward(params, cfg, torch.as_tensor(toks), impl=impl,
                           device=CPU)
    _close(got, want, "forward logits")

    j_cache = j_init_cache(j_cfg, 2, 32, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 2, 32, dtype=torch.float32, device=CPU)
    _caches_close(cache, j_cache, "init")
    j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache,
                                  impl=j_impl)
    logits, cache = t_models.prefill(params, cfg, torch.as_tensor(toks), cache,
                                     impl=impl, device=CPU)
    _close(logits, j_logits, "prefill logits")
    _caches_close(cache, j_cache, "prefill")

    # one decode step with the second slot inactive (left untouched)
    active = np.array([True, False])
    tok = np.array(jnp.argmax(j_logits, -1))
    j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok), j_cache,
                                 impl=j_impl, active=jnp.asarray(active))
    logits, cache = t_models.decode_step(
        params, cfg, torch.as_tensor(tok), cache, impl=impl,
        active=torch.as_tensor(active), device=CPU)
    _close(logits, j_logits, "decode logits")
    _caches_close(cache, j_cache, "decode")
    assert cache[0]["len"].tolist() == [13, 12]

    # a right-padded chunk: 5 true tokens in a bucket of 8
    more = np.concatenate([rng.integers(0, cfg.vocab, size=(2, 5)),
                           np.zeros((2, 3), np.int64)], axis=1)
    j_logits, j_cache = j_extend(j_params, j_cfg, jnp.asarray(more), j_cache,
                                 impl=j_impl, length=jnp.asarray(5))
    logits, cache = t_models.extend(params, cfg, torch.as_tensor(more), cache,
                                    impl=impl, length=5, device=CPU)
    _close(logits, j_logits, "extend logits")
    _caches_close(cache, j_cache, "extend")

    # decode with every slot active
    tok = np.array(jnp.argmax(j_logits, -1))
    j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok), j_cache,
                                 impl=j_impl)
    logits, cache = t_models.decode_step(params, cfg, torch.as_tensor(tok),
                                         cache, impl=impl, device=CPU)
    _close(logits, j_logits, "decode logits (all active)")
    _caches_close(cache, j_cache, "decode (all active)")

    paths = ops.dispatch_stats()
    n_mamba = sum(1 for i in range(cfg.n_layers)
                  if cfg.mixer_kind(i) == "mamba")
    n_attn = cfg.n_layers - n_mamba
    if impl == "kernel":
        # forward and prefill reach the SSD kernel once per Mamba layer;
        # extend and decode never do
        want_paths = {"ssd_scan:plain": 2 * n_mamba}
        if n_attn:
            want_paths.update({"flash_attention:plain": 2 * n_attn,
                               "decode_attention:plain": 2 * n_attn})
        assert paths == want_paths
    else:
        assert paths == {}


def test_mamba_state_is_float32_and_rope_is_not_built():
    """A Mamba layer's state is float32 whatever the attention cache's
    type, and a model without attention builds no RoPE tables (mamba2's
    max_seq of 2^20 would make 1M-row tables)."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import rope_freqs

    _, _, cfg, _ = _model("hybrid")
    cache = t_models.init_cache(cfg, 2, 16, dtype=torch.bfloat16, device=CPU)
    assert cache[0]["state"].dtype == torch.float32
    assert cache[2]["k"].dtype == torch.bfloat16
    full = t_configs.get("mamba2-2.7b").model
    assert transformer._rope(full, full.max_seq, torch.device(CPU)) is None
    assert transformer._rope(cfg, 64, torch.device(CPU)) is not None
    before = rope_freqs.cache_info().misses
    _, _, m_cfg, m_params = _model("mamba2-2.7b")
    t_models.forward(m_params, m_cfg, torch.zeros((1, 3), dtype=torch.int64),
                     device=CPU)
    assert rope_freqs.cache_info().misses == before


def test_cache_round_trip_from_jax():
    """A JAX hybrid cache (Mamba states and K/V) carried across continues
    exactly like the port's own."""
    j_cfg, j_params, cfg, params = _model("hybrid")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 7))
    j_cache = j_init_cache(j_cfg, 2, 16, dtype=jnp.float32)
    _, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache)
    cache = cache_from_jax(jax.tree.map(np.asarray, j_cache), CPU)
    assert set(cache[0]) == {"state", "len"} and \
        set(cache[2]) == {"k", "v", "len"}
    tok = np.array([3, 4])
    j_logits, j_next = j_decode(j_params, j_cfg, jnp.asarray(tok), j_cache)
    logits, nxt = t_models.decode_step(params, cfg, torch.as_tensor(tok),
                                       cache, impl="eager", device=CPU)
    _close(logits, j_logits, "decode from a carried cache")
    _caches_close(nxt, j_next, "decode from a carried cache")


def test_params_from_jax_checks_a_mamba_tree():
    """Every JAX leaf path names a port parameter of the same shape: an
    extra leaf, a missing one and a wrong shape are refused."""
    j_cfg, j_params, cfg, _ = _model("hybrid")
    names = dict(_model("hybrid")[3].named_parameters())
    assert tuple(names["blocks.0.mamba.in_proj.w"].shape) == \
        (128, 2 * 256 + 2 * 16 + 4)
    assert {"blocks.0.mamba.a_log", "blocks.0.mamba.dt_bias",
            "blocks.0.mamba.norm.g", "blocks.0.mamba.out_proj.w",
            "blocks.2.attn.wq.w", "lm_head.w"} <= set(names)
    assert not any(n.startswith("blocks.2.mamba") for n in names)
    tree = jax.tree.map(np.asarray, j_params)
    tree["blocks"][1]["mamba"]["conv"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="only in the source"):
        params_from_jax(tree, cfg, CPU)
    tree = jax.tree.map(np.asarray, j_params)
    del tree["blocks"][3]["mamba"]["dt_bias"]
    with pytest.raises(ValueError, match="only in the port"):
        params_from_jax(tree, cfg, CPU)
    tree = jax.tree.map(np.asarray, j_params)
    tree["blocks"][0]["mamba"]["a_log"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, cfg, CPU)


def test_moe_hybrid_as_published_matches_jax():
    """jamba as published, its MoE FFNs on the odd layers, runs every
    serving path within REL of the JAX package on both impls (the checks
    of ``test_serving_paths_match_jax``)."""
    for impl, j_impl in IMPLS:
        _check_serving_paths("jamba", impl, j_impl)
