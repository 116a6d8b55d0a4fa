"""The port's dense model stack against the JAX package on identical
weights (``params_from_jax``) and inputs, at the reduced configs.

For each of seven dense configs — llama3.2-3b (GQA), qwen1.5-0.5b (MHA,
QKV bias), qwen2-1.5b (GQA, QKV bias), gpt3-7b (LayerNorm, ungated GELU
FFN), llama3-70b (untied head), phi-3-vision-4.2b (MHA; its vision
stub's ``inputs_embeds`` in place of tokens, below) and glm4-9b (GQA,
untied head) — ``forward``,
``prefill``, a padded ``extend`` and ``decode_step`` with an ``active``
mask give logits and caches within 1e-5 of the largest reference value:
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

ARCHS = ("llama3.2-3b", "qwen1.5-0.5b", "qwen2-1.5b", "gpt3-7b",
         "llama3-70b", "phi-3-vision-4.2b", "glm4-9b")
IMPLS = (("eager", "xla"), ("kernel", "pallas"))
REL = 1e-5
CPU = "cpu"


def _close(got, want, what, rel=REL):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _caches_close(t_cache, j_cache, what):
    for i, (tc, jc) in enumerate(zip(t_cache, j_cache)):
        for key in ("k", "v"):
            _close(tc[key], jc[key], f"{what} layer {i} {key}")
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


@functools.cache
def _model(arch):
    """(JAX cfg, JAX params, port cfg, port params), built once per arch."""
    j_cfg = j_archs()[arch].reduced()
    cfg = t_configs.get(arch).reduced()
    j_params = j_init_model(jax.random.PRNGKey(0), j_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, CPU)
    return j_cfg, j_params, cfg, params


def test_rope_tables_are_bitwise_the_references():
    from repro.models.layers import rope_freqs as j_rope
    from repro_torch.models.layers import rope_freqs

    for head_dim, max_pos, theta in ((32, 256, 5e5), (128, 1024, 1e4)):
        got = rope_freqs(head_dim, max_pos, theta, torch.device(CPU))
        for g, w in zip(got, j_rope(head_dim, max_pos, theta)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_reduced_configs_match():
    for arch in ARCHS:
        j_cfg = j_archs()[arch].reduced()
        cfg = t_configs.get(arch).reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)


@pytest.mark.parametrize("impl,j_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_paths_match_jax(arch, impl, j_impl):
    j_cfg, j_params, cfg, params = _model(arch)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, size=(2, 12))
    ops.clear_dispatch_stats()

    want = j_forward(j_params, j_cfg, jnp.asarray(toks), impl=j_impl)
    got = t_models.forward(params, cfg, torch.as_tensor(toks), impl=impl,
                           device=CPU)
    _close(got, want, "forward logits")

    j_cache = j_init_cache(j_cfg, 2, 32, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 2, 32, dtype=torch.float32, device=CPU)
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

    paths = set(ops.dispatch_stats())
    if impl == "kernel":
        assert paths == {"flash_attention:plain", "decode_attention:plain"}
    else:
        assert paths == set()


@pytest.mark.parametrize("impl,j_impl", IMPLS)
def test_inputs_embeds_paths_match_jax(impl, j_impl):
    """phi-3-vision's stub frontend: seeded patch embeddings through
    ``forward`` and ``prefill`` in place of tokens, then 4 greedy
    ``decode_step``s from that cache, within REL of the JAX package; the
    embeds give the embedded tokens' logits exactly."""
    j_cfg, j_params, cfg, params = _model("phi-3-vision-4.2b")
    rng = np.random.default_rng(96)
    emb = (0.02 * rng.standard_normal((2, 12, cfg.d_model))).astype(
        np.float32)
    ops.clear_dispatch_stats()
    want = j_forward(j_params, j_cfg, inputs_embeds=jnp.asarray(emb),
                     impl=j_impl)
    got = t_models.forward(params, cfg, impl=impl, device=CPU,
                           inputs_embeds=torch.as_tensor(emb))
    _close(got, want, "forward logits from embeds")

    j_cache = j_init_cache(j_cfg, 2, 32, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 2, 32, dtype=torch.float32, device=CPU)
    j_logits, j_cache = j_prefill(j_params, j_cfg, None, j_cache,
                                  inputs_embeds=jnp.asarray(emb), impl=j_impl)
    logits, cache = t_models.prefill(params, cfg, None, cache, impl=impl,
                                     device=CPU,
                                     inputs_embeds=torch.as_tensor(emb))
    _close(logits, j_logits, "prefill logits from embeds")
    _caches_close(cache, j_cache, "prefill from embeds")
    for step in range(4):
        tok = np.array(jnp.argmax(j_logits, -1))
        j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok),
                                     j_cache, impl=j_impl)
        logits, cache = t_models.decode_step(params, cfg,
                                             torch.as_tensor(tok), cache,
                                             impl=impl, device=CPU)
        _close(logits, j_logits, f"decode step {step} after embeds")
        _caches_close(cache, j_cache, f"decode step {step} after embeds")
    assert cache[0]["len"].tolist() == [16, 16]
    paths = set(ops.dispatch_stats())
    assert paths == ({"flash_attention:plain", "decode_attention:plain"}
                     if impl == "kernel" else set())

    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 12)))
    embedded = params.embed.e[toks]
    assert torch.equal(
        t_models.forward(params, cfg, toks, impl=impl, device=CPU),
        t_models.forward(params, cfg, impl=impl, device=CPU,
                         inputs_embeds=embedded))


def test_inputs_embeds_are_checked():
    """Embeds on another device raise as tokens do (never copied across);
    a wrong width or no input at all raises too."""
    _, _, cfg, params = _model("phi-3-vision-4.2b")
    cache = t_models.init_cache(cfg, 1, 8, dtype=torch.float32, device=CPU)
    for bad, match in ((torch.zeros((1, 4, cfg.d_model), device="meta"),
                        "meta"),
                       (torch.zeros((1, 4, cfg.d_model + 1)), "inputs_embeds"),
                       (torch.zeros((4, cfg.d_model)), "inputs_embeds")):
        with pytest.raises(ValueError, match=match):
            t_models.forward(params, cfg, device=CPU, inputs_embeds=bad)
        with pytest.raises(ValueError, match=match):
            t_models.prefill(params, cfg, None, cache, device=CPU,
                             inputs_embeds=bad)
    with pytest.raises(ValueError, match="tokens or inputs_embeds"):
        t_models.forward(params, cfg, device=CPU)
    with pytest.raises(ValueError, match="tokens or inputs_embeds"):
        t_models.prefill(params, cfg, None, cache, device=CPU)


def test_cache_round_trip_from_jax():
    """A JAX cache carried across continues exactly like the port's own."""
    j_cfg, j_params, cfg, params = _model("llama3.2-3b")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 7))
    j_cache = j_init_cache(j_cfg, 2, 16, dtype=jnp.float32)
    _, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache)
    cache = cache_from_jax(jax.tree.map(np.asarray, j_cache), CPU)
    tok = np.array([3, 4])
    j_logits, _ = j_decode(j_params, j_cfg, jnp.asarray(tok), j_cache)
    logits, _ = t_models.decode_step(params, cfg, torch.as_tensor(tok), cache,
                                     impl="eager", device=CPU)
    _close(logits, j_logits, "decode from a carried cache")


@pytest.mark.parametrize("offset", [9, 13, 16])
def test_extend_drops_writes_past_the_cache(offset):
    """A padded bucket at an offset near max_len writes past S: JAX drops
    those rows, and so does the port (by index, without faulting). At
    offset 16 = S every row of the bucket falls outside."""
    j_cfg, j_params, cfg, params = _model("qwen2-1.5b")
    rng = np.random.default_rng(offset)
    s = 16
    pre = rng.integers(0, cfg.vocab, size=(1, min(offset, s)))
    j_cache = j_init_cache(j_cfg, 1, s, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 1, s, dtype=torch.float32, device=CPU)
    _, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(pre), j_cache)
    _, cache = t_models.prefill(params, cfg, torch.as_tensor(pre), cache,
                                impl="eager", device=CPU)
    chunk = np.concatenate([rng.integers(0, cfg.vocab, size=(1, 3)),
                            np.zeros((1, 5), np.int64)], axis=1)
    j_logits, j_cache = j_extend(j_params, j_cfg, jnp.asarray(chunk), j_cache,
                                 length=jnp.asarray(3))
    logits, cache = t_models.extend(params, cfg, torch.as_tensor(chunk), cache,
                                    impl="eager", length=3, device=CPU)
    _close(logits, j_logits, "extend logits")
    _caches_close(cache, j_cache, "extend past S")
    assert cache[0]["len"].tolist() == [min(offset, s) + 3]


@pytest.mark.parametrize("impl,j_impl", IMPLS)
def test_decode_at_a_full_cache_matches_jax(impl, j_impl):
    """A slot whose cache is full (len == S) writes nothing and attends
    over all S rows, active or not, as the JAX package's blend does."""
    j_cfg, j_params, cfg, params = _model("llama3.2-3b")
    rng = np.random.default_rng(21)
    s = 12
    toks = rng.integers(0, cfg.vocab, size=(2, s))
    j_cache = j_init_cache(j_cfg, 2, s, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 2, s, dtype=torch.float32, device=CPU)
    _, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache)
    _, cache = t_models.prefill(params, cfg, torch.as_tensor(toks), cache,
                                impl="eager", device=CPU)
    tok = np.array([5, 6])
    for active in (np.array([False, True]), None):
        j_act = None if active is None else jnp.asarray(active)
        t_act = None if active is None else torch.as_tensor(active)
        j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok),
                                     j_cache, impl=j_impl, active=j_act)
        logits, cache = t_models.decode_step(params, cfg,
                                             torch.as_tensor(tok), cache,
                                             impl=impl, active=t_act,
                                             device=CPU)
        _close(logits, j_logits, "decode logits at a full cache")
        _caches_close(cache, j_cache, "decode at a full cache")


def test_params_from_jax_checks_the_tree():
    j_cfg, j_params, cfg, _ = _model("llama3.2-3b")
    tree = jax.tree.map(np.asarray, j_params)
    tree["blocks"][0]["attn"]["wq"]["b"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="only in the source"):
        params_from_jax(tree, cfg, CPU)
    tree = jax.tree.map(np.asarray, j_params)
    tree["embed"]["e"] = tree["embed"]["e"][:10]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, cfg, CPU)
    names = dict(_model("llama3-70b")[3].named_parameters())
    assert "blocks.1.attn.wq.w" in names and "lm_head.w" in names
    assert tuple(names["blocks.1.attn.wq.w"].shape) == (128, 4 * 32)


def test_unknown_impl_and_later_entry_points_raise():
    _, _, cfg, params = _model("llama3.2-3b")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="impl"):
        t_models.forward(params, cfg, toks, impl="xla", device=CPU)


def test_tensors_must_lie_on_the_device_asked_for():
    _, _, cfg, params = _model("llama3.2-3b")
    toks = torch.zeros((1, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="meta"):
        t_models.forward(params, cfg, toks, device=CPU)
