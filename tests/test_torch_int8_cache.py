"""The port's int8 KV cache and its environment knobs (``repro_torch.tuning``)
against the JAX package on identical weights (``params_from_jax``) and
inputs, at reduced configs, on the CPU.

* the quantizer (``_quantize_kv`` / ``_dequantize_kv``) equals the
  reference's bit for bit on identical inputs, exact .5 ties and all-zero
  rows (where the 1e-6 floor sets the scale) included;
* reduced llama3.2-3b (GQA), deepseek-v2-236b at its kv_rank and at
  kv_rank 64 (MLA, whose ``prefill`` runs eagerly on both sides) and
  jamba-v0.1-52b (hybrid + MoE), each with the int8 cache asked for by
  ``REPRO_CACHE_QUANT=1`` and by ``dtype=torch.int8``: ``prefill`` with
  the int8 rows within 1 of JAX's, the scales within 1e-6 relative and
  the logits within 1e-5 of the largest |logit|; ``decode_step`` from the
  JAX package's own int8 cache (carried across by ``cache_from_jax``) at
  each of 4 steps, the first with an inactive slot; free-running greedy
  tokens equal to JAX's; inactive slots' rows, scales and lengths kept
  bit for bit;
* ``impl="kernel"`` (the kernels' plain versions on the CPU) against JAX
  ``impl="pallas"`` (interpret mode): ``prefill`` attends through the
  flash kernel, decode over an int8 cache through no kernel, as in the
  reference;
* ``extend``, the engine, the service and a measured fleet replica refuse
  an int8 cache (ROADMAP R3 c);
* each ``tuning`` reader returns the JAX package's under the same
  environment, and ``apply_moe`` follows ``REPRO_MOE_CAP`` as JAX's does.

Every environment variable is set through ``monkeypatch``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import tuning as j_tuning  # noqa: E402
from repro.configs import all_archs as j_archs  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.attention import _dequantize_kv as j_dequantize  # noqa: E402
from repro.models.attention import _quantize_kv as j_quantize  # noqa: E402
from repro.models.moe import apply_moe as j_apply_moe  # noqa: E402
from repro.models.transformer import extend as j_extend  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch import tuning  # noqa: E402
from repro_torch.core.interop import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.fleet import MeasuredReplica  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AsyncLLMService,
    ServiceConfig,
    ServingEngine,
    golden_parity_stream,
)

# GQA, MLA at its reduced kv_rank (= head_dim) and at 64, hybrid + MoE
MODELS = ("llama3.2-3b", "deepseek-v2-236b", "deepseek-v2-236b@kv64",
          "jamba-v0.1-52b")
IMPLS = (("eager", "xla"), ("kernel", "pallas"))
HOWS = ("env", "dtype")       # REPRO_CACHE_QUANT=1, or dtype=torch.int8
REL = 1e-5
CPU = "cpu"


def _configs(name):
    arch, _, variant = name.partition("@")
    j_cfg, cfg = j_archs()[arch].reduced(), t_configs.get(arch).reduced()
    if variant == "kv64":
        j_cfg = dataclasses.replace(j_cfg, mla_kv_rank=64)
        cfg = dataclasses.replace(cfg, mla_kv_rank=64)
    return j_cfg, cfg


@functools.cache
def _model(name):
    """(JAX cfg, JAX params, port cfg, port params), built once per model."""
    j_cfg, cfg = _configs(name)
    j_params = j_init_model(jax.random.PRNGKey(0), j_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, CPU)
    return j_cfg, j_params, cfg, params


def _caches(how, j_cfg, cfg, batch, max_len, monkeypatch):
    """The JAX and the port's int8 caches, asked for as ``how`` says; the
    environment variable stays set for the rest of the test."""
    if how == "env":
        monkeypatch.setenv("REPRO_CACHE_QUANT", "1")
        return (j_init_cache(j_cfg, batch, max_len, dtype=jnp.float32),
                t_models.init_cache(cfg, batch, max_len, torch.float32, CPU))
    monkeypatch.delenv("REPRO_CACHE_QUANT", raising=False)
    return (j_init_cache(j_cfg, batch, max_len, dtype=jnp.int8),
            t_models.init_cache(cfg, batch, max_len, torch.int8, CPU))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, what, rel=REL):
    got, want = (np.asarray(_np(a), np.float64) for a in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _scale_rel(cfg) -> float:
    """The scales' relative tolerance: 1e-6 where a layer's K/V come from
    attention and FFN layers alone; in a hybrid, where Mamba layers (whose
    chunked sums run in another order in each package) feed the attention
    layer, 1e-5, the tolerance of the states and logits they feed (the
    scales of jamba's first attention layer part by up to 2.5e-6 relative:
    tools/scan_int8_gaps.py)."""
    return REL if cfg.mixer == "hybrid" else 1e-6


def _int8_caches_close(t_cache, j_cache, what, scale_rel=1e-6):
    """Int8 rows within 1 of the reference's, scales within ``scale_rel``
    relative, Mamba states within 1e-5 of the largest, lengths equal."""
    for i, (tc, jc) in enumerate(zip(t_cache, j_cache)):
        assert set(tc) == set(jc), (what, i, set(tc), set(jc))
        for key in sorted(set(tc) - {"len"}):
            got, want = _np(tc[key]), _np(jc[key])
            if key in ("k", "v", "kv"):
                assert got.dtype == want.dtype == np.int8, (what, i, key)
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1, (what, i, key, diff.max())
            elif key.endswith("_scale"):
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_allclose(got, want, rtol=scale_rel, atol=0,
                                           err_msg=f"{what} {i} {key}")
            else:
                _close(got, want, f"{what} layer {i} {key}")
        np.testing.assert_array_equal(_np(tc["len"]), _np(jc["len"]))


def _int8_layers(cfg):
    return [i for i in range(cfg.n_layers) if cfg.mixer_kind(i) == "attn"]


# --------------------------------------------------------------------------
# the quantizer
# --------------------------------------------------------------------------


def _quantizer_rows():
    """[B, L, H, D] float32 rows: seeded normals at 20 scales, exact .5
    ties (a row whose largest |x| is 127 s has scale s, and x = (n + .5) s
    lands on a tie), all-zero rows and rows under the 1e-6 floor."""
    rng = np.random.default_rng(8)
    rows = [rng.standard_normal((20, 64)) * 10.0 ** rng.uniform(-8, 3, 20)[
        :, None]]
    for s in (1.0, 2.0, 0.25, 3.0):
        tie = np.zeros(64)
        tie[0] = 127 * s
        tie[1:12] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                              -126.5, 63.5, 64.5, -0.25]) * s
        rows.append(tie[None])
    rows += [np.zeros((1, 64)), np.full((1, 64), 3e-7),
             np.linspace(-1e-6, 1e-6, 64)[None]]
    return np.concatenate(rows).astype(np.float32).reshape(3, 3, 3, 64)


def test_quantizer_matches_jax_bitwise():
    x = _quantizer_rows()
    j_q, j_s = j_quantize(jnp.asarray(x))
    q, s = t_attn._quantize_kv(torch.as_tensor(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))
    # the ties round half to even, in both packages
    flat = q.numpy().reshape(-1, 64)
    assert flat[20, :7].tolist() == [127, 0, 2, 2, 0, -2, -2]
    assert flat[20, 7:11].tolist() == [126, -126, 64, 64]
    # an all-zero row, and rows whose largest |x| is at most 1e-6: the
    # floor sets the scale
    assert (flat[24] == 0).all()
    assert (s.numpy().reshape(-1)[24:] == np.float32(1e-6) / 127).all()
    cache = {"k": q, "k_scale": s}
    j_cache = {"k": j_q, "k_scale": j_s}
    np.testing.assert_array_equal(t_attn._dequantize_kv(cache, "k").numpy(),
                                  np.asarray(j_dequantize(j_cache, "k")))
    f32 = torch.as_tensor(x)
    assert t_attn._dequantize_kv({"k": f32}, "k") is f32


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("name", MODELS)
def test_init_cache_matches_jax(name, how, monkeypatch):
    """The int8 attention caches carry float32 scales per (token, head) —
    one latent head for MLA — and the Mamba states stay float32."""
    j_cfg, cfg = _configs(name)
    j_cache, cache = _caches(how, j_cfg, cfg, 2, 16, monkeypatch)
    for i, (tc, jc) in enumerate(zip(cache, j_cache)):
        assert set(tc) == set(jc)
        for key in tc:
            assert tc[key].dtype == getattr(torch, str(jc[key].dtype)), \
                (i, key)
            assert tuple(tc[key].shape) == jc[key].shape
            assert not tc[key].any()
    attn = _int8_layers(cfg)
    keys = {"kv", "kv_scale", "len"} if cfg.attn_kind == "mla" else \
        {"k", "v", "k_scale", "v_scale", "len"}
    assert all(set(cache[i]) == keys for i in attn)
    assert all(set(cache[i]) == {"state", "len"}
               for i in range(cfg.n_layers) if i not in attn)


# --------------------------------------------------------------------------
# the model paths against the JAX package
# --------------------------------------------------------------------------


def _full_impls(cfg, impl, j_impl):
    """MLA's prefill runs eagerly on both sides (R3 b)."""
    return ("eager", "xla") if cfg.attn_kind == "mla" else (impl, j_impl)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("impl,j_impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_prefill_matches_jax(name, impl, j_impl, how, monkeypatch):
    j_cfg, j_params, cfg, params = _model(name)
    full, j_full = _full_impls(cfg, impl, j_impl)
    toks = np.random.default_rng(len(name)).integers(0, cfg.vocab,
                                                      size=(2, 12))
    j_cache, cache = _caches(how, j_cfg, cfg, 2, 32, monkeypatch)
    ops.clear_dispatch_stats()
    j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache,
                                  impl=j_full)
    logits, cache = t_models.prefill(params, cfg, torch.as_tensor(toks),
                                     cache, impl=full, device=CPU)
    _close(logits, j_logits, "prefill logits")
    _int8_caches_close(cache, j_cache, "prefill", _scale_rel(cfg))
    for i in _int8_layers(cfg):
        for key in set(cache[i]) - {"len"}:
            assert cache[i][key][:, 12:].eq(0).all()      # rows past L
            if key.endswith("_scale"):
                assert (cache[i][key][:, :12] > 0).all()
    if full == "kernel":
        assert ops.dispatch_stats()["flash_attention:plain"] == \
            len(_int8_layers(cfg))


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("impl,j_impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_decode_from_jax_cache_step_by_step(name, impl, j_impl, how,
                                            monkeypatch):
    """At each of 4 steps the JAX package's own int8 cache is carried
    across and one port ``decode_step`` on it is held to JAX's on the
    same cache: logits within 1e-5, the new rows within 1 and their scales
    within 1e-6. The first step leaves the second slot inactive. No decode
    kernel is dispatched: the reference routes an int8 cache around it."""
    j_cfg, j_params, cfg, params = _model(name)
    _, j_full = _full_impls(cfg, impl, j_impl)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, size=(2, 9))
    j_cache, _ = _caches(how, j_cfg, cfg, 2, 32, monkeypatch)
    j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache,
                                  impl=j_full)
    for step in range(4):
        active = np.array([True, step > 0])
        tok = np.array(jnp.argmax(j_logits, -1))
        cache = cache_from_jax(jax.tree.map(np.asarray, j_cache), CPU)
        ops.clear_dispatch_stats()
        logits, cache = t_models.decode_step(
            params, cfg, torch.as_tensor(tok), cache, impl=impl,
            active=torch.as_tensor(active), device=CPU)
        j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok),
                                     j_cache, impl=j_impl,
                                     active=jnp.asarray(active))
        _close(logits, j_logits, f"decode step {step} logits")
        _int8_caches_close(cache, j_cache, f"decode step {step}",
                           _scale_rel(cfg))
        assert "decode_attention:plain" not in ops.dispatch_stats()
    assert cache[_int8_layers(cfg)[0]]["len"].tolist() == [13, 12]


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("impl,j_impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_free_running_tokens_match_jax(name, impl, j_impl, how,
                                       monkeypatch):
    """``prefill`` then 4 greedy ``decode_step``s, each package on its own
    int8 cache: the same tokens, logits within 1e-4 of the largest."""
    j_cfg, j_params, cfg, params = _model(name)
    full, j_full = _full_impls(cfg, impl, j_impl)
    toks = np.random.default_rng(11).integers(0, cfg.vocab, size=(2, 10))
    j_cache, cache = _caches(how, j_cfg, cfg, 2, 32, monkeypatch)
    j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache,
                                  impl=j_full)
    logits, cache = t_models.prefill(params, cfg, torch.as_tensor(toks),
                                     cache, impl=full, device=CPU)
    j_toks, toks_out = [], []
    for step in range(4):
        j_tok = jnp.argmax(j_logits, -1)
        tok = torch.argmax(logits, -1)
        j_toks.append(np.asarray(j_tok).tolist())
        toks_out.append(tok.tolist())
        j_logits, j_cache = j_decode(j_params, j_cfg, j_tok, j_cache,
                                     impl=j_impl)
        logits, cache = t_models.decode_step(params, cfg, tok, cache,
                                             impl=impl, device=CPU)
        _close(logits, j_logits, f"free-running step {step}", rel=1e-4)
    assert toks_out == j_toks


@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("name", MODELS)
def test_inactive_slots_keep_their_int8_rows(name, impl):
    """``decode_step(active=...)`` leaves an inactive slot's int8 rows,
    scale rows and length untouched bit for bit (and its Mamba state),
    and writes the active slot's row and scale at its position."""
    _, _, cfg, params = _model(name)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(2, 6)))
    cache = t_models.init_cache(cfg, 2, 16, torch.int8, CPU)
    full = "eager" if cfg.attn_kind == "mla" else impl
    logits, cache = t_models.prefill(params, cfg, toks, cache, impl=full,
                                     device=CPU)
    before = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    _, cache = t_models.decode_step(params, cfg, torch.argmax(logits, -1),
                                    cache, impl=impl,
                                    active=torch.tensor([False, True]),
                                    device=CPU)
    for i, (old, new) in enumerate(zip(before, cache)):
        assert set(old) == set(new)
        for key in old:
            assert torch.equal(new[key][0], old[key][0]), (i, key)
        if i in _int8_layers(cfg):
            for key in set(old) - {"len"}:
                assert not torch.equal(new[key][1, 6], old[key][1, 6])
                assert torch.equal(new[key][1, :6], old[key][1, :6])
            assert new["len"].tolist() == [6, 7]


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------


def test_jax_extend_drops_the_scales():
    """The reference's ``extend`` returns an int8 cache without its scales,
    and its next ``decode_step`` raises ``KeyError`` (R3 c) — what the
    port's refusals below stand for."""
    j_cfg, j_params, _, _ = _model("llama3.2-3b")
    j_cache = j_init_cache(j_cfg, 1, 16, dtype=jnp.int8)
    _, j_cache = j_extend(j_params, j_cfg, jnp.zeros((1, 4), jnp.int32),
                          j_cache)
    assert "k_scale" not in j_cache[0]
    with pytest.raises(KeyError):
        j_decode(j_params, j_cfg, jnp.zeros((1,), jnp.int32), j_cache)


@pytest.mark.parametrize("name", ["llama3.2-3b", "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
def test_extend_refuses_an_int8_cache(name):
    _, _, cfg, params = _model(name)
    cache = t_models.init_cache(cfg, 1, 16, torch.int8, CPU)
    ops.clear_dispatch_stats()
    with pytest.raises(NotImplementedError, match=r"R3 c"):
        t_models.extend(params, cfg, torch.zeros((1, 4), dtype=torch.long),
                        cache, impl="eager", device=CPU)
    assert ops.dispatch_stats() == {}
    assert all(not t.any() for layer in cache for t in layer.values())


def _serving_loops(params, cfg):
    """Constructors of the engine, the service and a measured fleet replica
    (which builds a service per serve), each given ``cache_dtype``."""
    def replica(cache_dtype):
        rep = MeasuredReplica(service=lambda: AsyncLLMService(
            params, cfg, ServiceConfig(max_batch=2, max_len=64, block_len=16),
            cache_dtype=cache_dtype, device=CPU), vocab=cfg.vocab)
        return rep.serve(golden_parity_stream())

    return {
        "engine": lambda dt: ServingEngine(params, cfg, max_batch=2,
                                           max_len=64, cache_dtype=dt,
                                           device=CPU),
        "service": lambda dt: AsyncLLMService(
            params, cfg, ServiceConfig(max_batch=2, max_len=64,
                                       block_len=16),
            cache_dtype=dt, device=CPU),
        "replica": replica}


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("loop", ["engine", "service", "replica"])
def test_serving_loops_refuse_an_int8_cache(loop, how, monkeypatch):
    """Every serving loop prefills through ``extend``, so each refuses an
    int8 cache at entry, asked for by ``cache_dtype`` or by
    ``REPRO_CACHE_QUANT=1``, naming R3 (c); a float32 one still serves."""
    _, _, cfg, params = _model("llama3.2-3b")
    build = _serving_loops(params, cfg)[loop]
    if how == "env":
        monkeypatch.setenv("REPRO_CACHE_QUANT", "1")
        dtype = torch.float32
    else:
        dtype = torch.int8
    with pytest.raises(NotImplementedError, match=r"R3 c"):
        build(dtype)
    monkeypatch.delenv("REPRO_CACHE_QUANT", raising=False)
    assert build(torch.float32) is not None


def test_decode_attention_refuses_an_int8_cache():
    """The plain route refuses an int8 cache (or q) as the CUDA kernel's
    wrapper does; the model dequantizes an int8 cache itself."""
    q = torch.zeros((2, 4, 32))
    kc = torch.zeros((2, 8, 2, 32), dtype=torch.int8)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    ops.clear_dispatch_stats()
    for args in ((q, kc, kc), (q, kc.float(), kc), (kc[:, 0].float(), kc,
                                                     kc)):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            ops.decode_attention(*args, lens)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.decode_attention(q.to(torch.int8), kc.float(), kc.float(), lens)
    assert ops.dispatch_stats() == {}


def test_cache_from_jax_carries_the_int8_leaves(monkeypatch):
    """JAX's int8 caches (GQA, MLA, hybrid) carry across in their types;
    scales beside float rows, or int8 rows without scales, are refused."""
    for name in ("llama3.2-3b", "deepseek-v2-236b", "jamba-v0.1-52b"):
        j_cfg, cfg = _configs(name)
        j_cache, _ = _caches("dtype", j_cfg, cfg, 2, 8, monkeypatch)
        cache = cache_from_jax(jax.tree.map(np.asarray, j_cache), CPU)
        for tc, jc in zip(cache, j_cache):
            assert set(tc) == set(jc)
            assert all(tc[k].dtype == getattr(torch, str(jc[k].dtype))
                       for k in tc)
    bad = jax.tree.map(np.asarray, j_init_cache(
        _configs("llama3.2-3b")[0], 1, 8, dtype=jnp.int8))
    del bad[0]["k_scale"], bad[0]["v_scale"]
    with pytest.raises(ValueError, match="scales"):
        cache_from_jax(bad, CPU)
    bad = jax.tree.map(np.asarray, j_init_cache(
        _configs("deepseek-v2-236b")[0], 1, 8, dtype=jnp.float32))
    bad[0]["kv_scale"] = np.zeros((1, 8, 1), np.float32)
    with pytest.raises(ValueError, match="scales"):
        cache_from_jax(bad, CPU)


# --------------------------------------------------------------------------
# the knobs
# --------------------------------------------------------------------------

READERS = {
    "cache_quant": ("REPRO_CACHE_QUANT", "1"),
    "moe_capacity_factor": ("REPRO_MOE_CAP", "0.5"),
    "train_microbatches": ("REPRO_TRAIN_MICROBATCH", "4"),
    "grad_accum_dtype": ("REPRO_GRAD_ACCUM", "bfloat16"),
    "train_compress": ("REPRO_TRAIN_COMPRESS", "1"),
}


@pytest.mark.parametrize("value", ["unset", "set", "other"])
@pytest.mark.parametrize("reader", sorted(READERS))
def test_tuning_readers_match_jax(reader, value, monkeypatch):
    var, setting = READERS[reader]
    assert reader in j_tuning.__dict__ and reader in tuning.__dict__
    if value == "unset":
        monkeypatch.delenv(var, raising=False)
    else:
        monkeypatch.setenv(var, setting if value == "set" else "2")
    got, want = getattr(tuning, reader)(), getattr(j_tuning, reader)()
    assert got == want and type(got) is type(want)


@functools.cache
def _moe_pair():
    """deepseek-moe-16b's reduced MoE in both packages, one weight set."""
    j_cfg, cfg = _configs("deepseek-moe-16b")
    j_params = j_init_model(jax.random.PRNGKey(0), j_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, CPU)
    return j_cfg, j_params["blocks"][0]["moe"], cfg, params.blocks[0].moe


@pytest.mark.parametrize("cap", ["0.5", "1.25", "2.0"])
def test_apply_moe_follows_the_capacity_knob(cap, monkeypatch):
    """Under ``REPRO_MOE_CAP`` the port's ``apply_moe`` is within 1e-5 of
    JAX's, each expert taking as many tokens; at 1.25 (the default) it is
    the output with the capacity factor passed as 1.25, bit for bit."""
    j_cfg, j_p, cfg, mod = _moe_pair()
    x = np.random.default_rng(24).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    monkeypatch.setenv("REPRO_MOE_CAP", cap)
    got = t_moe.apply_moe(mod, torch.as_tensor(x), cfg)
    _close(got, j_apply_moe(j_p, jnp.asarray(x), j_cfg),
           f"moe at capacity factor {cap}")
    n_tok, top_k, e = 24, cfg.moe.top_k, cfg.moe.n_routed
    cap_tokens = max(1, min(n_tok, int(n_tok * top_k / e * float(cap)) + 1))
    assert t_moe.expert_capacity(n_tok, top_k, e) == cap_tokens
    _, _, _, idx = t_moe.route(mod, torch.as_tensor(x).reshape(n_tok, -1),
                               cfg)
    assert idx.shape == (e, cap_tokens)
    fixed = t_moe.apply_moe(mod, torch.as_tensor(x), cfg,
                            capacity_factor=float(cap))
    assert torch.equal(got, fixed)
    if cap == "1.25":
        monkeypatch.delenv("REPRO_MOE_CAP")
        assert torch.equal(t_moe.apply_moe(mod, torch.as_tensor(x), cfg),
                           fixed)
