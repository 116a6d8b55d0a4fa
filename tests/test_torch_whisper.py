"""The port's encoder-decoder path (reduced whisper-tiny: 2 encoder and 2
decoder blocks, ``encoder_len`` 16) against the JAX package on identical
weights (``params_from_jax``) and inputs, on the CPU.

* ``encode``, ``forward`` with and without ``enc_out`` (the zero-frame
  stub), ``prefill``, a padded ``extend`` with ``length`` and several
  ``decode_step``s (one with an ``active`` mask) within 1e-5 of the
  largest reference value, ``impl="eager"`` against JAX ``xla`` and
  ``impl="kernel"`` (the kernels' plain versions on the CPU) against JAX
  ``pallas`` (interpret mode), with the kernel dispatches each path makes;
* ``encode_scanned`` and the scanned entry points equal the unscanned ones
  bit for bit, and are within 1e-5 of the JAX package's;
* the engine's greedy tokens and iteration stats equal the JAX engine's
  with an ``enc_out`` whose rows differ: a prompt chunk attends to row 0
  whatever its slot, a decode step to its slot's row (ROADMAP R5 a);
* the paged service serves the decoder alone, as the JAX service does
  (R5 b): tokens, admissions, stats and counters equal;
* ``launch/serve`` runs whisper-tiny on the CPU; ``enc_out`` is checked.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs as j_archs  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import stacked as j_stacked  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import SCHEDULERS as J_SCHEDULERS  # noqa: E402
from repro.serving import AsyncLLMService as JAsyncLLMService  # noqa: E402
from repro.serving import ServeRequest as JServeRequest  # noqa: E402
from repro.serving import ServiceConfig as JServiceConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.service import service_requests as j_service_requests  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.core.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    SCHEDULERS,
    AsyncLLMService,
    ServeRequest,
    ServiceConfig,
    ServingEngine,
    golden_parity_stream,
    service_requests,
)

ARCH = "whisper-tiny"
IMPLS = (("eager", "xla"), ("kernel", "pallas"))
REL = 1e-5
CPU = "cpu"
MAX_BATCH, MAX_LEN = 3, 64


@functools.cache
def _model():
    """(JAX cfg, JAX params, port cfg, port params), built once."""
    j_cfg = j_archs()[ARCH].reduced()
    cfg = t_configs.get(ARCH).reduced()
    j_params = j_init_model(jax.random.PRNGKey(0), j_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, CPU)
    return j_cfg, j_params, cfg, params


def _frames(cfg, batch, seed):
    """Seeded frame embeddings [batch, encoder_len, d_model] x 0.02."""
    rng = np.random.default_rng(seed)
    return (0.02 * rng.standard_normal(
        (batch, cfg.encoder_len, cfg.d_model))).astype(np.float32)


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


def _t(x):
    return torch.as_tensor(np.array(x))


def test_configs_match():
    for port, ref in ((t_configs.get(ARCH).model, j_archs()[ARCH].model),
                      (t_configs.get(ARCH).reduced(),
                       j_archs()[ARCH].reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cfg = t_configs.get(ARCH).model
    assert (cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.encoder_len) == \
        (4, 4, 384, 6, 6, 64, 1500)
    names = dict(_model()[3].named_parameters())
    assert {"enc_blocks.1.attn.wq.w", "enc_norm.b", "blocks.0.cross.wv.w",
            "blocks.1.norm_x.g"} <= set(names)
    assert not any(n.startswith("enc_blocks") and ".cross." in n
                   for n in names)


@pytest.mark.parametrize("impl,j_impl", IMPLS)
def test_paths_match_jax(impl, j_impl):
    j_cfg, j_params, cfg, params = _model()
    rng = np.random.default_rng(1)
    frames = _frames(cfg, 2, 2)
    toks = rng.integers(0, cfg.vocab, size=(2, 12))
    n_enc, n_dec = cfg.encoder_layers, cfg.n_layers
    kernel = impl == "kernel"

    ops.clear_dispatch_stats()
    j_enc = jt.encode(j_params, j_cfg, jnp.asarray(frames), impl=j_impl)
    enc = t_models.encode(params, cfg, _t(frames), impl=impl, device=CPU)
    _close(enc, j_enc, "encode")
    assert ops.dispatch_stats() == \
        ({"flash_attention:plain": n_enc} if kernel else {})
    enc = _t(j_enc)          # both packages go on from the same rows

    for label, eo in (("with enc_out", enc), ("zero-frame stub", None)):
        ops.clear_dispatch_stats()
        want = jt.forward(j_params, j_cfg, jnp.asarray(toks), impl=j_impl,
                          enc_out=None if eo is None else j_enc)
        got = t_models.forward(params, cfg, _t(toks), impl=impl, device=CPU,
                               enc_out=eo)
        _close(got, want, f"forward {label}")
        n_flash = 2 * n_dec + (n_enc if eo is None else 0)
        assert ops.dispatch_stats() == \
            ({"flash_attention:plain": n_flash} if kernel else {})

    j_cache = jt.init_cache(j_cfg, 2, 32, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 2, 32, dtype=torch.float32, device=CPU)
    ops.clear_dispatch_stats()
    j_logits, j_cache = jt.prefill(j_params, j_cfg, jnp.asarray(toks),
                                   j_cache, enc_out=j_enc, impl=j_impl)
    logits, cache = t_models.prefill(params, cfg, _t(toks), cache, impl=impl,
                                     device=CPU, enc_out=enc)
    _close(logits, j_logits, "prefill logits")
    _caches_close(cache, j_cache, "prefill")
    assert ops.dispatch_stats() == \
        ({"flash_attention:plain": 2 * n_dec} if kernel else {})

    # decode steps (the second with the second slot inactive): the
    # cross-attention at Lq 1 through the flash kernel's plain version
    for step, active in enumerate((None, np.array([True, False]), None)):
        tok = np.array(jnp.argmax(j_logits, -1))
        ops.clear_dispatch_stats()
        j_logits, j_cache = jt.decode_step(
            j_params, j_cfg, jnp.asarray(tok), j_cache, enc_out=j_enc,
            impl=j_impl, active=None if active is None else jnp.asarray(active))
        logits, cache = t_models.decode_step(
            params, cfg, _t(tok), cache, impl=impl, device=CPU, enc_out=enc,
            active=None if active is None else _t(active))
        _close(logits, j_logits, f"decode step {step}")
        _caches_close(cache, j_cache, f"decode step {step}")
        assert ops.dispatch_stats() == (
            {"decode_attention:plain": n_dec,
             "flash_attention:plain": n_dec} if kernel else {})
    assert cache[0]["len"].tolist() == [15, 14]

    # a right-padded chunk: 5 true tokens in a bucket of 8
    more = np.concatenate([rng.integers(0, cfg.vocab, size=(2, 5)),
                           np.zeros((2, 3), np.int64)], axis=1)
    j_logits, j_cache = jt.extend(j_params, j_cfg, jnp.asarray(more), j_cache,
                                  enc_out=j_enc, impl=j_impl,
                                  length=jnp.asarray(5))
    logits, cache = t_models.extend(params, cfg, _t(more), cache, impl=impl,
                                    length=5, device=CPU, enc_out=enc)
    _close(logits, j_logits, "extend logits")
    _caches_close(cache, j_cache, "extend")
    tok = np.array(jnp.argmax(j_logits, -1))
    j_logits, _ = jt.decode_step(j_params, j_cfg, jnp.asarray(tok), j_cache,
                                 enc_out=j_enc, impl=j_impl)
    logits, _ = t_models.decode_step(params, cfg, _t(tok), cache, impl=impl,
                                     device=CPU, enc_out=enc)
    _close(logits, j_logits, "decode after extend")


def test_enc_out_is_checked():
    _, _, cfg, params = _model()
    toks = torch.zeros((1, 4), dtype=torch.int64)
    meta = torch.zeros((1, cfg.encoder_len, cfg.d_model), device="meta")
    with pytest.raises(ValueError, match="meta"):
        t_models.forward(params, cfg, toks, device=CPU, enc_out=meta)
    with pytest.raises(ValueError, match="meta"):
        t_models.encode(params, cfg, meta, device=CPU)
    with pytest.raises(ValueError, match="enc_out of shape"):
        t_models.forward(params, cfg, toks, device=CPU,
                         enc_out=torch.zeros((1, 4, cfg.d_model + 1)))
    with pytest.raises(ValueError, match="rows for"):
        ServingEngine(params, cfg, max_batch=2, max_len=MAX_LEN, device=CPU,
                      enc_out=torch.zeros((3, 4, cfg.d_model)))
    llama = t_configs.get("llama3.2-3b").reduced()
    l_params = t_models.init_model(llama, device=CPU)
    with pytest.raises(ValueError, match="no cross-attention"):
        t_models.forward(l_params, llama, toks, device=CPU,
                         enc_out=torch.zeros((1, 4, llama.d_model)))
    with pytest.raises(ValueError, match="no encoder"):
        t_models.encode(l_params, llama, torch.zeros((1, 4, llama.d_model)),
                        device=CPU)


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_scanned_equals_unscanned(impl):
    _, _, cfg, params = _model()
    sp = t_models.stack_params(params, cfg)
    assert len(sp.enc_stacked) == 1 and sp.enc_norm is params.enc_norm
    frames = _t(_frames(cfg, 2, 3))
    toks = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(2, 9)))
    enc = t_models.encode(params, cfg, frames, impl=impl, device=CPU)
    assert torch.equal(t_models.encode_scanned(sp, cfg, frames, impl=impl,
                                               device=CPU), enc)
    for eo in (enc, None):
        want = t_models.forward(params, cfg, toks, impl=impl, device=CPU,
                                enc_out=eo)
        got = t_models.forward_scanned(sp, cfg, toks, impl=impl, device=CPU,
                                       enc_out=eo)
        assert torch.equal(got, want)
    cache = t_models.init_cache(cfg, 2, 24, torch.float32, CPU)
    slots = t_models.stack_cache(
        t_models.init_cache(cfg, 2, 24, torch.float32, CPU), cfg)
    logits, cache = t_models.prefill(params, cfg, toks, cache, impl=impl,
                                     device=CPU, enc_out=enc)
    s_logits, slots = t_models.prefill_scanned(sp, cfg, toks, slots,
                                               impl=impl, device=CPU,
                                               enc_out=enc)
    assert torch.equal(s_logits, logits)
    for step in range(3):
        tok = torch.argmax(logits, -1)
        logits, cache = t_models.decode_step(params, cfg, tok, cache,
                                             impl=impl, device=CPU,
                                             enc_out=enc)
        s_logits, slots = t_models.decode_step_scanned(
            sp, cfg, tok, slots, impl=impl, device=CPU, enc_out=enc)
        assert torch.equal(s_logits, logits), step
    for a, b in zip(cache, t_models.unstack_cache(slots, cfg)):
        for key in a:
            assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("impl,j_impl", IMPLS)
def test_scanned_matches_jax_scanned(impl, j_impl):
    j_cfg, j_params, cfg, params = _model()
    j_sp = j_stacked.stack_params(j_params, j_cfg)
    sp = t_models.stack_params(params, cfg)
    frames = _frames(cfg, 2, 5)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 10))
    j_enc = jt.encode_scanned(j_sp, j_cfg, jnp.asarray(frames), impl=j_impl)
    enc = t_models.encode_scanned(sp, cfg, _t(frames), impl=impl, device=CPU)
    _close(enc, j_enc, "encode_scanned")
    enc = _t(j_enc)
    for label, eo in (("with enc_out", enc), ("zero-frame stub", None)):
        want = jt.forward_scanned(j_sp, j_cfg, jnp.asarray(toks), impl=j_impl,
                                  remat=False,
                                  enc_out=None if eo is None else j_enc)
        got = t_models.forward_scanned(sp, cfg, _t(toks), impl=impl,
                                       device=CPU, enc_out=eo)
        _close(got, want, f"forward_scanned {label}")
    j_slots = j_stacked.stack_cache(
        jt.init_cache(j_cfg, 2, 16, dtype=jnp.float32), j_cfg)
    slots = t_models.stack_cache(
        t_models.init_cache(cfg, 2, 16, torch.float32, CPU), cfg)
    j_logits, j_slots = jt.prefill_scanned(j_sp, j_cfg, jnp.asarray(toks),
                                           j_slots, enc_out=j_enc,
                                           impl=j_impl)
    logits, slots = t_models.prefill_scanned(sp, cfg, _t(toks), slots,
                                             impl=impl, device=CPU,
                                             enc_out=enc)
    _close(logits, j_logits, "prefill_scanned")
    for step in range(3):
        tok = np.array(jnp.argmax(j_logits, -1))
        j_logits, j_slots = jt.decode_step_scanned(
            j_sp, j_cfg, jnp.asarray(tok), j_slots, enc_out=j_enc,
            impl=j_impl)
        logits, slots = t_models.decode_step_scanned(
            sp, cfg, _t(tok), slots, impl=impl, device=CPU, enc_out=enc)
        _close(logits, j_logits, f"decode_step_scanned {step}")


def _specs(seed, n, max_new):
    """(prompt, max_new, arrival iteration) per request."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, size=int(rng.integers(5, 30))).tolist(),
             max_new, i // 2) for i in range(n)]


def _scheduler(table, name):
    return table[name](chunk=8) if name == "chunked_prefill" \
        else table[name]()


def _stats_fields(stats):
    return [{k: v for k, v in dataclasses.asdict(s).items()
             if k != "seconds"} for s in stats]


@functools.cache
def _engine_enc_out():
    """One encoding per slot, of different frames (JAX's, and as a
    tensor)."""
    j_cfg, j_params, _, _ = _model()
    j_enc = jt.encode(j_params, j_cfg,
                      jnp.asarray(_frames(j_cfg, MAX_BATCH, 7)))
    return j_enc, _t(j_enc)


@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("sched", ["vllm", "orca", "chunked_prefill"])
def test_engine_matches_jax_engine(sched, impl):
    j_cfg, j_params, cfg, params = _model()
    j_enc, enc = _engine_enc_out()
    specs = _specs(0, 6, 5)
    j_res = JServingEngine(j_params, j_cfg, max_batch=MAX_BATCH,
                           max_len=MAX_LEN, enc_out=j_enc).run(
        [JServeRequest(i, list(p), m, arrived_iter=a)
         for i, (p, m, a) in enumerate(specs)],
        _scheduler(J_SCHEDULERS, sched))
    ops.clear_dispatch_stats()
    res = ServingEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        impl=impl, device=CPU, enc_out=enc).run(
        [ServeRequest(i, list(p), m, arrived_iter=a)
         for i, (p, m, a) in enumerate(specs)],
        _scheduler(SCHEDULERS, sched))
    assert not res.truncated and len(res.finished) == 6
    assert {r.rid: r.generated for r in res.finished} == \
        {r.rid: r.generated for r in j_res.finished}
    assert _stats_fields(res.stats) == _stats_fields(j_res.stats)
    n_decode = sum(1 for s in res.stats if s.n_decode)
    # one extend per prompt, or per chunk of 8 under chunked_prefill
    n_chunks = sum(-(-len(p) // 8) if sched == "chunked_prefill" else 1
                   for p, _, _ in specs)
    # prompts go through extend (plain attention, the cross-attention
    # through flash), decode through both kernels
    assert ops.dispatch_stats() == ({
        "decode_attention:plain": n_decode * cfg.n_layers,
        "flash_attention:plain": (n_decode + n_chunks) * cfg.n_layers}
        if impl == "kernel" else {})


def test_engine_prompts_attend_to_row_0():
    """ROADMAP R5 a, as the reference does it: every request's first token
    is the argmax of its prompt through ``extend`` against row 0 of
    ``enc_out``, whatever its slot, and that differs from attending to its
    own slot's row."""
    _, _, cfg, params = _model()
    _, enc = _engine_enc_out()
    specs = _specs(0, 6, 3)
    res = ServingEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        device=CPU, enc_out=enc).run(
        [ServeRequest(i, list(p), m) for i, (p, m, _) in enumerate(specs)],
        _scheduler(SCHEDULERS, "vllm"))
    parted = 0
    for r in res.finished:
        cache = t_models.init_cache(cfg, 1, MAX_LEN, torch.float32, CPU)
        row0, _ = t_models.extend(params, cfg, _t([r.prompt]), cache,
                                  device=CPU, enc_out=enc[:1])
        assert int(row0.argmax(-1)) == r.generated[0], r.rid
        for slot in range(1, MAX_BATCH):
            cache = t_models.init_cache(cfg, 1, MAX_LEN, torch.float32, CPU)
            own, _ = t_models.extend(params, cfg, _t([r.prompt]), cache,
                                     device=CPU, enc_out=enc[slot:slot + 1])
            parted += not torch.equal(own, row0)
    assert parted == len(res.finished) * (MAX_BATCH - 1)


def test_service_matches_jax_service():
    """ROADMAP R5 b: the paged service takes no ``enc_out`` and serves the
    decoder alone (cross-attention skipped), as the JAX service does:
    tokens, admissions, iteration stats and counters equal, and no flash
    dispatch."""
    j_cfg, j_params, cfg, params = _model()
    stream = golden_parity_stream()
    want = JAsyncLLMService(
        j_params, j_cfg,
        JServiceConfig(max_batch=MAX_BATCH, max_len=MAX_LEN,
                       block_len=16)).serve_sync(
        j_service_requests(stream, j_cfg.vocab),
        _scheduler(J_SCHEDULERS, "orca"), stream_name=stream.name)
    ops.clear_dispatch_stats()
    svc = AsyncLLMService(params, cfg, ServiceConfig(
        max_batch=MAX_BATCH, max_len=MAX_LEN, block_len=16), device=CPU)
    res = svc.serve_sync(service_requests(stream, cfg.vocab),
                         _scheduler(SCHEDULERS, "orca"),
                         stream_name=stream.name)
    assert not res.truncated and not res.unfinished
    assert {r.rid: r.generated for r in res.finished} == \
        {r.rid: r.generated for r in want.finished}
    assert res.admissions == want.admissions
    assert _stats_fields(res.stats) == _stats_fields(want.stats)
    assert res.counters == want.counters
    n_decode = sum(1 for s in res.stats if s.n_decode)
    assert ops.dispatch_stats() == \
        {"decode_attention:plain": n_decode * cfg.n_layers}


def test_launch_serve_runs_whisper_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "3", "--max-batch", "2"]) == 0
    out = capsys.readouterr().out
    assert '"requests": 3' in out and "req 0:" in out
