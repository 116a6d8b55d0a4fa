"""Scan over layers in the port (``repro_torch.models.stacked`` and the
scanned entry points of ``repro_torch.models.transformer``).

* ``layer_period`` equals the JAX package's for every config of the
  port's registry, published and reduced: 8 for jamba-v0.1-52b, 1 for
  every other (deepseek-moe-16b's MoE is on every layer);
* ``stack_*`` then ``unstack_*`` gives parameters and caches (float32 and
  int8) back bit for bit; ``stack_params`` shares the source's embedding,
  final norm and head;
* ``forward_scanned``, ``prefill_scanned`` and 4 ``decode_step_scanned``
  steps equal ``forward``, ``prefill`` and ``decode_step`` bit for bit
  (logits and every cache tensor) on both impls, for reduced llama3.2-3b,
  deepseek-moe-16b, deepseek-v2-236b, mamba2-2.7b, the MoE-free hybrid
  and jamba-v0.1-52b at 8 layers (period 4, 2 steps), and over an int8
  cache on llama; MLA's full-sequence paths run eagerly;
* they are within 1e-5 of the largest |logit| of the JAX package's
  ``forward_scanned(remat=False)``, ``prefill_scanned`` and
  ``decode_step_scanned`` on the same weights, each package stacking its
  own tree; jamba at 8 layers within 2e-5 (see ``JAX_REL``);
* on the card (``cuda`` marker), scanned equals unscanned bit for bit on
  reduced llama and mamba2 through the kernels, each launched once per
  layer and call.

This file imports JAX only inside the tests that compare with it, so its
card tests run where JAX is not installed.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import stacked  # noqa: E402

# (name, its scanned layout): reduced configs, the MoE-free hybrid (1 step
# of period 4) and jamba at 8 layers (2 steps of period 4)
MODELS = ("llama3.2-3b", "deepseek-moe-16b", "deepseek-v2-236b",
          "mamba2-2.7b", "hybrid", "jamba-v0.1-52b@8")
IMPLS = ("eager", "kernel")
J_IMPL = {"eager": "xla", "kernel": "pallas"}
REL = 1e-5
# Against the JAX package: 1e-5 of the largest |logit|, but 2e-5 for jamba
# at 8 layers (Mamba, attention and MoE layers with random weights), where
# one decode step from the JAX package's own scanned cache already parts
# from it by 1.2e-5 (eager) to 1.4e-5 (kernel) at this input, the port's
# unscanned decode_step from JAX's by up to 1.2e-5, and the JAX package's
# scanned and unscanned decode from each other by up to 8.8e-6
# (tools/scan_int8_gaps.py). Within one package, at this input, the two
# impls (which differ only in the order of their float32 sums) part by up
# to 6.7e-6 (``order_only``), half of the cross-package gap. The cause is
# float32 rounding alone (ROADMAP F5, ``--float64`` lines of the same
# tool): float64 copies of both packages agree to 2.1e-13, while in float32
# each package lies up to 6.8e-5 (the port) and 1.0e-4 (the reference)
# from its float64 copy over token seeds, and aligning the Mamba layers'
# chunked sums leaves the gap as it was. 2e-5 holds at this input.
JAX_REL = {"jamba-v0.1-52b@8": 2e-5}
CPU = "cpu"


def _config(name):
    """A reduced port config by test name."""
    if name == "hybrid":
        return dataclasses.replace(
            t_configs.get("jamba-v0.1-52b").reduced(), moe=None)
    arch, _, layers = name.partition("@")
    cfg = t_configs.get(arch).reduced()
    return dataclasses.replace(cfg, n_layers=int(layers)) if layers else cfg


def _seeded_decay(params, seed=0):
    """Per-layer ``a_log`` and ``dt_bias`` from ``seed`` in place of zeros,
    so no two Mamba layers share their decay."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for blk in params.blocks:
            if hasattr(blk, "mamba"):
                h = blk.mamba.a_log.shape[0]
                blk.mamba.a_log.copy_(torch.randn(h, generator=gen) * 0.5)
                blk.mamba.dt_bias.copy_(torch.randn(h, generator=gen) * 0.5
                                        - 1.0)
    return params


@functools.cache
def _model(name, device=CPU):
    cfg = _config(name)
    return cfg, _seeded_decay(t_models.init_model(cfg, seed=3, device=device))


def _full_impl(cfg, impl):
    return "eager" if cfg.attn_kind == "mla" else impl


def _same_caches(layers, slots, cfg, what):
    unstacked = t_models.unstack_cache(slots, cfg)
    assert len(unstacked) == len(layers) == cfg.n_layers
    for i, (a, b) in enumerate(zip(layers, unstacked)):
        assert set(a) == set(b), (what, i)
        for key in a:
            assert torch.equal(a[key], b[key]), (what, i, key)


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(t_configs.all_archs()))
def test_layer_period_matches_jax(arch):
    pytest.importorskip("jax")
    from repro.configs import all_archs as j_archs
    from repro.models.stacked import layer_period as j_layer_period

    port, ref = t_configs.get(arch), j_archs()[arch]
    for cfg, j_cfg in ((port.model, ref.model),
                       (port.reduced(), ref.reduced())):
        assert stacked.layer_period(cfg) == j_layer_period(j_cfg)
        assert cfg.n_layers % stacked.layer_period(cfg) == 0
    want = 8 if arch == "jamba-v0.1-52b" else 1
    assert stacked.layer_period(port.model) == want


@pytest.mark.parametrize("name", MODELS)
def test_stack_round_trips(name):
    """Parameters and caches (float32, and int8 with its scales) come back
    bit for bit; slot j, step k holds layer k * period + j."""
    cfg, params = _model(name)
    p = stacked.layer_period(cfg)
    sp = t_models.stack_params(params, cfg)
    assert (sp.period, sp.n_steps) == (p, cfg.n_layers // p)
    assert sp.embed is params.embed and sp.final_norm is params.final_norm
    assert (getattr(sp, "lm_head", None) is
            getattr(params, "lm_head", None))
    back = stacked.unstack_blocks(sp.slots, p)
    assert len(back) == cfg.n_layers
    for i, blk in enumerate(params.blocks):
        names = dict(blk.named_parameters())
        assert set(back[i]) == set(names)
        for key, t in names.items():
            assert torch.equal(back[i][key], t), (i, key)
            assert torch.equal(sp.slots[i % p][key][i // p], t)
            assert sp.slots[i % p][key].shape == (sp.n_steps,) + t.shape
    for dtype in (torch.float32, torch.int8):
        cache = t_models.init_cache(cfg, 2, 8, dtype, CPU)
        for layer in cache:
            for t in layer.values():
                t.copy_(torch.randint(-100, 100, t.shape))
        slots = t_models.stack_cache(cache, cfg)
        assert len(slots) == p
        _same_caches(cache, slots, cfg, f"{dtype} round trip")


def test_block_views_read_the_template():
    """``layers()`` reads the stacked params in layer order; a step's block
    view resolves names as the block does: a missing sub-module raises
    AttributeError (``hasattr`` is False), a bias the block has as
    ``None`` is ``None``, a weight is a view of the stack."""
    cfg, params = _model("jamba-v0.1-52b@8")
    sp = t_models.stack_params(params, cfg)
    blocks = sp.layers().blocks
    assert len(blocks) == cfg.n_layers
    view = blocks[6]                             # step 1 of slot 2
    assert hasattr(view, "attn") and not hasattr(view, "mamba")
    assert hasattr(view, "ffn") and not hasattr(view, "moe")
    assert view.attn.wq.b is None
    w = view.attn.wq.w
    assert w.data_ptr() == sp.slots[2]["attn.wq.w"][1].data_ptr()
    assert torch.equal(w, params.blocks[6].attn.wq.w)
    moe = blocks[3]                              # step 0 of slot 3
    assert hasattr(moe, "mamba") and hasattr(moe, "moe")
    assert torch.equal(moe.moe.wi, params.blocks[3].moe.wi)


def test_stacking_is_checked():
    cfg, params = _model("llama3.2-3b")
    with pytest.raises(ValueError, match="period"):
        stacked.stack_blocks(params.blocks, 3)
    mixed = [params.blocks[0], _model("mamba2-2.7b")[1].blocks[0]]
    with pytest.raises(ValueError, match="structure"):
        stacked.stack_blocks(mixed, 1)
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(TypeError, match="stack_params"):
        t_models.forward_scanned(params, cfg, toks, device=CPU)
    sp = t_models.stack_params(params, cfg)
    with pytest.raises(ValueError, match="layers"):
        t_models.forward_scanned(sp, dataclasses.replace(cfg, n_layers=4),
                                 toks, device=CPU)


# --------------------------------------------------------------------------
# scanned equals unscanned
# --------------------------------------------------------------------------


def _scanned_vs_unscanned(name, impl, device, dtype=torch.float32,
                          steps=4):
    """Both layouts through ``forward``, ``prefill`` and ``steps`` greedy
    decode steps: every logit and cache tensor equal, bit for bit. Returns
    each path's dispatch counts."""
    cfg, params = _model(name, device)
    sp = t_models.stack_params(params, cfg)
    full = _full_impl(cfg, impl)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 11)), device=device)
    counts = {}
    want = t_models.forward(params, cfg, toks, impl=full, device=device)
    got = t_models.forward_scanned(sp, cfg, toks, impl=full, device=device)
    assert torch.equal(got, want), "forward"
    cache = t_models.init_cache(cfg, 2, 24, dtype, device)
    slots = t_models.stack_cache(t_models.init_cache(cfg, 2, 24, dtype,
                                                     device), cfg)
    for label, run in (("unscanned", True), ("scanned", False)):
        ops.clear_dispatch_stats()
        ops.reset_launch_counts()
        if run:
            logits, cache = t_models.prefill(params, cfg, toks, cache,
                                             impl=full, device=device)
        else:
            s_logits, s_out = t_models.prefill_scanned(
                sp, cfg, toks, slots, impl=full, device=device)
            assert s_out is slots
        counts[label] = [(ops.dispatch_stats(), ops.launch_counts())]
    assert torch.equal(s_logits, logits), "prefill logits"
    _same_caches(cache, slots, cfg, "prefill")
    for step in range(steps):
        tok = torch.argmax(logits, -1)
        ops.clear_dispatch_stats()
        ops.reset_launch_counts()
        logits, cache = t_models.decode_step(params, cfg, tok, cache,
                                             impl=impl, device=device)
        counts["unscanned"].append((ops.dispatch_stats(),
                                    ops.launch_counts()))
        ops.clear_dispatch_stats()
        ops.reset_launch_counts()
        s_logits, slots = t_models.decode_step_scanned(
            sp, cfg, tok, slots, impl=impl, device=device)
        counts["scanned"].append((ops.dispatch_stats(), ops.launch_counts()))
        assert torch.equal(s_logits, logits), f"decode step {step}"
        _same_caches(cache, slots, cfg, f"decode step {step}")
    assert counts["scanned"] == counts["unscanned"]
    return cfg, counts["scanned"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_scanned_equals_unscanned(name, impl):
    cfg, counts = _scanned_vs_unscanned(name, impl, CPU)
    n_attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    n_mamba = cfg.n_layers - n_attn
    prefill, decode = counts[0][0], counts[1][0]
    if impl == "kernel":
        assert prefill.get("ssd_scan:plain", 0) == n_mamba
        assert prefill.get("flash_attention:plain", 0) == \
            (0 if cfg.attn_kind == "mla" else n_attn)
        assert decode == ({"decode_attention:plain": n_attn} if n_attn
                          else {})
    else:
        assert prefill == decode == {}


@pytest.mark.parametrize("impl", IMPLS)
def test_scanned_equals_unscanned_over_an_int8_cache(impl):
    _, counts = _scanned_vs_unscanned("llama3.2-3b", impl, CPU, torch.int8)
    assert all("decode_attention:plain" not in d for d, _ in counts)


def test_scanned_inputs_embeds():
    """``inputs_embeds`` in place of tokens, as ``forward`` and
    ``prefill`` take them."""
    cfg, params = _model("llama3.2-3b")
    sp = t_models.stack_params(params, cfg)
    emb = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32))
    assert torch.equal(
        t_models.forward_scanned(sp, cfg, inputs_embeds=emb, device=CPU),
        t_models.forward(params, cfg, inputs_embeds=emb, device=CPU))
    cache = t_models.init_cache(cfg, 2, 8, torch.float32, CPU)
    slots = t_models.stack_cache(t_models.init_cache(cfg, 2, 8,
                                                     torch.float32, CPU), cfg)
    want, cache = t_models.prefill(params, cfg, None, cache, device=CPU,
                                   inputs_embeds=emb)
    got, slots = t_models.prefill_scanned(sp, cfg, None, slots, device=CPU,
                                          inputs_embeds=emb)
    assert torch.equal(got, want)
    _same_caches(cache, slots, cfg, "inputs_embeds prefill")


# --------------------------------------------------------------------------
# against the JAX package's scanned entry points
# --------------------------------------------------------------------------


@functools.cache
def _jax_pair(name):
    """(JAX cfg, JAX stacked params, port cfg, port stacked params): one
    weight set (the JAX package's ``init_model``, whose Mamba decay is
    zero), each package stacking its own tree."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import init_model as j_init_model
    from repro.models.stacked import stack_params as j_stack_params
    from repro.models.transformer import ModelConfig as JModelConfig
    from repro.models.transformer import MoECfg as JMoECfg
    from repro_torch.core.interop import params_from_jax

    cfg = _config(name)
    fields = dataclasses.asdict(cfg)
    if cfg.moe is not None:
        fields["moe"] = JMoECfg(**fields["moe"])
    j_cfg = JModelConfig(**fields)
    tree = jax.tree.map(np.asarray,
                        j_init_model(jax.random.PRNGKey(0), j_cfg))
    params = params_from_jax(tree, cfg, CPU)
    j_sp = j_stack_params(jax.tree.map(jnp.asarray, tree), j_cfg)
    return j_cfg, j_sp, cfg, t_models.stack_params(params, cfg)


def _close(got, want, what, rel=REL):
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_scanned_matches_jax_scanned(name, impl):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import init_cache as j_init_cache
    from repro.models.stacked import stack_cache as j_stack_cache
    from repro.models.transformer import (
        decode_step_scanned as j_decode_scanned,
        forward_scanned as j_forward_scanned,
        prefill_scanned as j_prefill_scanned,
    )

    j_cfg, j_sp, cfg, sp = _jax_pair(name)
    rel = JAX_REL.get(name, REL)
    full = _full_impl(cfg, impl)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 10))
    want = j_forward_scanned(j_sp, j_cfg, jnp.asarray(toks),
                             impl=J_IMPL[full], remat=False)
    got = t_models.forward_scanned(sp, cfg, torch.as_tensor(toks),
                                   impl=full, device=CPU)
    _close(got, want, "forward_scanned", rel)
    j_slots = j_stack_cache(j_init_cache(j_cfg, 2, 16, dtype=jnp.float32),
                            j_cfg)
    slots = t_models.stack_cache(t_models.init_cache(cfg, 2, 16,
                                                     torch.float32, CPU), cfg)
    j_logits, j_slots = j_prefill_scanned(j_sp, j_cfg, jnp.asarray(toks),
                                          j_slots, impl=J_IMPL[full])
    logits, slots = t_models.prefill_scanned(sp, cfg, torch.as_tensor(toks),
                                             slots, impl=full, device=CPU)
    _close(logits, j_logits, "prefill_scanned", rel)
    for step in range(3):
        tok = np.array(jnp.argmax(j_logits, -1))
        j_logits, j_slots = j_decode_scanned(j_sp, j_cfg, jnp.asarray(tok),
                                             j_slots, impl=J_IMPL[impl])
        logits, slots = t_models.decode_step_scanned(
            sp, cfg, torch.as_tensor(tok), slots, impl=impl, device=CPU)
        _close(logits, j_logits, f"decode_step_scanned {step}", rel)
    for j, (a, b) in enumerate(zip(slots, j_slots)):
        assert set(a) == set(b)
        for key in set(a) - {"len"}:
            _close(a[key], b[key], f"slot {j} {key}", rel)
        np.testing.assert_array_equal(a["len"].numpy(), np.asarray(b["len"]))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (the CPU tests above run their plain versions)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["llama3.2-3b", "mamba2-2.7b"])
def test_cuda_scanned_equals_unscanned(cuda_device, name):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, counts = _scanned_vs_unscanned(name, "kernel", cuda_device)
    kernel = "ssd_scan" if cfg.mixer == "mamba" else "flash_attention"
    launches = [c[1] for c in counts]
    assert launches[0][kernel] == cfg.n_layers
    assert all(c.get(f"{kernel}:plain", 0) == 0 for c, _ in counts)
    if cfg.mixer == "attn":
        assert all(lc["decode_attention"] == cfg.n_layers
                   for lc in launches[1:])


def test_stacked_copy_is_freed_without_the_garbage_collector():
    """Dropping a StackedParams frees its stacked tensors at once (no
    reference cycle keeps them until a collection): at full width the
    copy is ~11 GB of the card."""
    import gc
    import weakref

    cfg, params = _model("llama3.2-3b")
    sp = t_models.stack_params(params, cfg)
    assert sum(1 for _ in sp.layers().parameters()) == \
        sum(1 for _ in sp.parameters())
    ref = weakref.ref(sp.slots[0]["attn.wq.w"])
    enabled = gc.isenabled()
    gc.disable()
    try:
        del sp
        assert ref() is None
    finally:
        if enabled:
            gc.enable()
