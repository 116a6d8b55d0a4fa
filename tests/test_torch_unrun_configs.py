"""The three configurations that chip_smoke runs whole on the card —
glm4-9b, qwen2-1.5b and deepseek-moe-16b — held to the JAX package at
their own head ratios and MoE shape, narrow, on the CPU.

``ArchConfig.reduced()`` cuts every GQA model to Hq 4 over Hkv 2 and
every MoE to 8 experts, top 2, so the reduced tests never see GQA rep 16
(glm4-9b: Hq 32, Hkv 2), rep 6 (qwen2-1.5b: Hq 12, Hkv 2, which no
4-head group divides) with its QKV bias, or top-6-of-64 routing with its
capacity ``int(T * 6 / 64 * 1.25) + 1`` (deepseek-moe-16b). Here each
config is cut from its published ``ModelConfig`` with
``dataclasses.replace``: 2 layers, d_model 128, the config's own
``n_heads`` / ``n_kv_heads`` at head_dim 32, and for deepseek-moe-16b
its own 64 routed experts, 2 shared, top 6, at d_expert 32. The weights
come from the JAX package's initialiser through ``params_from_jax``; the
QKV biases (zero there) are drawn from a seed first, so that they reach
the kernel path.

* ``forward``, ``prefill``, a right-padded ``extend`` and 4 greedy
  ``decode_step``s: logits and caches within 1e-5 of the largest
  reference value, ``impl="eager"`` against JAX ``impl="xla"`` and
  ``impl="kernel"`` (the kernels' plain versions on the CPU) against JAX
  ``impl="pallas"`` (interpret mode), with the plain dispatches counted;
* deepseek-moe-16b's orca engine: greedy tokens and iteration stats equal
  to the JAX engine's at the same lanes (routing follows the batch,
  ROADMAP R3 d), on both impl pairs;
* chip_smoke's constants for its whole-model runs: each parameter count
  equal to ``param_count`` of the port's ``Transformer`` on the meta
  device, and each run's reckoned float32 peak below 80 GB;
* chip_smoke's ``_routes_forced``, which puts a reference path on the
  kernel path's MoE routing where a near tie flipped it: bit for bit the
  path's own routing where the two agree, the recorded choices where they
  differ, each difference recorded.
"""
import dataclasses
import functools
import os
import sys

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
from repro.models.transformer import MoECfg as JMoECfg  # noqa: E402
from repro.models.transformer import extend as j_extend  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.core.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import MoECfg  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

ARCHS = ("glm4-9b", "qwen2-1.5b", "deepseek-moe-16b")
# each config's (Hq, Hkv) and MoE as published, kept by the narrow cut
HEADS = {"glm4-9b": (32, 2), "qwen2-1.5b": (12, 2), "deepseek-moe-16b": (16, 16)}
IMPLS = (("eager", "xla"), ("kernel", "pallas"))
REL = 1e-5
CPU = "cpu"
NARROW = dict(vocab=512, d_model=128, n_layers=2, head_dim=32, d_ff=256,
              max_seq=256)
NARROW_MOE = dict(n_routed=64, n_shared=2, top_k=6, d_expert=32)
DECODE_STEPS = 4
PEAK_LIMIT = 80e9                  # bytes: an H100's 80 GB


def _narrow(model, moe_cls):
    kw = dict(NARROW, name=model.name + "-narrow")
    if model.moe is not None:
        kw["moe"] = moe_cls(**NARROW_MOE)
    return dataclasses.replace(model, **kw)


def _seeded_bias_tree(tree, seed=0):
    """The JAX tree with every attention projection's bias drawn from
    ``seed`` (numpy, N(0, 0.25)) in place of the initialiser's zeros."""
    rng = np.random.default_rng(seed)
    for blk in tree["blocks"]:
        for name in ("wq", "wk", "wv"):
            proj = blk["attn"][name]
            if "b" in proj:
                proj["b"] = (0.5 * rng.standard_normal(proj["b"].shape)
                             ).astype(np.float32)
    return tree


@functools.cache
def _pair(arch):
    """(JAX cfg, JAX params, port cfg, port params): one weight set (the
    JAX package's ``init_model`` with seeded QKV biases) in both
    packages."""
    j_cfg = _narrow(j_archs()[arch].model, JMoECfg)
    cfg = _narrow(t_configs.get(arch).model, MoECfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    tree = _seeded_bias_tree(jax.tree.map(
        np.asarray, j_init_model(jax.random.PRNGKey(0), j_cfg)))
    params = params_from_jax(tree, cfg, CPU)
    return j_cfg, jax.tree.map(jnp.asarray, tree), cfg, params


def _close(got, want, what, rel=REL):
    got = got.detach().float().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (what, err, np.abs(want).max())


def _caches_close(t_cache, j_cache, what):
    for i, (tc, jc) in enumerate(zip(t_cache, j_cache)):
        for key in ("k", "v"):
            _close(tc[key], jc[key], f"{what} layer {i} {key}")
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def test_narrow_configs_keep_the_published_heads_and_moe():
    """The narrow cut keeps rep 16, rep 6 with QKV bias, and 64 routed
    experts top 6 with 2 shared on every layer; the seeded biases are
    nonzero in the port's model."""
    for arch in ARCHS:
        _, _, cfg, params = _pair(arch)
        full = t_configs.get(arch).model
        assert (cfg.n_heads, cfg.n_kv_heads) == HEADS[arch] == \
            (full.n_heads, full.n_kv_heads)
        assert cfg.qkv_bias == full.qkv_bias == (arch == "qwen2-1.5b")
        if cfg.qkv_bias:
            assert all(bool(b.attn.wk.b.abs().min() > 0)
                       for b in params.blocks)
    moe = _pair("deepseek-moe-16b")[2].moe
    full = t_configs.get("deepseek-moe-16b").model
    assert (moe.n_routed, moe.n_shared, moe.top_k) == \
        (full.moe.n_routed, full.moe.n_shared, full.moe.top_k) == (64, 2, 6)
    cfg = _pair("deepseek-moe-16b")[2]
    assert [cfg.ffn_kind(i) for i in range(cfg.n_layers)] == ["moe", "moe"]


@pytest.mark.parametrize("impl,j_impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_paths_match_jax(arch, impl, j_impl):
    """``forward``, ``prefill`` (2 x 13), a padded ``extend`` (5 tokens in
    a bucket of 8) and 4 greedy decode steps: logits and caches within REL
    of the JAX package's; under the kernel impl a prefill dispatches the
    flash plain version once per layer and a decode step the decode plain
    version once per layer."""
    j_cfg, j_params, cfg, params = _pair(arch)
    n = cfg.n_layers
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, size=(2, 13))
    _close(t_models.forward(params, cfg, torch.as_tensor(toks), impl=impl,
                            device=CPU),
           j_forward(j_params, j_cfg, jnp.asarray(toks), impl=j_impl),
           "forward logits")

    j_cache = j_init_cache(j_cfg, 2, 40, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 2, 40, dtype=torch.float32, device=CPU)
    j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache,
                                  impl=j_impl)
    ops.clear_dispatch_stats()
    logits, cache = t_models.prefill(params, cfg, torch.as_tensor(toks), cache,
                                     impl=impl, device=CPU)
    assert ops.dispatch_stats() == (
        {"flash_attention:plain": n} if impl == "kernel" else {})
    _close(logits, j_logits, "prefill logits")
    _caches_close(cache, j_cache, "prefill")

    more = np.concatenate([rng.integers(0, cfg.vocab, size=(2, 5)),
                           np.zeros((2, 3), np.int64)], axis=1)
    j_logits, j_cache = j_extend(j_params, j_cfg, jnp.asarray(more), j_cache,
                                 impl=j_impl, length=jnp.asarray(5))
    logits, cache = t_models.extend(params, cfg, torch.as_tensor(more), cache,
                                    impl=impl, length=5, device=CPU)
    _close(logits, j_logits, "extend logits")
    _caches_close(cache, j_cache, "extend")

    for step in range(DECODE_STEPS):
        tok = np.array(jnp.argmax(j_logits, -1))
        j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok),
                                     j_cache, impl=j_impl)
        ops.clear_dispatch_stats()
        logits, cache = t_models.decode_step(params, cfg, torch.as_tensor(tok),
                                             cache, impl=impl, device=CPU)
        assert ops.dispatch_stats() == (
            {"decode_attention:plain": n} if impl == "kernel" else {})
        _close(logits, j_logits, f"decode step {step} logits")
        _caches_close(cache, j_cache, f"decode step {step}")
    assert cache[0]["len"].tolist() == [18 + DECODE_STEPS] * 2


@pytest.mark.parametrize("impl,j_impl", IMPLS)
def test_moe_engine_matches_jax_engine(impl, j_impl):
    """deepseek-moe-16b's orca engine: greedy tokens and iteration stats
    equal to the JAX engine's at the same lanes (top 6 of 64 at capacity
    ``int(T * 6 / 64 * 1.25) + 1`` of each call's tokens); under the
    kernel impl each decode iteration dispatches the decode plain version
    once per layer."""
    from repro.serving import SCHEDULERS as J_SCHEDULERS
    from repro.serving import ServeRequest as JServeRequest
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.serving import SCHEDULERS, ServeRequest, ServingEngine

    j_cfg, j_params, cfg, params = _pair("deepseek-moe-16b")
    rng = np.random.default_rng(4)
    specs = [(rng.integers(0, cfg.vocab, size=int(rng.integers(5, 30)))
              .tolist(), 5, i // 2) for i in range(6)]
    j_res = JServingEngine(j_params, j_cfg, max_batch=4, max_len=64,
                           impl=j_impl).run(
        [JServeRequest(i, list(p), m, arrived_iter=a)
         for i, (p, m, a) in enumerate(specs)], J_SCHEDULERS["orca"]())
    ops.clear_dispatch_stats()
    res = ServingEngine(params, cfg, max_batch=4, max_len=64, impl=impl,
                        device=CPU).run(
        [ServeRequest(i, list(p), m, arrived_iter=a)
         for i, (p, m, a) in enumerate(specs)], SCHEDULERS["orca"]())
    assert not res.truncated and len(res.finished) == 6
    assert {r.rid: r.generated for r in res.finished} == \
        {r.rid: r.generated for r in j_res.finished}

    def fields(stats):
        return [{k: v for k, v in dataclasses.asdict(s).items()
                 if k != "seconds"} for s in stats]

    assert fields(res.stats) == fields(j_res.stats)
    n_decode = sum(1 for s in res.stats if s.n_decode)
    assert ops.dispatch_stats() == (
        {"decode_attention:plain": n_decode * cfg.n_layers}
        if impl == "kernel" else {})


def test_smoke_whole_model_constants():
    """chip_smoke's whole-model table: each arch's layers and parameter
    count those of the port's ``Transformer`` on the meta device, its
    heads UNRUN_HEADS's, and its reckoned float32 peak (the weights and
    the larger of the init's temporaries and the replay's two 8-lane
    caches at the serve phase's max_len) below 80 GB with the headroom;
    sized to what the requests need, the lane caches reckon no more."""
    assert set(chip_smoke.WHOLE) == set(ARCHS)
    for arch, (n_layers, n_params) in chip_smoke.WHOLE.items():
        cfg = t_configs.get(arch).model
        meta = t_models.Transformer(cfg, device="meta")
        assert cfg.n_layers == n_layers
        assert t_models.param_count(meta) == n_params
        assert chip_smoke._meta_sizes(cfg) == (
            n_params, max(p.numel() for p in meta.parameters()))
        assert chip_smoke.UNRUN_HEADS[arch] == (cfg.n_heads, cfg.n_kv_heads,
                                                cfg.head_dim)
        full = chip_smoke._whole_peak(cfg, chip_smoke.SERVE_MAX_LEN)
        need = chip_smoke._whole_peak(cfg, chip_smoke.WHOLE_LANE_ROWS)
        assert need <= full < PEAK_LIMIT - chip_smoke.WHOLE_HEADROOM, (
            arch, full)
        assert full > 4 * n_params
    assert chip_smoke.WHOLE_LANE_ROWS >= 512 + chip_smoke.SERVE_NEW


def test_smoke_routes_forced_takes_the_recorded_choices():
    """chip_smoke's ``_routes_forced`` on the narrow deepseek-moe-16b: a
    path forced onto its own recorded routing is bit for bit the unforced
    path with no difference recorded; forced onto the routing of a model
    whose router differs, every MoE call takes the recorded top-6 sets and
    expert choices, with this path's own gates, and each difference is
    recorded with its layer and margin."""
    cfg = _narrow(t_configs.get("deepseek-moe-16b").model, MoECfg)
    params = t_models.init_model(cfg, seed=1, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab, size=(2, 24)))
    with chip_smoke._recorded_routes() as own:
        want = t_models.forward(params, cfg, toks, impl="eager", device=CPU)
    flips = []
    with chip_smoke._routes_forced(list(own), flips):
        got = t_models.forward(params, cfg, toks, impl="eager", device=CPU)
    assert torch.equal(got, want) and flips == []

    other = t_models.init_model(cfg, seed=1, device=CPU)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for blk in other.blocks:
            blk.moe.router.w.add_(0.05 * torch.randn(
                blk.moe.router.w.shape, generator=gen))
    with chip_smoke._recorded_routes() as theirs:
        t_models.forward(other, cfg, toks, impl="eager", device=CPU)
    with chip_smoke._routes_forced(list(theirs), flips):
        with chip_smoke._recorded_routes() as taken:
            got = t_models.forward(params, cfg, toks, impl="eager",
                                   device=CPU)
    assert len(taken) == len(theirs) == cfg.n_layers
    assert flips and {f["layer"] for f in flips} <= {0, 1}
    assert all(f["margin"] >= 0 for f in flips)
    # the first layer's router sees the same input in both runs: its gates
    # are this path's own, unforced
    assert torch.equal(taken[0][0], own[0][0])
    for (gates, masked, g_e, idx), (_, w_masked, _, w_idx) in zip(taken,
                                                                 theirs):
        assert torch.equal(masked > 0, w_masked > 0)
        assert torch.equal(idx, w_idx)
        assert torch.equal(g_e, masked.T.gather(1, idx))
        assert torch.equal(masked, torch.where(masked > 0, gates, 0.0)
                           / torch.where(masked > 0, gates, 0.0).sum(
                               -1, keepdim=True))
        torch.testing.assert_close(masked.sum(-1), torch.ones(len(masked)))
    assert not torch.equal(got, want)
