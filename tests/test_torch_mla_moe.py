"""The port's MLA attention and MoE FFN against the JAX package on identical
weights (``params_from_jax``) and inputs, at reduced configs, on the CPU.

* ``apply_moe`` within 1e-5 of the JAX package's on deepseek-moe-16b's and
  deepseek-v2-236b's reduced MoE (shared experts) and jamba's (none), at
  1, 4 and 24 tokens (at 4 an expert takes more tokens than chose it);
* reduced deepseek-v2-236b at its own kv_rank (32 = head_dim, where MLA's
  two scales agree) and at kv_rank 64 (where they do not),
  deepseek-moe-16b and jamba-v0.1-52b: ``forward``, ``prefill``, a padded
  ``extend`` and 4 ``decode_step``s (one with an inactive slot), logits
  and caches within 1e-5 of the largest reference value: ``impl="eager"``
  against JAX ``impl="xla"``, and ``impl="kernel"`` (the kernels' plain
  versions on the CPU) against JAX ``impl="pallas"`` (interpret mode),
  except MLA's ``forward`` and ``prefill``, which run eagerly on both
  sides: under ``impl="kernel"`` the port raises ``ValueError`` where the
  JAX package's Pallas path raises ``TypeError``;
* the decode plain version against the JAX Pallas decode at MLA's head
  shape (Hq 128, Hkv 1, D 576, k is v), and the kernel's host plan
  (``decode_plan``) at every shape;
* the port's ``ServingEngine`` against the JAX engine (greedy tokens and
  iteration stats) under vllm, orca and chunked_prefill on reduced
  deepseek-v2 and deepseek-moe-16b, and the port's ``AsyncLLMService``
  against the JAX service (tokens, batches, counters) on reduced
  deepseek-v2 under orca, its ``kv`` pools gathered and written back;
* ``params_from_jax`` and ``cache_from_jax`` on MoE and MLA trees.

The only differences are float32 sums taken in another order. MoE routing
depends on the batch (the capacity follows the token count), so every
comparison runs both packages at the same lanes.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import all_archs as j_archs  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.moe import apply_moe as j_apply_moe  # noqa: E402
from repro.models.moe import init_moe as j_init_moe  # noqa: E402
from repro.models.transformer import extend as j_extend  # noqa: E402
from repro.serving import SCHEDULERS as J_SCHEDULERS  # noqa: E402
from repro.serving import AsyncLLMService as JAsyncLLMService  # noqa: E402
from repro.serving import ServeRequest as JServeRequest  # noqa: E402
from repro.serving import ServiceConfig as JServiceConfig  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro.serving.service import service_requests as j_service_requests  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.core.interop import cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models.paged import (  # noqa: E402
    gather_paged_cache,
    init_paged_pools,
)
from repro_torch.serving import (  # noqa: E402
    SCHEDULERS,
    AsyncLLMService,
    ServeRequest,
    ServiceConfig,
    ServingEngine,
    golden_parity_stream,
    service_requests,
)

ARCHS = ("deepseek-v2-236b", "deepseek-moe-16b", "jamba-v0.1-52b")
# the models compared: each arch's reduced config, and deepseek-v2's at a
# kv_rank other than head_dim (MLA's two scales part there)
MODELS = ARCHS + ("deepseek-v2-236b@kv64",)
IMPLS = (("eager", "xla"), ("kernel", "pallas"))
REL = 1e-5
CPU = "cpu"


def _configs(name):
    """(JAX cfg, port cfg) of a reduced model."""
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


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match(arch):
    """The published configs and their reduced ones (MoE and MLA fields
    included) equal the JAX package's."""
    assert dataclasses.asdict(t_configs.get(arch).model) == \
        dataclasses.asdict(j_archs()[arch].model)
    j_cfg, cfg = _configs(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    assert [cfg.ffn_kind(i) for i in range(cfg.n_layers)] == \
        [j_cfg.ffn_kind(i) for i in range(j_cfg.n_layers)]


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def _moe_pair(arch, seed=0):
    """A reduced config's MoE parameters from the JAX initialiser, as a
    JAX tree and as the port's module."""
    j_cfg, cfg = _configs(arch)
    j_p = j_init_moe(jax.random.PRNGKey(seed), j_cfg)
    leaves = {"router.w": j_p["router"]["w"], "wi": j_p["wi"],
              "wo": j_p["wo"]}
    for key in ("shared_wi", "shared_wo"):
        if key in j_p:
            leaves[f"{key}.w"] = j_p[key]["w"]
    mod = t_moe.MoE(cfg, device=CPU)
    params = dict(mod.named_parameters())
    assert set(params) == set(leaves)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.as_tensor(np.array(leaves[name])))
    return j_cfg, j_p, cfg, mod


@pytest.mark.parametrize("n_tok", [1, 4, 24])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, n_tok):
    from repro.tuning import moe_capacity_factor
    from repro_torch import tuning

    assert tuning.moe_capacity_factor() == moe_capacity_factor()
    j_cfg, j_p, cfg, mod = _moe_pair(arch)
    assert (cfg.moe.n_shared > 0) == (arch != "jamba-v0.1-52b")
    x = np.random.default_rng(n_tok).standard_normal(
        (1, n_tok, cfg.d_model)).astype(np.float32)
    want = j_apply_moe(j_p, jnp.asarray(x), j_cfg)
    got = t_moe.apply_moe(mod, torch.as_tensor(x), cfg)
    _close(got, want, f"{arch} moe at {n_tok} tokens")
    _, masked, _, idx_e = t_moe.route(mod, torch.as_tensor(x[0]), cfg)
    cap = t_moe.expert_capacity(n_tok, cfg.moe.top_k, cfg.moe.n_routed)
    assert idx_e.shape == (cfg.moe.n_routed, cap)
    assert ((masked > 0).sum(dim=-1) == cfg.moe.top_k).all()
    if n_tok == 4:   # some expert takes tokens with gate 0
        assert ((masked > 0).sum(dim=0) < cap).any()


def test_moe_zero_gated_picks_add_nothing(monkeypatch):
    """Where an expert takes more tokens than chose it, the extra ones have
    gate 0 and add exactly 0: pointing them at other tokens (as another
    top-k might break the ties among zeros) leaves the output bit for bit
    as it was."""
    _, _, cfg, mod = _moe_pair("deepseek-moe-16b")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (1, 4, cfg.d_model)).astype(np.float32))
    y = t_moe.apply_moe(mod, x, cfg)
    _, _, g_e, _ = t_moe.route(mod, x[0], cfg)
    assert (g_e == 0).any()
    route = t_moe.route

    def elsewhere(*args, **kwargs):
        gates, masked, g, idx = route(*args, **kwargs)
        return gates, masked, g, torch.where(g == 0, (idx + 1) % x.shape[1],
                                             idx)

    monkeypatch.setattr(t_moe, "route", elsewhere)
    assert torch.equal(t_moe.apply_moe(mod, x, cfg), y)


# --------------------------------------------------------------------------
# model paths
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl,j_impl", IMPLS)
@pytest.mark.parametrize("name", MODELS)
def test_serving_paths_match_jax(name, impl, j_impl):
    j_cfg, j_params, cfg, params = _model(name)
    mla = cfg.attn_kind == "mla"
    full_impl, full_j_impl = ("eager", "xla") if mla else (impl, j_impl)
    rng = np.random.default_rng(len(name))
    toks = rng.integers(0, cfg.vocab, size=(2, 12))
    ops.clear_dispatch_stats()

    want = j_forward(j_params, j_cfg, jnp.asarray(toks), impl=full_j_impl)
    got = t_models.forward(params, cfg, torch.as_tensor(toks),
                           impl=full_impl, device=CPU)
    _close(got, want, "forward logits")

    j_cache = j_init_cache(j_cfg, 2, 32, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 2, 32, dtype=torch.float32, device=CPU)
    _caches_close(cache, j_cache, "init")
    j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache,
                                  impl=full_j_impl)
    logits, cache = t_models.prefill(params, cfg, torch.as_tensor(toks), cache,
                                     impl=full_impl, device=CPU)
    _close(logits, j_logits, "prefill logits")
    _caches_close(cache, j_cache, "prefill")

    # a right-padded chunk: 5 true tokens in a bucket of 8
    more = np.concatenate([rng.integers(0, cfg.vocab, size=(2, 5)),
                           np.zeros((2, 3), np.int64)], axis=1)
    j_logits, j_cache = j_extend(j_params, j_cfg, jnp.asarray(more), j_cache,
                                 impl=j_impl, length=jnp.asarray(5))
    logits, cache = t_models.extend(params, cfg, torch.as_tensor(more), cache,
                                    impl=impl, length=5, device=CPU)
    _close(logits, j_logits, "extend logits")
    _caches_close(cache, j_cache, "extend")

    # 4 decode steps, the first with the second slot inactive
    for step in range(4):
        active = np.array([True, step > 0])
        tok = np.array(jnp.argmax(j_logits, -1))
        j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok),
                                     j_cache, impl=j_impl,
                                     active=jnp.asarray(active))
        logits, cache = t_models.decode_step(
            params, cfg, torch.as_tensor(tok), cache, impl=impl,
            active=torch.as_tensor(active), device=CPU)
        _close(logits, j_logits, f"decode step {step} logits")
        _caches_close(cache, j_cache, f"decode step {step}")
    assert cache[-1]["len"].tolist() == [21, 20]

    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.mixer_kind(i) == "attn")
    n_mamba = cfg.n_layers - n_attn
    want_paths = {}
    if impl == "kernel":
        want_paths["decode_attention:plain"] = 4 * n_attn
        if not mla:
            want_paths["flash_attention:plain"] = 2 * n_attn
        if n_mamba:
            want_paths["ssd_scan:plain"] = 2 * n_mamba
    assert ops.dispatch_stats() == want_paths


def test_mla_scales_follow_the_reference():
    """At kv_rank 64 the full-sequence paths (scale 1/sqrt(hd + rd)) and
    the latent paths (1/sqrt(r + rd)) part, in the port as in the JAX
    package; at the reduced kv_rank (32 = head_dim) they agree."""
    gaps = {}
    for name in ("deepseek-v2-236b", "deepseek-v2-236b@kv64"):
        cfg = dataclasses.replace(_configs(name)[1], moe=None)
        p = t_models.init_model(cfg, seed=1, device=CPU)
        toks = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab, size=(1, 10)))
        full = t_models.forward(p, cfg, toks, device=CPU)[:, -1]
        cache = t_models.init_cache(cfg, 1, 16, torch.float32, CPU)
        last, _ = t_models.extend(p, cfg, toks, cache, impl="eager",
                                  device=CPU)
        gaps[name] = float((full - last).abs().max() / full.abs().max())
    assert gaps["deepseek-v2-236b"] < REL < gaps["deepseek-v2-236b@kv64"]


@pytest.mark.parametrize("path", ["forward", "prefill"])
def test_mla_full_sequence_kernel_path_raises(path):
    """MLA's q/k head dim (hd + rd) differs from its v head dim (hd): the
    JAX package's Pallas flash path raises ``TypeError``; the port refuses
    ``impl="kernel"`` with a ``ValueError`` before any work, and counts no
    dispatch."""
    j_cfg, j_params, cfg, params = _model("deepseek-v2-236b")
    toks = np.zeros((1, 8), np.int64)
    j_cache = j_init_cache(j_cfg, 1, 16, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 1, 16, dtype=torch.float32, device=CPU)
    with pytest.raises(TypeError):
        if path == "forward":
            j_forward(j_params, j_cfg, jnp.asarray(toks), impl="pallas")
        else:
            j_prefill(j_params, j_cfg, jnp.asarray(toks), j_cache,
                      impl="pallas")
    ops.clear_dispatch_stats()
    with pytest.raises(ValueError, match="one head dim"):
        if path == "forward":
            t_models.forward(params, cfg, torch.as_tensor(toks),
                             impl="kernel", device=CPU)
        else:
            t_models.prefill(params, cfg, torch.as_tensor(toks), cache,
                             impl="kernel", device=CPU)
    assert ops.dispatch_stats() == {}
    assert not cache[0]["kv"].any() and not cache[0]["len"].any()


def test_flash_refuses_a_v_head_dim_unlike_q():
    q = torch.zeros((1, 2, 4, 48))
    with pytest.raises(ValueError, match="one head dim"):
        ops.flash_attention(q, q, torch.zeros((1, 2, 4, 32)))


# --------------------------------------------------------------------------
# the decode kernel at MLA's head shape
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_decode_plain_matches_pallas_at_mla_shape(dtype, tol):
    """B 2, Hq 128, Hkv 1, D 576, S 96, k and v one tensor: the plain
    version in one range and under the kernel's plan against the Pallas
    kernel (interpret mode)."""
    b, hq, s, d = 2, 128, 96, 576
    rng = np.random.default_rng(576)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kv = rng.standard_normal((b, s, 1, d)).astype(np.float32)
    lens = np.array([37, 96], np.int32)
    jt = getattr(jnp, dtype)
    want = np.asarray(j_ops.decode_attention(
        jnp.asarray(q, jt), jnp.asarray(kv, jt), jnp.asarray(kv, jt),
        jnp.asarray(lens), block_s=64, interpret=True), np.float32)
    tq, tkv = (torch.as_tensor(a).to(getattr(torch, dtype)) for a in (q, kv))
    plan = da.decode_plan(b, hq, 1, s, d, tq.dtype, tkv.dtype, 132, True)
    assert (plan.hpb, plan.n_hg) == (4, 32)
    for n_split in (1, plan.n_split):
        got = da.decode_attention_plain(tq, tkv, tkv, torch.as_tensor(lens),
                                        n_split=n_split)
        assert got.dtype == tq.dtype and tuple(got.shape) == (b, hq, d)
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)


# every shape the kernel took before head groups (rep x D <= 4096): the
# card tests' shapes, llama3.2-3b's and phi-3-vision's decode, and the
# reduced configs' (Hq 4 over Hkv 2 or 4 or MLA's 1, D 32 or 48)
PRE_GROUP_SHAPES = [(2, 8, 2, 257, 64), (1, 4, 4, 96, 32), (3, 4, 1, 130, 64),
                    (8, 24, 8, 1024, 128), (8, 24, 8, 8192, 128),
                    (7, 8, 2, 8192, 64), (5, 6, 2, 20, 32),
                    (6, 4, 1, 300, 64), (8, 32, 32, 1024, 96),
                    (528, 32, 32, 8192, 32), (2, 4, 1, 96, 48),
                    (3, 64, 1, 50, 64), (1, 512, 1, 40, 8),
                    (2, 8, 1, 64, 512)]
TYPE_PAIRS = [(torch.float32, torch.float32),
              (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.float32)]


def _old_limit_holds(hq, hkv, d, kv_dtype, shared):
    """The kernel's limit before head groups: rep x D <= 4096, and all
    rep heads' q rows with the K/V ring within 227 KB."""
    return hq // hkv * d <= 4096 and \
        da.smem_bytes(hq // hkv, d, kv_dtype, shared) <= da.MAX_SMEM


@pytest.mark.parametrize("q_dtype,kv_dtype", TYPE_PAIRS)
def test_decode_plan_keeps_every_earlier_shape(q_dtype, kv_dtype):
    """Wherever one block held all of a kv group's heads, the plan is one
    head group of all rep heads and exactly the split plan of the kernel
    without head groups."""
    for n_sm in (132, 114):
        for b, hq, hkv, s, d in PRE_GROUP_SHAPES:
            for shared in (False, True):
                if not _old_limit_holds(hq, hkv, d, kv_dtype, shared):
                    continue
                plan = da.decode_plan(b, hq, hkv, s, d, q_dtype, kv_dtype,
                                      n_sm, shared)
                assert (plan.hpb, plan.n_hg) == (hq // hkv, 1)
                assert (plan.n_split, plan.split_len) == \
                    da.split_plan(b, hkv, s, n_sm)
                assert plan.grid == (b * hkv, plan.n_split)


@pytest.mark.parametrize("q_dtype,kv_dtype", TYPE_PAIRS)
@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (8, 128, 1, 1024, 576), (8, 128, 1, 8192, 576), (2, 6, 1, 96, 576),
    (2, 16, 2, 100, 576), (1, 128, 1, 64, 256), (3, 96, 2, 500, 128)])
def test_decode_plan_head_groups(b, hq, hkv, s, d, q_dtype, kv_dtype):
    """Past one block's limit: a multiple of 4 heads per block (4 at
    D 576, in either type), every head of every kv group covered once,
    shared bytes within 227 KB, and the split plan counting every head
    group's blocks. A float32 cache with separate K and V tensors does not
    fit at D 576 at all, and is refused."""
    rep = hq // hkv
    if kv_dtype == torch.float32 and d == 576:
        with pytest.raises(ValueError, match="separate K and V"):
            da.decode_plan(b, hq, hkv, s, d, q_dtype, kv_dtype, 132)
    for shared in (True, False):
        if kv_dtype == torch.float32 and d == 576 and not shared:
            continue
        plan = da.decode_plan(b, hq, hkv, s, d, q_dtype, kv_dtype, 132,
                              shared)
        assert plan.hpb % 4 == 0 and plan.hpb < rep
        assert da.heads_fit(plan.hpb, d, kv_dtype, shared)
        assert not da.heads_fit(plan.hpb + 4, d, kv_dtype, shared)
        if d == 576:
            assert plan.hpb == 4
        assert plan.n_hg == -(-rep // plan.hpb)
        assert plan.smem_bytes <= da.MAX_SMEM
        assert plan.smem_bytes == da.smem_bytes(plan.hpb, d, kv_dtype, shared)
        assert (plan.n_split, plan.split_len) == \
            da.split_plan(b, hkv, s, 132, plan.n_hg)
        assert plan.grid == (b * hkv * plan.n_hg, plan.n_split)
        heads = [h for x in range(plan.grid[0])
                 for h in plan.heads(hq, hkv, x)]
        assert sorted(heads) == sorted(list(range(hq)) * b)
        for x in range(plan.grid[0]):
            g = (x // plan.n_hg) % hkv
            assert all(h // rep == g for h in plan.heads(hq, hkv, x))


def test_shared_kv_needs_one_tensor():
    kv = torch.zeros((2, 8, 1, 64))
    assert da.shared_kv(kv, kv)
    assert not da.shared_kv(kv, kv.clone())
    assert not da.shared_kv(kv[:, :4], kv[:, 4:])


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


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


@pytest.mark.parametrize("sched", ["vllm", "orca", "chunked_prefill"])
@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-moe-16b"])
def test_engine_matches_jax_engine(arch, sched):
    """Greedy tokens and iteration stats equal the JAX engine's (its xla
    path) through the port's kernel path: every decode iteration one
    decode-attention dispatch per layer, nothing else."""
    j_cfg, j_params, cfg, params = _model(arch)
    specs = _specs(1, 6, 5)
    j_res = JServingEngine(j_params, j_cfg, max_batch=3, max_len=64).run(
        [JServeRequest(i, list(p), m, arrived_iter=a)
         for i, (p, m, a) in enumerate(specs)],
        _scheduler(J_SCHEDULERS, sched))
    ops.clear_dispatch_stats()
    res = ServingEngine(params, cfg, max_batch=3, max_len=64,
                        device=CPU).run(
        [ServeRequest(i, list(p), m, arrived_iter=a)
         for i, (p, m, a) in enumerate(specs)],
        _scheduler(SCHEDULERS, sched))
    assert not res.truncated and len(res.finished) == 6
    assert {r.rid: r.generated for r in res.finished} == \
        {r.rid: r.generated for r in j_res.finished}
    assert _stats_fields(res.stats) == _stats_fields(j_res.stats)
    n_decode = sum(1 for s in res.stats if s.n_decode)
    assert ops.dispatch_stats() == \
        {"decode_attention:plain": n_decode * cfg.n_layers}


def test_service_matches_jax_service():
    """The paged service on reduced deepseek-v2 under orca: tokens,
    admissions, iteration stats and counters equal the JAX service's."""
    j_cfg, j_params, cfg, params = _model("deepseek-v2-236b")
    stream = golden_parity_stream()
    want = JAsyncLLMService(
        j_params, j_cfg,
        JServiceConfig(max_batch=3, max_len=64, block_len=16)).serve_sync(
        j_service_requests(stream, j_cfg.vocab),
        _scheduler(J_SCHEDULERS, "orca"), stream_name=stream.name)
    ops.clear_dispatch_stats()
    svc = AsyncLLMService(params, cfg, ServiceConfig(
        max_batch=3, max_len=64, block_len=16), device=CPU)
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


def test_paged_mla_pools_gather_and_write_back():
    """An MLA layer's pool is one ``kv`` latent pool; gathering a block
    table gives the dense rows bit for bit."""
    _, _, cfg, _ = _model("deepseek-v2-236b")
    pools = init_paged_pools(cfg, 2, 6, 4, device=CPU)
    width = cfg.mla_kv_rank + cfg.mla_rope_dim
    assert [set(layer) for layer in pools] == [{"kv"}] * cfg.n_layers
    assert tuple(pools[0]["kv"].shape) == (6, 4, 1, width)
    for layer in pools:
        layer["kv"].copy_(torch.arange(layer["kv"].numel(),
                                       dtype=torch.float32).reshape(
            layer["kv"].shape))
    tables = torch.tensor([[2, 5], [1, 0]])
    view = gather_paged_cache(pools, tables, torch.tensor([7, 3]),
                              torch.tensor([0, 1]))
    for layer, got in zip(pools, view):
        assert tuple(got["kv"].shape) == (2, 8, 1, width)
        assert torch.equal(got["kv"][0], torch.cat([layer["kv"][2],
                                                    layer["kv"][5]]))
        assert torch.equal(got["kv"][1, :4], layer["kv"][1])


# --------------------------------------------------------------------------
# interop and refusals
# --------------------------------------------------------------------------


def test_params_from_jax_carries_moe_and_mla_trees():
    """Bare ``wi``/``wo`` expert arrays beside ``Dense`` leaves, and MLA's
    projections, carry across; an extra leaf, a missing one and a wrong
    shape are refused."""
    j_cfg, j_params, cfg, params = _model("deepseek-v2-236b")
    names = dict(params.named_parameters())
    moe, r, rd = cfg.moe, cfg.mla_kv_rank, cfg.mla_rope_dim
    assert tuple(names["blocks.0.moe.wi"].shape) == \
        (moe.n_routed, cfg.d_model, 2 * moe.d_expert)
    assert tuple(names["blocks.1.moe.wo"].shape) == \
        (moe.n_routed, moe.d_expert, cfg.d_model)
    assert tuple(names["blocks.0.attn.w_dkv.w"].shape) == \
        (cfg.d_model, r + rd)
    assert {"blocks.0.moe.router.w", "blocks.0.moe.shared_wi.w",
            "blocks.0.attn.w_uk.w", "blocks.0.attn.w_uv.w"} <= set(names)
    assert not any(".ffn." in n for n in names)
    tree = jax.tree.map(np.asarray, j_params)
    np.testing.assert_array_equal(names["blocks.1.moe.wi"].numpy(),
                                  tree["blocks"][1]["moe"]["wi"])
    tree["blocks"][0]["moe"]["gate"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="only in the source"):
        params_from_jax(tree, cfg, CPU)
    tree = jax.tree.map(np.asarray, j_params)
    del tree["blocks"][1]["moe"]["wo"]
    with pytest.raises(ValueError, match="only in the port"):
        params_from_jax(tree, cfg, CPU)
    tree = jax.tree.map(np.asarray, j_params)
    tree["blocks"][0]["moe"]["wi"] = tree["blocks"][0]["moe"]["wi"][:3]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(tree, cfg, CPU)
    # jamba: MoE on the odd layers, dense FFNs on the even ones
    _, _, j_cfg, jamba = _model("jamba-v0.1-52b")
    kinds = [("moe" if hasattr(b, "moe") else "ffn") for b in jamba.blocks]
    assert kinds == [j_cfg.ffn_kind(i).replace("dense", "ffn")
                     for i in range(j_cfg.n_layers)] == \
        ["ffn", "moe", "ffn", "moe"]


def test_cache_from_jax_carries_the_latent():
    """A JAX MLA cache (``kv``) carried across continues exactly like the
    port's own; leaves of no known cache (the int8 scales) are refused."""
    j_cfg, j_params, cfg, params = _model("deepseek-v2-236b")
    toks = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 7))
    j_cache = j_init_cache(j_cfg, 2, 16, dtype=jnp.float32)
    _, j_cache = j_extend(j_params, j_cfg, jnp.asarray(toks), j_cache)
    cache = cache_from_jax(jax.tree.map(np.asarray, j_cache), CPU)
    assert [set(c) for c in cache] == [{"kv", "len"}] * cfg.n_layers
    tok = np.array([3, 4])
    j_logits, j_next = j_decode(j_params, j_cfg, jnp.asarray(tok), j_cache)
    logits, nxt = t_models.decode_step(params, cfg, torch.as_tensor(tok),
                                       cache, impl="eager", device=CPU)
    _close(logits, j_logits, "decode from a carried latent cache")
    _caches_close(nxt, j_next, "decode from a carried latent cache")
    bad = jax.tree.map(np.asarray, j_cache)
    bad[0]["kv_scale"] = np.zeros((2, 16, 1), np.float32)
    with pytest.raises(ValueError, match="leaves"):
        cache_from_jax(bad, CPU)
