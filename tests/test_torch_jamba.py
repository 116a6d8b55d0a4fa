"""jamba-v0.1-52b's own layer pattern in the port, against the JAX package
on identical weights (``params_from_jax``) and inputs, on the CPU.

Every other jamba test of the port runs ``ArchConfig.reduced()``, which
puts attention on every fourth layer. Here a narrow config is cut from
jamba's published ``ModelConfig`` with ``dataclasses.replace`` that keeps
its pattern and head geometry: 8 layers (one period), attention only at
layer 4 (``attn_every`` 8, GQA Hq 4 over Hkv 1 at head_dim 128: rep 4, as
32 / 8), Mamba-2 at the other seven with P 128 and N 16 (jamba's 8,192 /
64 heads and its state), MoE of 16 experts top 2 on every odd layer
(``moe_every`` 2) and a dense gated FFN on every even one; ``layer_period``
8. Each Mamba layer's decay (``a_log``, ``dt_bias``) is seeded, in the
JAX tree before it is carried across, so that no two heads share one.

* the port's plain SSD at (B 2, L 70, H 2, P 128, N 16) against the JAX
  package's Pallas ``ssd_scan`` in interpret mode (1e-4, as
  ``tests/test_kernels.py`` holds the kernel);
* ``forward``, ``prefill`` and 3 ``decode_step``s (logits and every cache
  tensor), ``prefill_scanned`` and 3 ``decode_step_scanned`` steps at
  period 8: ``impl="eager"`` against JAX ``impl="xla"`` and
  ``impl="kernel"`` (the kernels' plain versions on the CPU) against JAX
  ``impl="pallas"`` (interpret mode), within ``REL`` (2e-5, ROADMAP F5;
  the float64 reading beside it says why) of the largest reference
  value; the scanned paths equal the port's unscanned ones bit for bit, and a kernel ``prefill`` dispatches 1 flash and 7 SSD plain
  versions;
* the orca engine's greedy tokens and iteration stats equal the JAX
  engine's, on both impl pairs;
* on the card (``cuda`` marker), the narrow pattern through the kernels:
  scanned equals unscanned bit for bit, each ``prefill`` 1
  ``flash_attention`` and 7 ``ssd_scan`` launches, each decode step 1
  ``decode_attention`` launch, and no plain dispatch.

This file imports JAX only inside the tests that compare with it, so its
card test runs where JAX is not installed.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import stacked  # noqa: E402
from repro_torch.models.transformer import MoECfg  # noqa: E402

ARCH = "jamba-v0.1-52b"
IMPLS = (("eager", "xla"), ("kernel", "pallas"))
# Of the largest |reference value|: 2e-5, ROADMAP F5's bound, not 1e-5.
# The packages differ only in the order of their float32 sums: run in
# float64 (throwaway copies of both), they agree to 1.0e-13 of the largest
# logit on every unscanned path, impl and token seed tried. In float32
# each block is as close to float64 in the port as in the reference (4e-7
# to 9e-7 of its update, on the same input), and aligning the seven Mamba
# layers' chunked sums with the reference's leaves the largest gap as it
# was; but the stack amplifies the rounding (at layer 2 one row of the
# gated RMSNorm's input has an rms of 0.06: ROADMAP F6's mechanism), so
# over 5 token seeds the port's logits land a median 6.8e-6 (at most
# 5.0e-5) of the largest from float64 and the reference's 5.3e-6 (3.6e-5),
# the reference as often the farther one (``tools/scan_int8_gaps.py
# --float64``, ROADMAP F5). At these inputs the largest gaps are 1.45e-5
# (``forward``, eager), 1.26e-5 (``forward``, kernel) and 1.13e-5
# (``prefill_scanned``, kernel); every other comparison is within 1e-5.
REL = 2e-5
CPU = "cpu"
# the narrow pattern's fields, on top of jamba's published config
NARROW = dict(name="jamba-v0.1-52b-narrow", vocab=256, d_model=64,
              n_layers=8, n_heads=4, n_kv_heads=1, head_dim=128, d_ff=96,
              moe_every=2, attn_every=8, d_inner=256, ssm_state=16,
              mamba_heads=2, max_seq=256)
NARROW_MOE = dict(n_routed=16, n_shared=0, top_k=2, d_expert=32)
N_ATTN, N_MAMBA = 1, 7


def _narrow(model, moe_cls):
    return dataclasses.replace(model, moe=moe_cls(**NARROW_MOE), **NARROW)


def _port_config():
    return _narrow(t_configs.get(ARCH).model, MoECfg)


def _seeded_decay_tree(tree, seed=0):
    """The JAX tree with every Mamba layer's ``a_log`` and ``dt_bias``
    drawn from ``seed`` (numpy), in place of the initialiser's zeros."""
    rng = np.random.default_rng(seed)
    for blk in tree["blocks"]:
        if "mamba" in blk:
            h = blk["mamba"]["a_log"].shape[0]
            blk["mamba"]["a_log"] = (0.5 * rng.standard_normal(h)).astype(
                np.float32)
            blk["mamba"]["dt_bias"] = (0.5 * rng.standard_normal(h)
                                       - 1.0).astype(np.float32)
    return tree


@functools.cache
def _pair():
    """(JAX cfg, JAX params, port cfg, port params): one weight set (the
    JAX package's ``init_model`` with seeded decay) in both packages."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import all_archs as j_archs
    from repro.models import init_model as j_init_model
    from repro.models.transformer import MoECfg as JMoECfg
    from repro_torch.core.interop import params_from_jax

    j_cfg = _narrow(j_archs()[ARCH].model, JMoECfg)
    cfg = _port_config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)
    tree = _seeded_decay_tree(jax.tree.map(
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
        assert set(tc) == set(jc), (what, i, set(tc), set(jc))
        for key in sorted(set(tc) - {"len"}):
            _close(tc[key], jc[key], f"{what} layer/slot {i} {key}")
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def _same_caches(layers, slots, cfg, what):
    unstacked = t_models.unstack_cache(slots, cfg)
    assert len(unstacked) == len(layers) == cfg.n_layers
    for i, (a, b) in enumerate(zip(layers, unstacked)):
        assert set(a) == set(b), (what, i)
        for key in a:
            assert torch.equal(a[key], b[key]), (what, i, key)


def _want_prefill(impl, plain):
    """A ``prefill``'s dispatches: 1 flash and 7 SSD under the kernel impl
    (the plain versions on the CPU), none eagerly."""
    if impl != "kernel":
        return {}
    route = "plain" if plain else "cuda"
    return {f"flash_attention:{route}": N_ATTN, f"ssd_scan:{route}": N_MAMBA}


# --------------------------------------------------------------------------
# the pattern
# --------------------------------------------------------------------------


def test_narrow_config_keeps_jambas_pattern():
    """The narrow config's layer kinds are jamba's first period, in the
    port as in the JAX package: attention at layer 4 alone, MoE on every
    odd layer; period 8; the Mamba heads P 128, N 16 and the attention
    rep 4 of the published config."""
    pytest.importorskip("jax")
    from repro.models.stacked import layer_period as j_layer_period

    j_cfg, _, cfg, _ = _pair()
    full = t_configs.get(ARCH).model
    kinds = [(cfg.mixer_kind(i), cfg.ffn_kind(i)) for i in range(8)]
    assert kinds == [(full.mixer_kind(i), full.ffn_kind(i))
                     for i in range(8)]
    assert kinds == [(j_cfg.mixer_kind(i), j_cfg.ffn_kind(i))
                     for i in range(8)]
    assert [i for i, (m, _) in enumerate(kinds) if m == "attn"] == [4]
    assert [i for i, (_, f) in enumerate(kinds) if f == "moe"] == [1, 3, 5, 7]
    assert stacked.layer_period(cfg) == j_layer_period(j_cfg) == 8
    assert stacked.layer_period(full) == 8
    assert cfg.d_inner // cfg.mamba_heads == full.d_inner // full.mamba_heads
    assert cfg.ssm_state == full.ssm_state == 16
    assert cfg.n_heads // cfg.n_kv_heads == full.n_heads // full.n_kv_heads
    assert cfg.head_dim == full.head_dim == 128


def test_plain_ssd_matches_pallas_at_jambas_heads():
    """The port's plain SSD against the JAX Pallas kernel (interpret mode)
    at P 128, N 16: two chunks of 64 (the CUDA kernel's chunk) and the
    default 128, a ragged L."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as j_ops

    b, l, h, p, n = 2, 70, 2, 128, 16
    rng = np.random.default_rng(70)
    arrays = (rng.normal(size=(b, l, h, p)).astype(np.float32),
              rng.uniform(0.01, 0.2, size=(b, l, h)).astype(np.float32),
              -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
              rng.normal(size=(b, l, n)).astype(np.float32),
              rng.normal(size=(b, l, n)).astype(np.float32))
    for chunk in (ss.KERNEL_CHUNK, ss.DEFAULT_CHUNK):
        j_y, j_s = j_ops.ssd_scan(*(jnp.asarray(a) for a in arrays),
                                  chunk=chunk, interpret=True)
        y, s = ss.ssd_scan_plain(*(torch.as_tensor(a) for a in arrays),
                                 chunk=chunk)
        assert tuple(y.shape) == (b, l, h, p) and tuple(s.shape) == (b, h, n,
                                                                    p)
        for got, want in ((y, j_y), (s, j_s)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# model paths
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl,j_impl", IMPLS)
def test_paths_match_jax(impl, j_impl):
    """``forward``, ``prefill`` and 3 greedy ``decode_step``s: logits and
    every cache tensor within REL of the JAX package's."""
    import jax.numpy as jnp
    from repro.models import decode_step as j_decode
    from repro.models import forward as j_forward
    from repro.models import init_cache as j_init_cache
    from repro.models import prefill as j_prefill

    j_cfg, j_params, cfg, params = _pair()
    toks = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, 13))
    _close(t_models.forward(params, cfg, torch.as_tensor(toks), impl=impl,
                            device=CPU),
           j_forward(j_params, j_cfg, jnp.asarray(toks), impl=j_impl),
           "forward logits")
    j_cache = j_init_cache(j_cfg, 2, 32, dtype=jnp.float32)
    cache = t_models.init_cache(cfg, 2, 32, torch.float32, CPU)
    j_logits, j_cache = j_prefill(j_params, j_cfg, jnp.asarray(toks),
                                  j_cache, impl=j_impl)
    ops.clear_dispatch_stats()
    logits, cache = t_models.prefill(params, cfg, torch.as_tensor(toks),
                                     cache, impl=impl, device=CPU)
    assert ops.dispatch_stats() == _want_prefill(impl, plain=True)
    _close(logits, j_logits, "prefill logits")
    _caches_close(cache, j_cache, "prefill")
    for step in range(3):
        tok = np.array(jnp.argmax(j_logits, -1))
        j_logits, j_cache = j_decode(j_params, j_cfg, jnp.asarray(tok),
                                     j_cache, impl=j_impl)
        ops.clear_dispatch_stats()
        logits, cache = t_models.decode_step(params, cfg, torch.as_tensor(tok),
                                             cache, impl=impl, device=CPU)
        assert ops.dispatch_stats() == (
            {"decode_attention:plain": N_ATTN} if impl == "kernel" else {})
        _close(logits, j_logits, f"decode step {step} logits")
        _caches_close(cache, j_cache, f"decode step {step}")


@pytest.mark.parametrize("impl,j_impl", IMPLS)
def test_scanned_matches_jax_and_unscanned(impl, j_impl):
    """At period 8 (one step of eight slots): ``prefill_scanned`` and 3
    ``decode_step_scanned`` steps within REL of the JAX package's scanned
    entry points (each package stacking its own tree), and bit for bit the
    port's unscanned ``prefill`` and ``decode_step``."""
    import jax.numpy as jnp
    from repro.models import init_cache as j_init_cache
    from repro.models.stacked import stack_cache as j_stack_cache
    from repro.models.stacked import stack_params as j_stack_params
    from repro.models.transformer import (
        decode_step_scanned as j_decode_scanned,
        prefill_scanned as j_prefill_scanned,
    )

    j_cfg, j_params, cfg, params = _pair()
    j_sp = j_stack_params(j_params, j_cfg)
    sp = t_models.stack_params(params, cfg)
    assert (sp.period, sp.n_steps) == (8, 1)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, size=(2, 11))
    j_slots = j_stack_cache(j_init_cache(j_cfg, 2, 24, dtype=jnp.float32),
                            j_cfg)
    slots = t_models.stack_cache(t_models.init_cache(cfg, 2, 24,
                                                     torch.float32, CPU), cfg)
    cache = t_models.init_cache(cfg, 2, 24, torch.float32, CPU)
    j_logits, j_slots = j_prefill_scanned(j_sp, j_cfg, jnp.asarray(toks),
                                          j_slots, impl=j_impl)
    ops.clear_dispatch_stats()
    s_logits, slots = t_models.prefill_scanned(
        sp, cfg, torch.as_tensor(toks), slots, impl=impl, device=CPU)
    assert ops.dispatch_stats() == _want_prefill(impl, plain=True)
    logits, cache = t_models.prefill(params, cfg, torch.as_tensor(toks),
                                     cache, impl=impl, device=CPU)
    assert torch.equal(s_logits, logits)
    _same_caches(cache, slots, cfg, "prefill")
    _close(s_logits, j_logits, "prefill_scanned logits")
    for step in range(3):
        tok = np.array(jnp.argmax(j_logits, -1))
        j_logits, j_slots = j_decode_scanned(j_sp, j_cfg, jnp.asarray(tok),
                                             j_slots, impl=j_impl)
        s_logits, slots = t_models.decode_step_scanned(
            sp, cfg, torch.as_tensor(tok), slots, impl=impl, device=CPU)
        logits, cache = t_models.decode_step(params, cfg, torch.as_tensor(tok),
                                             cache, impl=impl, device=CPU)
        assert torch.equal(s_logits, logits), f"decode step {step}"
        _same_caches(cache, slots, cfg, f"decode step {step}")
        _close(s_logits, j_logits, f"decode_step_scanned {step} logits")
    _caches_close(slots, j_slots, "scanned slots")


@pytest.mark.parametrize("impl,j_impl", IMPLS)
def test_engine_matches_jax_engine(impl, j_impl):
    """The orca engine's greedy tokens and iteration stats equal the JAX
    engine's at the same impl pair; under the kernel impl each decode
    iteration dispatches the decode plain version once (the one attention
    layer) and nothing else (prompts go through ``extend``)."""
    from repro.serving import SCHEDULERS as J_SCHEDULERS
    from repro.serving import ServeRequest as JServeRequest
    from repro.serving import ServingEngine as JServingEngine
    from repro_torch.serving import SCHEDULERS, ServeRequest, ServingEngine

    j_cfg, j_params, cfg, params = _pair()
    rng = np.random.default_rng(4)
    specs = [(rng.integers(0, cfg.vocab, size=int(rng.integers(5, 30)))
              .tolist(), 5, i // 2) for i in range(6)]
    j_res = JServingEngine(j_params, j_cfg, max_batch=3, max_len=64,
                           impl=j_impl).run(
        [JServeRequest(i, list(p), m, arrived_iter=a)
         for i, (p, m, a) in enumerate(specs)], J_SCHEDULERS["orca"]())
    ops.clear_dispatch_stats()
    res = ServingEngine(params, cfg, max_batch=3, max_len=64, impl=impl,
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
        {"decode_attention:plain": n_decode * N_ATTN}
        if impl == "kernel" else {})


def test_smoke_lane_state_keeps_mamba_states():
    """chip_smoke's engine-lane replay (``_lane_state``) on the narrow
    pattern: every lane's cache, Mamba states included, equals that lane's
    prompt run alone through ``extend`` (padded to its bucket), and its
    logits those of that run."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    cfg = _port_config()
    params = t_models.init_model(cfg, seed=2, device=CPU)
    rng = np.random.default_rng(3)
    streams = {rid: (rng.integers(0, cfg.vocab, size=n).tolist(), [])
               for rid, n in enumerate(rng.integers(3, 20, size=8))}
    logits, cache = chip_smoke._lane_state(params, cfg, streams, "eager",
                                           CPU)
    for lane, rid in enumerate(sorted(streams)):
        prompt = streams[rid][0]
        toks = torch.zeros((1, 1 << (len(prompt) - 1).bit_length()),
                           dtype=torch.long)
        toks[0, :len(prompt)] = torch.as_tensor(prompt)
        one = t_models.init_cache(cfg, 1, chip_smoke.SERVE_MAX_LEN,
                                  torch.float32, CPU)
        want, one = t_models.extend(params, cfg, toks, one, impl="eager",
                                    length=len(prompt), device=CPU)
        assert torch.equal(logits[lane], want[0])
        for i, (layer, ref) in enumerate(zip(cache, one)):
            for key, t in ref.items():
                assert torch.equal(layer[key][lane:lane + 1], t), (lane, i,
                                                                   key)
        assert bool(cache[0]["state"][lane].abs().sum() > 0)


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
def test_cuda_pattern_scanned_equals_unscanned(cuda_device):
    """The narrow pattern (seeded weights and decay) through the kernels:
    ``prefill`` and ``prefill_scanned`` launch 1 flash and 7 SSD kernels
    each and dispatch no plain version; 4 greedy decode steps launch the
    decode kernel once each; scanned equals unscanned bit for bit."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _port_config()
    params = t_models.init_model(cfg, seed=3, device=cuda_device)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for blk in params.blocks:
            if hasattr(blk, "mamba"):
                h = blk.mamba.a_log.shape[0]
                blk.mamba.a_log.copy_(torch.randn(h, generator=gen) * 0.5)
                blk.mamba.dt_bias.copy_(torch.randn(h, generator=gen) * 0.5
                                        - 1.0)
    sp = t_models.stack_params(params, cfg)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, 100)), device=cuda_device)
    cache = t_models.init_cache(cfg, 2, 128, torch.float32, cuda_device)
    slots = t_models.stack_cache(t_models.init_cache(
        cfg, 2, 128, torch.float32, cuda_device), cfg)
    want = {"flash_attention": N_ATTN, "ssd_scan": N_MAMBA}
    ops.clear_dispatch_stats()
    ops.reset_launch_counts()
    logits, cache = t_models.prefill(params, cfg, toks, cache, impl="kernel",
                                     device=cuda_device)
    torch.cuda.synchronize()
    assert {k: n for k, n in ops.launch_counts().items() if n} == want
    assert ops.dispatch_stats() == _want_prefill("kernel", plain=False)
    ops.clear_dispatch_stats()
    ops.reset_launch_counts()
    s_logits, slots = t_models.prefill_scanned(sp, cfg, toks, slots,
                                               impl="kernel",
                                               device=cuda_device)
    torch.cuda.synchronize()
    assert {k: n for k, n in ops.launch_counts().items() if n} == want
    assert torch.equal(s_logits, logits)
    _same_caches(cache, slots, cfg, "prefill")
    for step in range(4):
        tok = torch.argmax(logits, -1)
        ops.clear_dispatch_stats()
        ops.reset_launch_counts()
        logits, cache = t_models.decode_step(params, cfg, tok, cache,
                                             impl="kernel",
                                             device=cuda_device)
        s_logits, slots = t_models.decode_step_scanned(
            sp, cfg, tok, slots, impl="kernel", device=cuda_device)
        torch.cuda.synchronize()
        assert {k: n for k, n in ops.launch_counts().items() if n} == \
            {"decode_attention": 2 * N_ATTN}
        assert ops.dispatch_stats() == {"decode_attention:cuda": 2 * N_ATTN}
        assert torch.equal(s_logits, logits), f"decode step {step}"
        _same_caches(cache, slots, cfg, f"decode step {step}")
    assert torch.isfinite(logits).all()
