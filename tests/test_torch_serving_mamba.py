"""The port's stepped serving engine on Mamba-2 and hybrid models against
the JAX package's engine on the same weights (``params_from_jax``):
reduced ``mamba2-2.7b`` and the MoE-free reduced jamba hybrid, with seeded
per-head ``a_log`` / ``dt_bias`` on both sides. Greedy tokens equal, and
``IterationStats`` equal field by field apart from ``seconds``, under
vllm, orca and chunked_prefill, for both of the port's impls (the JAX
engine runs its default ``xla`` path; each JAX run is made once per model
and scheduler). Plus the recurrent state's slot contract: a reused slot
starts from a zero state.
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
from repro.serving import SCHEDULERS as J_SCHEDULERS  # noqa: E402
from repro.serving import ServeRequest as JServeRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import models as t_models  # noqa: E402
from repro_torch.core.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import SCHEDULERS, ServeRequest, VLLMScheduler  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

CPU = "cpu"
MODELS = ("mamba2-2.7b", "hybrid")


@functools.cache
def _model(name):
    """(JAX cfg, JAX params, port cfg, port params) with seeded per-head
    decay, built once per model."""
    if name == "mamba2-2.7b":
        j_cfg, cfg = j_archs()[name].reduced(), t_configs.get(name).reduced()
    else:
        j_cfg = dataclasses.replace(j_archs()["jamba-v0.1-52b"].reduced(),
                                    moe=None)
        cfg = t_models.ModelConfig(**dataclasses.asdict(j_cfg))
    tree = jax.tree.map(np.asarray, j_init_model(jax.random.PRNGKey(1), j_cfg))
    rng = np.random.default_rng(5)
    for blk in tree["blocks"]:
        if "mamba" in blk:
            h = blk["mamba"]["a_log"].shape[0]
            blk["mamba"]["a_log"] = rng.normal(0.0, 0.5, h).astype(np.float32)
            blk["mamba"]["dt_bias"] = rng.normal(-1.0, 0.5,
                                                 h).astype(np.float32)
    return (j_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_jax(tree, cfg, CPU))


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
def _jax_run(name, sched):
    """The JAX engine's finished requests and stats, once per (model,
    scheduler)."""
    j_cfg, j_params, _, _ = _model(name)
    reqs = [JServeRequest(i, list(p), m, arrived_iter=a)
            for i, (p, m, a) in enumerate(_specs(0, 6, 5))]
    res = JServingEngine(j_params, j_cfg, max_batch=3, max_len=64).run(
        reqs, _scheduler(J_SCHEDULERS, sched))
    return ([(r.rid, list(r.generated), r.first_token_iter, r.done_iter)
             for r in res.finished], _stats_fields(res.stats))


@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("sched", ["vllm", "orca", "chunked_prefill"])
@pytest.mark.parametrize("name", MODELS)
def test_engine_matches_jax_engine(name, sched, impl):
    _, _, cfg, params = _model(name)
    j_finished, j_stats = _jax_run(name, sched)
    reqs = [ServeRequest(i, list(p), m, arrived_iter=a)
            for i, (p, m, a) in enumerate(_specs(0, 6, 5))]
    ops.clear_dispatch_stats()
    eng = ServingEngine(params, cfg, max_batch=3, max_len=64, impl=impl,
                        device=CPU)
    res = eng.run(reqs, _scheduler(SCHEDULERS, sched))
    assert not res.truncated and len(res.finished) == 6
    assert [(r.rid, r.generated, r.first_token_iter, r.done_iter)
            for r in res.finished] == j_finished
    assert _stats_fields(res.stats) == j_stats
    # prompts go through extend and never reach the SSD kernel; decode
    # reaches the attention kernel of the hybrid's attention layer only
    n_attn = sum(1 for i in range(cfg.n_layers)
                 if cfg.mixer_kind(i) == "attn")
    n_decode = sum(1 for s in res.stats if s.n_decode)
    want = {"decode_attention:plain": n_decode * n_attn} \
        if impl == "kernel" and n_attn else {}
    assert ops.dispatch_stats() == want


@pytest.mark.parametrize("name", MODELS)
def test_reused_slot_starts_from_a_zero_state(name):
    """A slot whose recurrent state is poisoned, or left over from an
    earlier request, gives the tokens of a fresh engine: admission zeroes
    the slot's state rows (and its length); stale K/V stays masked."""
    _, _, cfg, params = _model(name)
    prompts = [np.random.default_rng(11 + i).integers(0, cfg.vocab,
                                                      size=9).tolist()
               for i in range(3)]

    def run(eng, idx):
        reqs = [ServeRequest(i, list(prompts[i]), 4) for i in idx]
        fin, _ = eng.run(reqs, VLLMScheduler())
        return {r.rid: r.generated for r in fin}

    fresh = run(ServingEngine(params, cfg, max_batch=2, max_len=64,
                              device=CPU), [0, 1])
    poisoned = ServingEngine(params, cfg, max_batch=2, max_len=64,
                             device=CPU)
    for layer in poisoned.cache:
        for key, t in layer.items():
            if key != "len":
                t.fill_(3.3e3)
    assert run(poisoned, [0, 1]) == fresh
    # the same engine again: both slots now hold the last requests' states
    reused = ServingEngine(params, cfg, max_batch=2, max_len=64, device=CPU)
    run(reused, [2, 1])
    assert any(float(layer["state"].abs().max()) > 0
               for layer in reused.cache if "state" in layer)
    assert run(reused, [0, 1]) == fresh


def test_launcher_serves_mamba_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "mamba2-2.7b", "--device", "cpu",
                       "--requests", "2", "--max-new", "3", "--scheduler",
                       "chunked_prefill"]) == 0
    out = capsys.readouterr().out
    assert '"requests": 2' in out and '"output_tokens": 6' in out
