"""The port's stepped serving engine against the JAX package's engine on
the same weights (``params_from_jax``, reduced qwen1.5-0.5b as in
``tests/test_serving.py``): greedy tokens equal, and ``IterationStats``
equal field by field apart from ``seconds``, under vllm, orca and
chunked_prefill, for both of the port's impls (the JAX engine runs its
default ``xla`` path). Plus the engine's contracts that
``tests/test_serving.py`` pins for the JAX engine.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import all_archs as j_archs  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.serving import SCHEDULERS as J_SCHEDULERS  # noqa: E402
from repro.serving import ServeRequest as JServeRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core.interop import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    SCHEDULERS,
    OrcaScheduler,
    ServeRequest,
    VLLMScheduler,
)
from repro_torch.serving.engine import ServingEngine, summarize  # noqa: E402

ARCH = "qwen1.5-0.5b"
CPU = "cpu"


@functools.cache
def _model():
    j_cfg = j_archs()[ARCH].reduced()
    cfg = t_configs.get(ARCH).reduced()
    j_params = j_init_model(jax.random.PRNGKey(0), j_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, CPU)
    return j_cfg, j_params, cfg, params


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


@pytest.mark.parametrize("impl", ["eager", "kernel"])
@pytest.mark.parametrize("sched", ["vllm", "orca", "chunked_prefill"])
def test_engine_matches_jax_engine(sched, impl):
    j_cfg, j_params, cfg, params = _model()
    specs = _specs(0, 6, 5)
    j_reqs = [JServeRequest(i, list(p), m, arrived_iter=a)
              for i, (p, m, a) in enumerate(specs)]
    reqs = [ServeRequest(i, list(p), m, arrived_iter=a)
            for i, (p, m, a) in enumerate(specs)]
    j_res = JServingEngine(j_params, j_cfg, max_batch=3, max_len=64).run(
        j_reqs, _scheduler(J_SCHEDULERS, sched))
    ops.clear_dispatch_stats()
    eng = ServingEngine(params, cfg, max_batch=3, max_len=64, impl=impl,
                        device=CPU)
    res = eng.run(reqs, _scheduler(SCHEDULERS, sched))
    assert not res.truncated and len(res.finished) == 6
    assert {r.rid: r.generated for r in res.finished} == \
        {r.rid: r.generated for r in j_res.finished}
    assert [r.rid for r in res.finished] == [r.rid for r in j_res.finished]
    for got, want in zip(res.finished, j_res.finished):
        assert (got.first_token_iter, got.done_iter) == \
            (want.first_token_iter, want.done_iter)
    assert _stats_fields(res.stats) == _stats_fields(j_res.stats)
    paths = ops.dispatch_stats()
    if impl == "kernel":
        n_decode = sum(1 for s in res.stats if s.n_decode)
        assert paths == {"decode_attention:plain": n_decode * cfg.n_layers}
    else:
        assert paths == {}


def test_all_requests_complete_and_summarize():
    _, _, cfg, params = _model()
    eng = ServingEngine(params, cfg, max_batch=3, max_len=64, device=CPU)
    reqs = [ServeRequest(i, p, 6) for i, (p, _, _) in
            enumerate(_specs(1, 5, 6))]
    fin, stats = eng.run(reqs, OrcaScheduler())
    assert len(fin) == 5 and all(len(r.generated) == 6 for r in fin)
    s = summarize(fin, stats)
    assert s["output_tokens"] == 30 and s["unfinished"] == 0
    assert s["mean_slots_used"] > 0


def test_engine_rejects_warm_requests():
    _, _, cfg, params = _model()
    eng = ServingEngine(params, cfg, max_batch=2, max_len=64, device=CPU)
    warm = ServeRequest(0, [1] * 8, 4, prefilled=8)
    with pytest.raises(ValueError, match="warm"):
        eng.run([warm], OrcaScheduler())


def test_run_reports_unfinished_on_truncation():
    _, _, cfg, params = _model()
    eng = ServingEngine(params, cfg, max_batch=2, max_len=64, device=CPU)
    reqs = [ServeRequest(i, p, 6) for i, (p, _, _) in
            enumerate(_specs(7, 4, 6))]
    with pytest.warns(UserWarning, match="truncated"):
        res = eng.run(reqs, VLLMScheduler(), max_iters=2)
    fin, stats = res                      # the 2-tuple protocol
    assert fin is res.finished and stats is res.stats
    assert res.truncated and res.unfinished
    assert len(res.finished) + len(res.unfinished) == 4
    s = summarize(res.finished, res.stats, unfinished=res.unfinished)
    assert s["unfinished"] == len(res.unfinished)


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_reset_slot_leaves_kv_stale_but_masked(impl):
    """Slot reset clears only the live length — the K/V contents stay
    stale, and length masking makes that invisible: tokens from a poisoned
    cache equal tokens from a fresh one."""
    _, _, cfg, params = _model()
    prompts = [np.random.default_rng(11).integers(0, cfg.vocab,
                                                  size=9).tolist()
               for _ in range(2)]

    def run(poison):
        eng = ServingEngine(params, cfg, max_batch=2, max_len=64, impl=impl,
                            device=CPU)
        if poison:
            for layer in eng.cache:
                layer["k"].fill_(7.7e4)
                layer["v"].fill_(-3.3e4)
        reqs = [ServeRequest(i, list(p), 4) for i, p in enumerate(prompts)]
        fin, _ = eng.run(reqs, VLLMScheduler())
        return {r.rid: r.generated for r in fin}

    assert run(poison=True) == run(poison=False)


def test_engine_refuses_what_it_cannot_serve():
    _, _, cfg, params = _model()
    with pytest.raises(ValueError, match="max_seq"):
        ServingEngine(params, cfg, max_len=cfg.max_seq + 1, device=CPU)
    with pytest.raises(ValueError, match="impl"):
        ServingEngine(params, cfg, max_len=64, impl="pallas", device=CPU)


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--device", "cpu", "--requests", "2", "--max-new",
                       "3", "--scheduler", "chunked_prefill"]) == 0
    out = capsys.readouterr().out
    assert '"requests": 2' in out and '"output_tokens": 6' in out
