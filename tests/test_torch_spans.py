"""The port's span recorder (``repro_torch.spans``): off it records nothing
and hands out one shared object; on it nests, sums counts into the
innermost span and keeps to its own thread; it imports nothing but the
standard library; its stamps land on ``torch.profiler``'s clock; and the
spans sit where the work is: a tiny CPU mapping search records one
``ga.breed`` per generation and one evaluator triple per evaluation, and a
tiny CPU paged service over an MoE model counts the bytes its gathers
made and the expert and routed rows its MoE layers ran."""
import ast
import subprocess
import sys
import threading
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.core import observability  # noqa: E402
from repro_torch.core import timing as t_timing  # noqa: E402
from repro_torch.core.compass import search_mapping  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.core.hardware import make_hardware  # noqa: E402
from repro_torch.core.workload import LLMSpec, prefill_request  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import paged as t_paged  # noqa: E402
from repro_torch.models import transformer as t_tr  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AsyncLLMService,
    ServeRequest,
    ServiceConfig,
    get_scheduler,
)

SRC = Path(__file__).resolve().parents[1] / "src"
CPU = "cpu"


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    yield
    spans.stop()


def test_off_records_nothing_and_returns_one_shared_object():
    spans.start()
    spans.stop()
    a, b = spans.span("x"), spans.span("y", n=3)
    assert a is b
    assert not spans.active()
    with a:
        spans.add(n=1)
        with spans.span("z"):
            pass
    assert spans.summary()["spans"] == {}


def test_nesting_innermost_counts_and_summed_counts():
    with spans.recording():
        assert spans.active()
        with spans.span("outer", calls=1):
            spans.add(m=3)
            for i in range(2):
                with spans.span("inner", n=1):
                    spans.add(n=10 + i)
            spans.add(m=4)
        spans.add(lost=1)                  # no span open: dropped
    s = spans.summary()
    outer, inner = s["spans"]["outer"], s["spans"]["inner"]
    assert outer["count"] == 1 and outer["counts"] == {"calls": 1, "m": 7}
    assert inner["count"] == 2 and inner["counts"] == {"n": 23}
    (o0, o1), = outer["intervals"]
    assert all(o0 < i0 <= i1 < o1 for i0, i1 in inner["intervals"])
    assert inner["intervals"][0][1] <= inner["intervals"][1][0]
    assert s["start_ns"] <= o0 and o1 <= s["stop_ns"]
    assert outer["host_s"] == pytest.approx((o1 - o0) / 1e9)


def test_recording_turns_on_and_off_and_starts_afresh():
    with spans.span("before"):
        pass
    with spans.recording():
        with spans.span("during"):
            pass
    with spans.span("after"):
        pass
    assert set(spans.summary()["spans"]) == {"during"}
    with spans.recording():
        pass
    assert spans.summary()["spans"] == {}
    assert observability.cache_stats()["spans"] == spans.summary()


def test_spans_are_cut_where_recording_stops():
    with spans.span("opened_before"):
        spans.start()
        with spans.span("straddles"):
            with spans.span("closed_inside"):
                pass
            spans.stop()
            with spans.span("opened_after"):
                pass
    s = spans.summary()
    assert set(s["spans"]) == {"straddles", "closed_inside"}
    (t0, t1), = s["spans"]["straddles"]["intervals"]
    assert s["start_ns"] <= t0 < t1 == s["stop_ns"]


def test_other_threads_are_not_recorded():
    def work():
        with spans.span("elsewhere"):
            spans.add(n=1)

    with spans.recording():
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with spans.span("here"):
            pass
    assert set(spans.summary()["spans"]) == {"here"}


def test_spans_import_only_the_standard_library():
    tree = ast.parse((SRC / "repro_torch" / "spans.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "spans imports nothing of the port"
            names.add(node.module.split(".")[0])
    assert names <= set(sys.stdlib_module_names) | {"__future__"}, names
    code = ("import sys; import repro_torch.spans; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('torch', 'numpy', 'repro_torch', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         env={"PYTHONPATH": str(SRC), "PATH": ""})
    assert out.stdout.strip() == "['repro_torch', 'repro_torch.spans']"


def test_stamps_are_on_the_profilers_clock():
    """A span around a ``record_function`` marker holds the marker's own
    interval once moved onto the profiler's clock, within 1 ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording():
            with spans.span("around"):
                with record_function("spans_clock_marker"):
                    torch.ones(64).sum()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "spans_clock_marker"
              and e.device_type() == DeviceType.CPU]
    assert len(events) == 1
    m0 = events[0].start_ns()
    m1 = m0 + events[0].duration_ns()
    (s0, s1), = spans.summary()["spans"]["around"]["intervals"]
    tol = 1_000_000
    assert s0 - tol <= m0 <= m1 <= s1 + tol, (s0, m0, m1, s1)


def test_search_records_its_generations_and_evaluations():
    spec = LLMSpec("tiny", 512, 8, 8, 64, 2048, 32000, 8)
    hw = make_hardware(64, "M", tensor_parallel=2)
    batches = [[prefill_request(64), prefill_request(128)],
               [prefill_request(96), prefill_request(192)]]
    cfg = GAConfig(population=8, generations=4, seed=0)
    from repro_torch.core.torch_evaluator import GroupPopulationEvaluator

    calls = []
    orig = GroupPopulationEvaluator.evaluate_population

    def counted(ev, population):
        calls.append(1)
        return orig(ev, population)

    t_timing.clear_cost_caches()
    GroupPopulationEvaluator.evaluate_population = counted
    try:
        with spans.recording():
            out = search_mapping(spec, batches, hw, [2, 2], cfg,
                                 objective="edp", n_blocks=1, device=CPU)
        s = spans.summary()["spans"]
        with spans.recording():
            search_mapping(spec, batches, hw, [2, 2], cfg, objective="edp",
                           n_blocks=1, device=CPU)
        again = spans.summary()["spans"]
    finally:
        GroupPopulationEvaluator.evaluate_population = orig
    # every table built on the first search, none on the second
    assert s["search.graphs_tables"]["counts"] == {"built": len(batches)}
    assert again["search.graphs_tables"]["counts"] == {}
    calls = calls[:len(calls) // 2]
    groups = len(out.encodings)
    assert s["ga.breed"]["count"] == cfg.generations * groups
    for sub in ("ga.select", "ga.crossover", "ga.mutate"):
        assert s[sub]["count"] == s["ga.breed"]["count"]
    assert len(calls) == (cfg.generations + 1) * groups
    for part in ("evaluator.prepare", "evaluator.issue", "evaluator.readback"):
        assert s[part]["count"] == len(calls), part
    assert s["search.graphs_tables"]["count"] == 1
    assert s["search.evaluator_build"]["count"] == groups
    assert s["search.finalise"]["count"] >= 1


def test_service_counts_gather_bytes_and_expert_rows():
    cfg = t_configs.get("deepseek-moe-16b").reduced()
    params = t_tr.init_model(cfg, seed=0, device=CPU)
    gathered, moe_rows = [], []
    orig_gather, orig_moe = t_paged.gather_paged_cache, t_tr.apply_moe

    def gather(*a, **k):
        cache = orig_gather(*a, **k)
        gathered.append(sum(v.nbytes for d in cache for key, v in d.items()
                            if key != "len"))
        return cache

    def apply_moe(p, x, c, *a, **k):
        t = x.shape[0] * x.shape[1]
        m = c.moe
        cap = t_moe.expert_capacity(t, m.top_k, m.n_routed)
        moe_rows.append((m.n_routed * cap, t * m.top_k))
        return orig_moe(p, x, c, *a, **k)

    reqs = [ServeRequest(i, list(range(3 + 5 * i, 3 + 5 * i + 6 + 3 * i)), 4)
            for i in range(3)]
    svc = AsyncLLMService(params, cfg, ServiceConfig(max_batch=2, max_len=64,
                                                     block_len=16),
                          impl="eager", device=CPU)
    t_paged.gather_paged_cache, t_tr.apply_moe = gather, apply_moe
    try:
        with spans.recording():
            res = svc.serve_sync(reqs, get_scheduler("orca"))
    finally:
        t_paged.gather_paged_cache, t_tr.apply_moe = orig_gather, orig_moe
    assert len(res.finished) == 3
    s = spans.summary()["spans"]
    assert s["paged.gather"]["count"] == len(gathered) > 0
    assert s["paged.gather"]["counts"]["bytes"] == sum(gathered)
    assert s["model.moe"]["count"] == len(moe_rows) > 0
    assert s["model.moe"]["counts"] == {
        "expert_rows": sum(e for e, _ in moe_rows),
        "routed_rows": sum(r for _, r in moe_rows)}
    n_decode = sum(1 for st in res.stats if st.n_decode)
    assert s["service.decode"]["count"] == n_decode
    assert s["service.prefill_chunk"]["count"] == 3
    assert s["service.readback"]["count"] == n_decode + 3
    assert s["model.attention"]["count"] == cfg.n_layers * (n_decode + 3)
    assert s["service.iteration"]["count"] >= len(res.stats)


@pytest.mark.cuda
def test_cuda_span_holds_its_kernel_on_the_device_trace():
    """On the card: a span around ``torch.cuda._sleep`` and a synchronise
    holds the sleep kernel's interval from the CUDA trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device trace comes from the card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.recording():
            for _ in range(5):
                with spans.span("sleep"):
                    torch.cuda._sleep(1_000_000)
                    torch.cuda.synchronize()
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA)
    ivs = spans.summary()["spans"]["sleep"]["intervals"]
    assert len(kernels) == len(ivs) == 5
    for (s0, s1), (k0, k1) in zip(ivs, kernels):
        assert s0 <= k0 < k1 <= s1, (s0, k0, k1, s1)
