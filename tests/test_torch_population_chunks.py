"""The port's population split over devices (the JAX package's population
sharding: ``resolve_mesh``, ``pad_population``, ``_sharded_pass``): a
population evaluated in chunks, one per device, equals the one-device
result bit for bit, through both evaluators, ``timing_matrix``,
``pass_ab_inputs`` and a seeded ``search_mapping`` / ``explore``. On this
host the devices are the CPU repeated; on a card, ``cuda:0`` repeated."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import torch_evaluator as t_eval
from repro_torch.core.compass import (
    CoSearchConfig,
    Scenario,
    explore,
    search_mapping,
)
from repro_torch.core.encoding import pipeline_parallel, random_encoding
from repro_torch.core.evaluator import CostTables
from repro_torch.core.ga import GAConfig
from repro_torch.core.hardware import make_hardware
from repro_torch.core.objectives import GoodputUnderSLO
from repro_torch.core.streams import RequestStream
from repro_torch.core.traces import TraceDistribution
from repro_torch.core.workload import (
    LLMSpec,
    build_execution_graph,
    decode_request,
    prefill_request,
)

SPEC = LLMSpec("chunks", 256, 4, 4, 64, 1024, 1000, 8)
SMALL = TraceDistribution("small", mean_input=48, mean_output=12, max_len=256)
BACKENDS = ("dense", "kernel", "fused")


def _hw():
    hw = make_hardware(64, "M", layout=None, tensor_parallel=2)
    return hw.replace(layout=tuple(["WS", "OS"] * (hw.n_chiplets // 2)))


def _group(hw):
    """Two batches of one structure (a group of B 2)."""
    batches = [[prefill_request(128), decode_request(300)],
               [prefill_request(96), decode_request(80)]]
    graphs = [build_execution_graph(SPEC, b, micro_batch_size=2, tp=2,
                                    n_blocks=2) for b in batches]
    return graphs, [CostTables.build(g, hw) for g in graphs]


def _population(g, hw, n, seed=0):
    rng = np.random.default_rng(seed)
    pop = [pipeline_parallel(g.rows, g.n_cols, hw.n_chiplets)]
    return pop + [random_encoding(rng, g.rows, g.n_cols, hw.n_chiplets)
                  for _ in range(n - 1)]


def _equal(a, b):
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


def _assert_evaluators_equal(one, split, pop):
    for a, b in zip(one.evaluate_population(pop),
                    split.evaluate_population(pop)):
        _equal(a, b)
    tm1, tm2 = one.timing_matrix(pop), split.timing_matrix(pop)
    for f in ("op_start_s", "op_end_s", "chip_free_s"):
        _equal(getattr(tm1, f), getattr(tm2, f))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("k", [2, 3, 5])
def test_group_chunks_equal_one_device(k, backend):
    """P 7 is ragged for every k: the padded lanes are sliced off before
    any output is read, so lat / energy, the timing matrix and the kernels'
    inputs equal the one-device ones bit for bit."""
    hw = _hw()
    graphs, tables = _group(hw)
    pop = _population(graphs[0], hw, 7, seed=k)
    one = t_eval.GroupPopulationEvaluator(graphs, tables, hw,
                                          backend=backend, device="cpu")
    split = t_eval.GroupPopulationEvaluator(graphs, tables, hw,
                                            backend=backend,
                                            device=["cpu"] * k)
    assert len(split._devices) == k and len(split._statics) == 1
    _assert_evaluators_equal(one, split, pop)
    a, b = one.pass_ab_inputs(pop), split.pass_ab_inputs(pop)
    assert a["n_chips"] == b["n_chips"]
    for key in ("t_proc", "sched_idx", "chip", "ppos"):
        _equal(a[key], b[key])


@pytest.mark.parametrize("k", [2, 3, 5])
def test_population_evaluator_chunks_equal_one_device(k):
    hw = _hw()
    graphs, tables = _group(hw)
    pop = _population(graphs[1], hw, 11, seed=10 + k)
    one = t_eval.PopulationEvaluator(graphs[1], tables[1], hw,
                                     backend="dense", device="cpu")
    split = t_eval.PopulationEvaluator(graphs[1], tables[1], hw,
                                       backend="dense", device=("cpu",) * k)
    _assert_evaluators_equal(one, split, pop)
    for a, b in zip(one._run(pop, full=True), split._run(pop, full=True)):
        _equal(a, b)


def test_fewer_individuals_than_devices():
    """P 2 over 5 devices: three chunks hold only the repeated last
    individual, and the output has 2 columns."""
    hw = _hw()
    graphs, tables = _group(hw)
    pop = _population(graphs[0], hw, 2, seed=4)
    one = t_eval.GroupPopulationEvaluator(graphs, tables, hw,
                                          backend="dense", device="cpu")
    split = t_eval.GroupPopulationEvaluator(graphs, tables, hw,
                                            backend="dense",
                                            device=["cpu"] * 5)
    lat, _ = split.evaluate_population(pop)
    assert lat.shape == (2, 2)
    _assert_evaluators_equal(one, split, pop)


def test_pad_population_matches_reference():
    """The JAX package's ``pad_population`` and the port's on the same
    arrays, and the cases of ``tests/test_sharded_eval.py``."""
    pytest.importorskip("jax")
    from repro.core.jax_evaluator import pad_population as j_pad

    rng = np.random.default_rng(0)
    orders = rng.integers(0, 9, (5, 3, 2)).astype(np.int32)
    l2c = rng.integers(0, 16, (5, 2, 3)).astype(np.int32)
    for multiple in (1, 2, 3, 4, 5, 7):
        got, want = t_eval.pad_population(orders, l2c, multiple), \
            j_pad(orders, l2c, multiple)
        assert got[2] == want[2] == 5
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    o, lc, p0 = t_eval.pad_population(orders, l2c, 4)
    assert p0 == 5 and o.shape[0] == 8 and lc.shape[0] == 8
    assert np.array_equal(o[5], orders[-1]) and np.array_equal(lc[7], l2c[-1])
    o2, l2, p2 = t_eval.pad_population(orders, l2c, 5)
    assert p2 == 5 and o2 is orders and l2 is l2c


def test_resolve_devices():
    """The reference's ``resolve_mesh`` cases: no device, or more cards
    than are present, raise ``ValueError``; one device is the unsplit
    path; a sequence is taken as it is, repeats included."""
    cpu = torch.device("cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available"):
        t_eval.resolve_devices(n + 1)
    with pytest.raises(ValueError, match="available"):
        t_eval.resolve_devices(0)
    with pytest.raises(ValueError, match="at least one"):
        t_eval.resolve_devices([])
    with pytest.raises(ValueError, match="at least one"):
        t_eval.resolve_devices(())
    assert t_eval.resolve_devices("cpu") == [cpu]
    assert t_eval.resolve_devices(["cpu"]) == [cpu]
    assert t_eval.resolve_devices(["cpu"] * 3) == [cpu] * 3
    if n == 0:
        for knob in (None, "cuda"):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                t_eval.resolve_devices(knob)
    else:
        with pytest.raises(ValueError, match="available"):
            t_eval.resolve_devices(["cpu", f"cuda:{n}"])
        cards = [torch.device("cuda", i) for i in range(n)]
        assert t_eval.resolve_devices(n) == cards
        assert t_eval.resolve_devices(1) == cards[:1]
        assert t_eval.resolve_devices("cuda:0") == cards[:1]
        assert t_eval.resolve_devices(None) == [torch.device("cuda")]


def test_resolve_devices_on_several_cards(monkeypatch):
    """On a host with four cards (counted, not used): ``None`` and an
    unpinned ``"cuda"`` are one card, the unsplit path; the split over
    cards is asked for by an int or a list."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda")
    assert t_eval.resolve_devices(None) == [cuda]
    assert t_eval.resolve_devices("cuda") == [cuda]
    assert t_eval.resolve_devices(cuda) == [cuda]
    assert t_eval.resolve_devices(2) == [torch.device("cuda", 0),
                                         torch.device("cuda", 1)]
    assert t_eval.resolve_devices(["cuda:3", "cuda:3"]) == \
        [torch.device("cuda", 3)] * 2
    with pytest.raises(ValueError, match="available"):
        t_eval.resolve_devices(5)
    with pytest.raises(ValueError, match="available"):
        t_eval.resolve_devices("cuda:4")


def _search(device, **kw):
    hw = make_hardware(64, "M", tensor_parallel=2)
    batches = [[prefill_request(64), prefill_request(128)],
               [prefill_request(96), prefill_request(192)]]
    return search_mapping(SPEC, batches, hw, [2, 2],
                          GAConfig(population=9, generations=3, seed=0),
                          objective="edp", n_blocks=1, device=device, **kw)


def _assert_same_search(a, b):
    assert a.score == b.score and a.latency_s == b.latency_s
    assert a.energy_j == b.energy_j and a.ga_evaluations == b.ga_evaluations
    assert a.encodings.keys() == b.encodings.keys()
    for key in a.encodings:
        ea, eb = a.encodings[key], b.encodings[key]
        assert np.array_equal(ea.segmentation, eb.segmentation)
        assert np.array_equal(ea.layer_to_chip, eb.layer_to_chip)
    assert [r.history for r in a.ga_results] == \
        [r.history for r in b.ga_results]


@pytest.mark.parametrize("backend", ["dense", "fused"])
def test_chunked_search_mapping_equal(backend):
    """A seeded search with P 9 in 2 and 4 chunks: the same encodings,
    scores and GA history as on one device."""
    one = _search("cpu", timing_backend=backend)
    for k in (2, 4):
        _assert_same_search(one, _search(["cpu"] * k,
                                         timing_backend=backend))


def test_chunked_joint_stream_search_equal():
    """The joint co-search's ``JointStreamEvaluator`` inherits the split
    through its group evaluators."""
    st = RequestStream("chunks", trace=SMALL, rate=16.0, n_requests=24,
                       warm_fraction=0.6, max_new_tokens_cap=6, seed=3)
    sc = Scenario("chunks", SPEC, target_tops=64, stream=st,
                  scheduler="orca", n_blocks=1, max_stream_iters=24)
    ro = sc.rollout()
    hw = make_hardware(64, "M", tensor_parallel=2)
    mbs = [sc.micro_batch(hw, b) for b in ro.batches]
    obj = GoodputUnderSLO(ttft_slo_s=0.5, tpot_slo_s=0.1)
    cfg = GAConfig(population=7, generations=2, seed=1)
    out = [search_mapping(SPEC, ro.batches, hw, mbs, cfg, objective=obj,
                          n_blocks=1, stream_rollout=ro, device=dev,
                          co_search=CoSearchConfig(mode="joint"))
           for dev in ("cpu", ["cpu"] * 3)]
    _assert_same_search(*out)


def test_chunked_explore_equal():
    """``explore`` with a chunked knob prices each point serially, its
    search split: the BO history equals one device's."""
    sc = Scenario("chunks-explore", SPEC, target_tops=64, n_blocks=1,
                  stream=RequestStream.fixed_batches(
                      [[prefill_request(64), prefill_request(128)]]))
    kw = dict(bo_iters=2, bo_init=2, seed=0, bo_batch=2,
              ga_config=GAConfig(population=5, generations=2, seed=0))
    one = explore(sc, device="cpu", **kw)
    split = explore(sc, device=["cpu"] * 2, **kw)
    assert [p.key() for p in one.bo.points] == \
        [p.key() for p in split.bo.points]
    assert one.bo.scores == split.bo.scores


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BACKENDS)
def test_cuda_chunks_equal_one_card(card, backend):
    """Three chunks on ``cuda:0`` through the hand kernels: bit for bit
    the one-card result, 3 launches a call instead of 1."""
    from repro_torch.kernels import mapping_eval as me

    hw = _hw()
    graphs, tables = _group(hw)
    pop = _population(graphs[0], hw, 64 + 1, seed=7)
    one = t_eval.GroupPopulationEvaluator(graphs, tables, hw,
                                          backend=backend, device="cuda:0")
    split = t_eval.GroupPopulationEvaluator(graphs, tables, hw,
                                            backend=backend,
                                            device=["cuda:0"] * 3)
    _assert_evaluators_equal(one, split, pop)
    if backend != "dense":
        me.reset_launch_counts()
        split.evaluate_population(pop)
        assert sum(me.launch_counts().values()) == 3
