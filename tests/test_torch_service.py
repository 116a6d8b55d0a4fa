"""The port's paged KV residency and async serving service against the JAX
package's (twins of ``tests/test_paged_cache.py`` and
``tests/test_service_parity.py``), on reduced qwen1.5-0.5b with the JAX
weights carried across by ``params_from_jax``, on the CPU.

* the block allocator's invariants, the transfer-buffer pool, and the
  gather of a block pool equal to dense slicing bit for bit;
* the paged model paths (``paged_extend`` then ``paged_decode``) equal the
  dense ``extend`` / ``decode_step`` bit for bit, and write back into the
  pools exactly the rows the dense cache holds;
* under ``IterationClock`` the service's admission log, batches and
  ``RequestTimings`` equal ``plan_rollout`` bit for bit for vllm, orca and
  chunked_prefill; its greedy tokens equal the port's ``ServingEngine`` and
  the JAX ``AsyncLLMService`` for ``golden_parity_stream``, and its
  iteration stats and counters equal the JAX service's;
* block exhaustion queues and does not corrupt, stale pools are reused,
  truncation is reported, the warm mixed stream keeps parity, and a
  reduced mamba2 service (slot state) gives the port's engine's tokens.

One serve per scheduler per package is made once and shared.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import all_archs as j_archs  # noqa: E402
from repro.models import init_model as j_init_model  # noqa: E402
from repro.serving import SCHEDULERS as J_SCHEDULERS  # noqa: E402
from repro.serving import AsyncLLMService as JAsyncLLMService  # noqa: E402
from repro.serving import ServiceConfig as JServiceConfig  # noqa: E402
from repro.serving.service import service_requests as j_service_requests  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core.interop import params_from_jax  # noqa: E402
from repro_torch.core.streams import (  # noqa: E402
    RequestStream,
    StreamRequest,
    rollout,
)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import decode_step, extend, init_cache  # noqa: E402
from repro_torch.models.paged import (  # noqa: E402
    NULL_BLOCK,
    gather_paged_cache,
    init_paged_pools,
    paged_decode,
    paged_extend,
)
from repro_torch.serving import (  # noqa: E402
    SCHEDULERS,
    AsyncLLMService,
    BlockAllocator,
    PagedKVCache,
    ServeRequest,
    ServiceConfig,
    ServingEngine,
    TransferBufferPool,
    WallClock,
    golden_parity_stream,
    service_requests,
)
from repro_torch.serving.scheduler import plan_rollout  # noqa: E402

ARCH = "qwen1.5-0.5b"
CPU = "cpu"
STREAM = golden_parity_stream()
SCHED_NAMES = ["vllm", "orca", "chunked_prefill"]
MAX_BATCH, MAX_LEN = 3, 64


@functools.cache
def _model():
    j_cfg = j_archs()[ARCH].reduced()
    cfg = t_configs.get(ARCH).reduced()
    j_params = j_init_model(jax.random.PRNGKey(0), j_cfg)
    params = params_from_jax(jax.tree.map(np.asarray, j_params), cfg, CPU)
    return j_cfg, j_params, cfg, params


def _sched(name, table=SCHEDULERS):
    return (table[name](chunk=8) if name == "chunked_prefill"
            else table[name]())


def _fresh_requests():
    return service_requests(STREAM, _model()[2].vocab)


def _service(**config):
    _, _, cfg, params = _model()
    kw = dict(max_batch=MAX_BATCH, max_len=MAX_LEN, block_len=16)
    kw.update(config)
    return AsyncLLMService(params, cfg, ServiceConfig(**kw), device=CPU)


def _tokens(finished):
    return {r.rid: r.generated for r in finished}


def _stats_fields(stats):
    return [{k: v for k, v in dataclasses.asdict(s).items()
             if k != "seconds"} for s in stats]


@pytest.fixture(scope="module")
def served():
    """One deterministic-clock serve per scheduler through the port's
    service, counting the attention paths each took."""
    out = {}
    for name in SCHED_NAMES:
        ops.clear_dispatch_stats()
        res = _service().serve_sync(_fresh_requests(), _sched(name),
                                    stream_name=STREAM.name)
        out[name] = (res, ops.dispatch_stats())
    return out


@pytest.fixture(scope="module")
def served_jax():
    """The same serves through the JAX package's service (its ``xla``
    path)."""
    j_cfg, j_params, _, _ = _model()
    out = {}
    for name in SCHED_NAMES:
        svc = JAsyncLLMService(
            j_params, j_cfg,
            JServiceConfig(max_batch=MAX_BATCH, max_len=MAX_LEN,
                           block_len=16))
        out[name] = svc.serve_sync(j_service_requests(STREAM, j_cfg.vocab),
                                   _sched(name, J_SCHEDULERS),
                                   stream_name=STREAM.name)
    return out


# --------------------------------------------------------------------------
# allocator, buffers, pools (tests/test_paged_cache.py)
# --------------------------------------------------------------------------


def _check_invariants(alloc: BlockAllocator):
    owned = []
    for blocks in alloc.owners().values():
        owned.extend(blocks)
    assert len(owned) == len(set(owned)), "block owned twice"
    assert NULL_BLOCK not in owned, "null block handed out"
    assert set(owned) | set(alloc._free) == set(range(1, alloc.num_blocks))
    assert len(owned) + alloc.blocks_free == alloc.capacity


@given(seed=st.integers(0, 10_000), num_blocks=st.integers(2, 40),
       block_len=st.integers(1, 32))
@settings(max_examples=40, deadline=None)
def test_allocator_random_walk_invariants(seed, num_blocks, block_len):
    rng = np.random.default_rng(seed)
    alloc = BlockAllocator(num_blocks, block_len)
    live: list[int] = []
    next_rid = 0
    for _ in range(60):
        if live and (rng.random() < 0.4 or alloc.blocks_free == 0):
            alloc.free(live.pop(int(rng.integers(len(live)))))
        else:
            demand = int(rng.integers(0, 3 * block_len + 1))
            could = alloc.can_reserve(demand)
            ok = alloc.reserve(next_rid, demand)
            assert ok == could
            if ok:
                assert len(alloc.table(next_rid)) == alloc.blocks_for(demand)
                live.append(next_rid)
            next_rid += 1
        _check_invariants(alloc)
    for rid in live:
        alloc.free(rid)
    assert alloc.blocks_free == alloc.capacity


@given(num_blocks=st.integers(2, 30), block_len=st.integers(1, 16),
       demand=st.integers(1, 200))
@settings(max_examples=40, deadline=None)
def test_admission_blocks_at_exhaustion(num_blocks, block_len, demand):
    alloc = BlockAllocator(num_blocks, block_len)
    need = alloc.blocks_for(demand)
    filler = []
    rid = 0
    while alloc.blocks_free >= need:
        assert alloc.reserve(rid, block_len)
        filler.append(rid)
        rid += 1
    before_free, before_oom = alloc.blocks_free, alloc.oom_events
    assert not alloc.can_reserve(demand)
    assert alloc.reserve(999, demand) is False
    assert alloc.oom_events == before_oom + 1
    assert alloc.blocks_free == before_free
    assert 999 not in alloc.owners()
    _check_invariants(alloc)
    freed = 0
    while freed < need and filler:
        freed += alloc.free(filler.pop())
    if freed >= need:
        assert alloc.reserve(999, demand) is True
        _check_invariants(alloc)


def test_allocator_rejects_double_reserve_and_null_config():
    alloc = BlockAllocator(8, 4)
    assert alloc.reserve(1, 4)
    with pytest.raises(ValueError, match="already holds"):
        alloc.reserve(1, 4)
    with pytest.raises(ValueError):
        BlockAllocator(1, 4)
    with pytest.raises(ValueError):
        BlockAllocator(8, 0)


@given(seed=st.integers(0, 10_000), block_len=st.sampled_from([1, 2, 4, 8]),
       t=st.integers(1, 6))
@settings(max_examples=25, deadline=None)
def test_gather_matches_dense_slicing_bitwise(seed, block_len, t):
    """Gathering a request's blocks reproduces the dense cache row bit for
    bit, and the slot rows of a recurrent layer are copied whole."""
    rng = np.random.default_rng(seed)
    num_blocks, heads, dim, n = 12, 2, 3, 2
    pool = rng.standard_normal((num_blocks, block_len, heads, dim))
    pool = pool.astype(np.float32)
    state = rng.standard_normal((4, 2, 3)).astype(np.float32)
    tables = rng.integers(0, num_blocks, size=(n, t)).astype(np.int32)
    lens = rng.integers(0, t * block_len + 1, size=(n,)).astype(np.int32)
    slots = rng.integers(0, 4, size=(n,)).astype(np.int32)
    k_pool, s_pool = torch.tensor(pool), torch.tensor(state)
    out, rec = gather_paged_cache(
        [{"k": k_pool}, {"state": s_pool}], torch.tensor(tables),
        torch.tensor(lens), torch.tensor(slots))
    dense = np.stack([np.concatenate([pool[b] for b in tables[j]], axis=0)
                      for j in range(n)])
    assert np.array_equal(out["k"].numpy(), dense)
    assert np.array_equal(out["len"].numpy(), lens)
    assert np.array_equal(rec["state"].numpy(), state[slots])
    out["k"].add_(1.0)                     # a copy: the pool is untouched
    assert np.array_equal(k_pool.numpy(), pool)


def test_transfer_buffer_pool_reuse_and_bound():
    pool = TransferBufferPool(capacity=2)
    a = pool.acquire((4,), np.int32)
    b = pool.acquire((4,), np.int32)
    assert pool.misses == 2 and pool.hits == 0
    assert a is not b
    pool.release(a)
    c = pool.acquire((4,), np.int32)
    assert c is a and pool.hits == 1
    assert pool.acquire((4, 2), np.int32).shape == (4, 2)
    for buf in (np.empty((4,), np.int32) for _ in range(3)):
        pool.release(buf)
    assert len(pool._pools[((4,), np.dtype(np.int32).str)]) == 2


def test_paged_kv_cache_validates_and_binds():
    _, _, cfg, _ = _model()
    with pytest.raises(ValueError, match="multiple of block_len"):
        PagedKVCache(cfg, max_batch=2, max_len=50, block_len=16, device=CPU)
    kv = PagedKVCache(cfg, max_batch=2, max_len=64, block_len=16, device=CPU)
    assert kv.blocks_per_seq == 4
    assert kv.allocator.capacity == 2 * 4
    assert kv.capacity_tokens() == 128
    assert kv.allocator.reserve(7, 33)
    kv.bind(0, 7)
    row = kv.tables_np[0]
    assert (row[:3] > 0).all() and (row[3:] == 0).all()
    assert kv.lens_np[0] == 0
    kv.release(0, 7)
    assert (kv.tables_np[0] == 0).all()
    assert kv.allocator.blocks_free == kv.allocator.capacity
    layer = 2 * 9 * 16 * cfg.n_kv_heads * cfg.head_dim * 4    # k, v float32
    assert kv.resident_bytes() == cfg.n_layers * layer
    assert all(t.device.type == CPU and t.dtype == torch.float32
               for p in kv.pools for t in p.values())
    half = PagedKVCache(cfg, max_batch=2, max_len=64, dtype=torch.bfloat16,
                        device=CPU)
    assert half.resident_bytes() == kv.resident_bytes() // 2


def test_bind_zeroes_only_the_slot_state_row():
    cfg = t_configs.get("mamba2-2.7b").reduced()
    kv = PagedKVCache(cfg, max_batch=2, max_len=32, block_len=16, device=CPU)
    assert kv.has_slot_state and kv.scratch_slot == 2
    state = kv.pools[0]["state"]
    assert state.shape[0] == 3                     # + the scratch row
    state.fill_(1.0)
    assert kv.allocator.reserve(5, 10)
    kv.bind(1, 5)
    assert (state[1] == 0).all()
    assert (state[0] == 1).all() and (state[2] == 1).all()


def test_service_rejects_max_len_past_the_rope_tables():
    _, _, cfg, _ = _model()
    with pytest.raises(ValueError, match="max_seq"):
        _service(max_len=cfg.max_seq + 16)


def test_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    _, _, cfg, params = _model()
    for call in (lambda: PagedKVCache(cfg, 2, 64),
                 lambda: init_paged_pools(cfg, 2, 9, 16),
                 lambda: AsyncLLMService(params, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# --------------------------------------------------------------------------
# paged model paths against the dense ones
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["eager", "kernel"])
def test_paged_paths_equal_dense_paths_bitwise(impl):
    """Prompts of 19 and 30 tokens as chunks of 5 right-padded to 8 (so
    chunks straddle block edges: the write-back window needs its extra
    block) then three batched decode steps with a padding lane, through
    the paged paths and through ``extend`` / ``decode_step`` on a dense
    cache of the same width: logits' argmax equal, and the pools hold,
    through the block tables, exactly the dense cache's live rows (the
    padding lane's writes land in the null block and the scratch slot
    only)."""
    _, _, cfg, params = _model()
    bl, t, n_blocks = 16, 4, 9
    pools = init_paged_pools(cfg, 2, n_blocks, bl, device=CPU)
    tables = torch.tensor([[3, 7, NULL_BLOCK, NULL_BLOCK],
                           [5, 1, 2, NULL_BLOCK]], dtype=torch.int32)
    dense = init_cache(cfg, 2, t * bl, torch.float32, CPU)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (19, 30)]
    last = []
    for slot, prompt in enumerate(prompts):
        off = 0
        while off < len(prompt):
            chunk = prompt[off:off + 5]
            buf = torch.zeros(8, dtype=torch.int32)
            buf[:len(chunk)] = torch.tensor(chunk)
            tok, pools = paged_extend(params, cfg, buf, pools, tables[slot],
                                      off, slot, len(chunk), bl, impl=impl,
                                      device=CPU)
            row = [{k: v[slot:slot + 1] for k, v in layer.items()}
                   for layer in dense]
            logits, row = extend(params, cfg, buf[None].long(), row,
                                 impl=impl, length=len(chunk), device=CPU)
            for layer, r in zip(dense, row):
                layer["len"][slot:slot + 1] = r["len"]
            assert int(tok) == int(torch.argmax(logits, -1)[0])
            off += len(chunk)
        last.append(int(tok))
    lens = torch.tensor([19, 30, 0], dtype=torch.int32)
    pad_tables = torch.cat([tables, torch.zeros((1, t), dtype=torch.int32)])
    slots = torch.tensor([0, 1, 2], dtype=torch.int32)
    toks = torch.tensor(last + [0], dtype=torch.int32)
    for _ in range(3):
        got, pools = paged_decode(params, cfg, toks, pools, pad_tables, lens,
                                  slots, bl, impl=impl, device=CPU)
        logits, dense = decode_step(params, cfg, toks[:2].long(), dense,
                                    impl=impl, device=CPU)
        want = torch.argmax(logits, -1)
        assert torch.equal(got[:2], want)
        toks = torch.cat([want.int(), torch.zeros(1, dtype=torch.int32)])
        lens = lens + torch.tensor([1, 1, 0], dtype=torch.int32)
    view = gather_paged_cache(pools, tables, lens[:2], slots[:2])
    for got_layer, want_layer in zip(view, dense):
        for j in range(2):
            n = int(lens[j])
            for k in ("k", "v"):
                assert torch.equal(got_layer[k][j, :n], want_layer[k][j, :n])


# --------------------------------------------------------------------------
# the service (tests/test_service_parity.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", SCHED_NAMES)
def test_measured_rollout_matches_planned_bitwise(served, name):
    res, _ = served[name]
    assert not res.truncated and not res.unfinished
    ro = rollout(STREAM, _sched(name), max_slots=MAX_BATCH, max_iters=10_000)
    assert res.rollout.batches == ro.batches
    np.testing.assert_array_equal(res.rollout.arrival_b, ro.arrival_b)
    np.testing.assert_array_equal(res.rollout.first_b, ro.first_b)
    np.testing.assert_array_equal(res.rollout.done_b, ro.done_b)
    np.testing.assert_array_equal(res.rollout.n_new_tokens, ro.n_new_tokens)
    lat = np.linspace(0.01, 0.02, len(ro.batches))
    planned, measured = ro.timings(lat), res.timings(lat)
    np.testing.assert_array_equal(planned.ttft_s, measured.ttft_s)
    np.testing.assert_array_equal(planned.tpot_s, measured.tpot_s)
    np.testing.assert_array_equal(planned.finished, measured.finished)
    assert planned.makespan_s == measured.makespan_s


@pytest.mark.parametrize("name", SCHED_NAMES)
def test_admission_log_matches_plan_rollout(served, name):
    reqs = [ServeRequest(r.rid, list(r.prompt), r.max_new_tokens,
                         arrived_iter=r.arrived_iter)
            for r in _fresh_requests()]
    planned = []
    for it, plan in plan_rollout(reqs, _sched(name), MAX_BATCH, 10_000):
        for req, _ in plan.prefill:
            if req.prefilled == 0:
                planned.append((req.rid, req.slot, it))
    assert served[name][0].admissions == planned


@pytest.mark.parametrize("name", SCHED_NAMES)
def test_tokens_match_dense_engine_and_decode_paths(served, name):
    """Greedy tokens equal the port's dense engine's; every decode step
    went once per layer through the decode-attention wrapper (its plain
    version on the CPU) and nothing else dispatched."""
    res, disp = served[name]
    _, _, cfg, params = _model()
    eng = ServingEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        device=CPU)
    fin, _ = eng.run(_fresh_requests(), _sched(name))
    assert _tokens(fin) == _tokens(res.finished)
    n_decode = sum(1 for s in res.stats if s.n_decode)
    assert disp == {"decode_attention:plain": n_decode * cfg.n_layers}


@pytest.mark.parametrize("name", SCHED_NAMES)
def test_tokens_stats_and_counters_match_jax_service(served, served_jax,
                                                     name):
    res, _ = served[name]
    want = served_jax[name]
    assert _tokens(res.finished) == _tokens(want.finished)
    assert [r.rid for r in res.finished] == [r.rid for r in want.finished]
    assert res.admissions == want.admissions
    assert _stats_fields(res.stats) == _stats_fields(want.stats)
    assert res.counters == want.counters


def test_chunks_across_block_edges_match_dense_engine():
    """Chunked prefill in chunks of 5 (buckets of 8, offsets 5, 10, 15,
    ...) over 16-token blocks: every chunk's K/V lands through the block
    window, so the tokens equal the dense engine's."""
    _, _, cfg, params = _model()

    def sched():
        return SCHEDULERS["chunked_prefill"](chunk=5)

    res = _service().serve_sync(_fresh_requests(), sched())
    eng = ServingEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                        device=CPU)
    fin, _ = eng.run(_fresh_requests(), sched())
    assert len(res.finished) == STREAM.n_requests
    assert _tokens(fin) == _tokens(res.finished)


def test_block_exhaustion_queues_not_corrupts(served):
    res = _service(num_blocks=5).serve_sync(
        _fresh_requests(), _sched("vllm"), stream_name=STREAM.name)
    assert not res.truncated
    assert len(res.finished) == STREAM.n_requests
    assert sum(s.blocked_admissions for s in res.stats) > 0
    assert max(s.blocks_used for s in res.stats) <= 4
    assert _tokens(res.finished) == _tokens(served["vllm"][0].finished)
    assert len(res.stats) >= len(served["vllm"][0].stats)


def test_service_reuse_over_stale_pools():
    svc = _service()
    first = svc.serve_sync(_fresh_requests(), _sched("vllm"),
                           stream_name=STREAM.name)
    again = svc.serve_sync(_fresh_requests(), _sched("vllm"),
                           stream_name=STREAM.name)
    assert _tokens(again.finished) == _tokens(first.finished)


def test_service_truncation_reports_unfinished():
    with pytest.warns(UserWarning, match="truncated"):
        res = _service(max_iters=3).serve_sync(_fresh_requests(),
                                               _sched("vllm"))
    assert res.truncated
    assert res.unfinished
    assert len(res.finished) + len(res.unfinished) == STREAM.n_requests
    assert res.summary()["unfinished"] == len(res.unfinished)


def _warm_mixed_stream():
    reqs = [
        StreamRequest(10, 3, 0),
        StreamRequest(6, 2, 1, warm_context=9),
        StreamRequest(8, 4, 2),
        StreamRequest(5, 3, 2, warm_context=14),
    ]
    return RequestStream.from_requests(reqs, name="warm-mixed")


def test_warm_mixed_service_parity_and_warm_mask():
    stream = _warm_mixed_stream()
    res = _service().serve_sync(service_requests(stream, _model()[2].vocab),
                                _sched("orca"), stream_name=stream.name)
    assert not res.truncated and not res.unfinished
    assert res.counters["warm_requests"] == 2
    ro = rollout(stream, _sched("orca"), max_slots=MAX_BATCH,
                 max_iters=10_000)
    assert res.rollout.batches == ro.batches
    np.testing.assert_array_equal(res.rollout.warm, ro.warm)
    np.testing.assert_array_equal(res.rollout.arrival_b, ro.arrival_b)
    np.testing.assert_array_equal(res.rollout.first_b, ro.first_b)
    np.testing.assert_array_equal(res.rollout.done_b, ro.done_b)
    np.testing.assert_array_equal(res.rollout.n_new_tokens, ro.n_new_tokens)
    lat = np.linspace(0.01, 0.02, len(ro.batches))
    planned, measured = ro.timings(lat), res.timings(lat)
    np.testing.assert_array_equal(planned.ttft_s, measured.ttft_s)
    np.testing.assert_array_equal(planned.tpot_s, measured.tpot_s)
    assert measured.warm.sum() == 2
    assert measured.cold_ttft_s.shape[-1] == 2
    assert np.isfinite(measured.cold_ttft_s).all()
    wall = res.wall_timings()
    np.testing.assert_array_equal(wall.warm, ro.warm)
    assert wall.cold_ttft_s.shape[-1] == 2


def test_occupancy_stats_and_counters(served):
    res, _ = served["vllm"]
    assert all(0 <= s.slots_used <= MAX_BATCH for s in res.stats)
    assert any(s.slots_used > 1 for s in res.stats)
    assert max(s.blocks_used for s in res.stats) == \
        res.counters["blocks_peak_used"]
    assert res.counters["transfer_pool_hits"] > 0
    assert res.counters["admissions"] == STREAM.n_requests
    for b in res.counters["decode_entrypoints"]:
        assert b & (b - 1) == 0
    s = res.summary()
    assert s["requests"] == STREAM.n_requests
    assert s["mean_slots_used"] > 0
    from repro_torch.core.observability import cache_stats
    serving = cache_stats()["serving"]
    assert serving["services_started"] >= 1
    assert serving["prefill_tokens"] > 0


def test_wall_clock_service_completes():
    _, _, cfg, params = _model()
    svc = AsyncLLMService(params, cfg,
                          ServiceConfig(max_batch=MAX_BATCH, max_len=MAX_LEN),
                          clock=WallClock(period_s=0.005), device=CPU)
    res = svc.serve_sync(_fresh_requests(), _sched("vllm"))
    assert len(res.finished) == STREAM.n_requests
    wt = res.wall_timings()
    assert wt.finished.all()
    assert np.isfinite(wt.ttft_s).all() and (wt.ttft_s >= 0).all()
    assert wt.makespan_s > 0


def test_mamba_service_matches_engine():
    """Recurrent (slot-state) layers ride the paged service too: tokens
    equal the port's dense engine's on reduced mamba2 (weights from the
    JAX package's initialiser)."""
    j_cfg = j_archs()["mamba2-2.7b"].reduced()
    cfg = t_configs.get("mamba2-2.7b").reduced()
    params = params_from_jax(jax.tree.map(
        np.asarray, j_init_model(jax.random.PRNGKey(0), j_cfg)), cfg, CPU)
    reqs = service_requests(STREAM, cfg.vocab)[:4]
    svc = AsyncLLMService(params, cfg,
                          ServiceConfig(max_batch=2, max_len=MAX_LEN),
                          device=CPU)
    res = svc.serve_sync([ServeRequest(r.rid, list(r.prompt),
                                       r.max_new_tokens,
                                       arrived_iter=r.arrived_iter)
                          for r in reqs], _sched("orca"))
    eng = ServingEngine(params, cfg, max_batch=2, max_len=MAX_LEN,
                        device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fin, _ = eng.run(reqs, _sched("orca"))
    assert len(res.finished) == 4
    assert _tokens(fin) == _tokens(res.finished)


def test_cold_passes_block_starved_warm_head():
    res = _service(num_blocks=4).serve_sync([
        ServeRequest(0, list(range(20)), 4, arrived_iter=0),
        ServeRequest(1, list(range(40)), 3, prefilled=40, arrived_iter=1),
        ServeRequest(2, list(range(8)), 2, arrived_iter=2),
    ], _sched("orca"))
    assert not res.truncated and len(res.finished) == 3
    admitted = {rid: it for rid, _slot, it in res.admissions}
    assert admitted[2] < admitted[1], res.admissions
    assert sum(s.blocked_admissions for s in res.stats) > 0
    assert res.counters["warm_requests"] == 1
