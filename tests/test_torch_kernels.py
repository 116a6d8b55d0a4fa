"""The port's pass-B kernels: their plain torch versions against the JAX
package's partners on identical inputs, and (on a CUDA host) the
hand-written kernels against their plain versions.

Partners and tolerances:
* ``repro.kernels.ref`` float64 numpy references — 1e-5 relative;
* the reference ``DenseTimingBackend().pass_b`` (``lax.scan``) and
  ``mapping_eval_fused_host`` (jitted XLA) — bitwise: every version does
  one exact max chain and one float32 add per step in the same order;
* fused vs gather + unfused, and kernel vs plain on the card — bitwise.
"""
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ops
from repro_torch.kernels import mapping_eval as me
from repro_torch.kernels import ref as t_ref


def _fused_case(seed, nb, pop, rows, cols, width, chips):
    """Random fused-kernel inputs: un-gathered (rows*cols)-flat cost rows,
    a random *permutation* sched_idx per individual (every cost cell used
    once, like a real schedule), random chips, random valid ppos (the
    generator of tests/test_kernels.py)."""
    rng = np.random.default_rng(seed)
    t_len = rows * cols
    t_proc = rng.uniform(0.1, 1.0, size=(nb, pop, t_len)).astype(np.float32)
    sched = np.stack([rng.permutation(t_len) for _ in range(pop)]
                     ).astype(np.int32)
    chip = rng.integers(0, chips, size=(pop, t_len)).astype(np.int32)
    ppos = np.full((pop, t_len, width), t_len, dtype=np.int32)
    for t in range(1, t_len):
        k = rng.integers(0, width + 1)
        if k:
            ppos[:, t, :k] = rng.integers(0, t, size=(pop, k))
    return t_proc, sched, chip, ppos


def _gathered(t_proc, sched):
    return np.take_along_axis(
        t_proc, np.broadcast_to(sched[None], t_proc.shape), axis=-1)


def _torch(*arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _jax_partners():
    """The JAX package's partners: its dense ``lax.scan`` pass B, its
    fused XLA program and its numpy references. Imported per test, so the
    card-only tests below also run where JAX is not installed."""
    pytest.importorskip("jax")
    from repro.core.timing import DenseTimingBackend
    from repro.kernels import ref
    from repro.kernels.mapping_eval import mapping_eval_fused_host

    return DenseTimingBackend(), mapping_eval_fused_host, ref


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (their plain versions are tested above)")
    return torch.device("cuda", 0)


CASES = list(itertools.product((1, 2, 3), (1, 3, 5)))


@pytest.mark.parametrize("grid_order", ["batch_major", "pop_major"])
@pytest.mark.parametrize("nb,pop", CASES)
def test_plain_matches_jax_partners(grid_order, nb, pop):
    j_dense, fused_host, j_ref = _jax_partners()
    chips = 4
    t_proc, sched, chip, ppos = _fused_case(nb * 10 + pop, nb, pop, rows=3,
                                            cols=5, width=2, chips=chips)
    gathered = _gathered(t_proc, sched)
    ops.clear_dispatch_stats()
    end_f, free_f = ops.mapping_eval_fused(*_torch(t_proc, sched, chip, ppos),
                                           chips, grid_order=grid_order)
    end_u, free_u = ops.mapping_eval(*_torch(gathered, chip, ppos), chips,
                                     grid_order=grid_order)
    assert ops.dispatch_stats() == {"mapping_eval_fused:plain": 1,
                                    "mapping_eval:plain": 1}
    end_f, free_f, end_u, free_u = (x.numpy() for x in
                                    (end_f, free_f, end_u, free_u))
    # fused == gather + unfused, bitwise
    np.testing.assert_array_equal(end_f, end_u)
    np.testing.assert_array_equal(free_f, free_u)
    # the reference lax.scan dense backend, bitwise
    j_end, j_free = j_dense.pass_b(gathered, chip, ppos, chips)
    np.testing.assert_array_equal(end_u, j_end)
    np.testing.assert_array_equal(free_u, j_free)
    # the reference fused XLA program, bitwise
    h_end, h_free = fused_host(t_proc, sched, chip, ppos, chips)
    np.testing.assert_array_equal(end_f, np.asarray(h_end))
    np.testing.assert_array_equal(free_f, np.asarray(h_free))
    # float64 numpy references (the JAX package's, and the port's copy)
    for refmod in (j_ref, t_ref):
        e_end, e_free = refmod.mapping_eval_fused_reference(
            t_proc, sched, chip, ppos, chips)
        np.testing.assert_allclose(end_f, e_end, rtol=1e-5)
        np.testing.assert_allclose(free_f, e_free, rtol=1e-5)
        u_end, u_free = refmod.mapping_eval_reference(gathered, chip, ppos,
                                                      chips)
        np.testing.assert_allclose(end_u, u_end, rtol=1e-5)
        np.testing.assert_allclose(free_u, u_free, rtol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_plain_random_layouts(seed):
    """Random shapes (W up to 4, sentinel-only steps, one chip) keep the
    fused == unfused == JAX dense identity."""
    j_dense, _, _ = _jax_partners()
    rng = np.random.default_rng(100 + seed)
    nb, pop = int(rng.integers(1, 4)), int(rng.integers(1, 6))
    rows, cols = int(rng.integers(1, 4)), int(rng.integers(2, 6))
    width, chips = int(rng.integers(1, 5)), int(rng.integers(1, 5))
    t_proc, sched, chip, ppos = _fused_case(seed, nb, pop, rows, cols, width,
                                            chips)
    gathered = _gathered(t_proc, sched)
    end_f, free_f = ops.mapping_eval_fused(*_torch(t_proc, sched, chip, ppos),
                                           chips)
    j_end, j_free = j_dense.pass_b(gathered, chip, ppos, chips)
    np.testing.assert_array_equal(end_f.numpy(), j_end)
    np.testing.assert_array_equal(free_f.numpy(), j_free)


def test_wrappers_route_by_device():
    t_proc, sched, chip, ppos = _fused_case(7, 2, 4, rows=2, cols=6, width=3,
                                            chips=3)
    before = me.launch_counts()
    meta = [torch.empty(a.shape, dtype=torch.as_tensor(a).dtype,
                        device="meta") for a in (t_proc, sched, chip, ppos)]
    with pytest.raises(ValueError, match="meta"):
        ops.mapping_eval_fused(*meta, 3)
    with pytest.raises(TypeError):
        ops.mapping_eval(t_proc, chip, ppos, 3)          # numpy, no tensors
    # the CUDA launchers refuse CPU tensors instead of running anything
    cpu = _torch(t_proc, sched, chip, ppos)
    with pytest.raises(ValueError, match="CUDA"):
        me.mapping_eval_fused_cuda(*cpu, 3)
    with pytest.raises(ValueError, match="CUDA"):
        me.mapping_eval_cuda(torch.as_tensor(_gathered(t_proc, sched)),
                             cpu[2], cpu[3], 3)
    with pytest.raises(ValueError, match="grid order"):
        ops.mapping_eval_fused(*cpu, 3, grid_order="bogus")
    assert me.launch_counts() == before         # nothing was launched


def test_grid_order_env(monkeypatch):
    monkeypatch.delenv("REPRO_FUSED_GRID_ORDER", raising=False)
    assert me.default_grid_order() == "batch_major"
    monkeypatch.setenv("REPRO_FUSED_GRID_ORDER", "pop_major")
    assert me.default_grid_order() == "pop_major"
    t_proc, sched, chip, ppos = _torch(*_fused_case(0, 1, 2, rows=2, cols=2,
                                                    width=1, chips=2))
    # CPU tensors never probe: the env pins the order
    assert me.autotune_grid_order(t_proc, sched, chip, ppos, 2) == "pop_major"
    monkeypatch.setenv("REPRO_FUSED_GRID_ORDER", "bogus")
    with pytest.raises(ValueError, match="REPRO_FUSED_GRID_ORDER"):
        me.default_grid_order()


def test_build_paths(monkeypatch, tmp_path):
    """The library is named by a hash of the source and lands in the build
    directory; nothing is compiled by asking for its path."""
    path = build.library_path("mapping_eval.cu")
    existed = path.exists()
    assert path.parent == build.build_dir() and path.suffix == ".so"
    assert build.build_dir() == Path(build.__file__).resolve().parents[3] / "build"
    assert path == build.library_path("mapping_eval.cu")
    assert path.exists() == existed
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
    # without a CUDA toolkit the build says so instead of failing later
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.compile_source("mapping_eval.cu")


def test_build_from_threads_compiles_once(monkeypatch, tmp_path):
    """Threads that ask for one library at once (batched BO prices a
    batch's points from a thread per card, each loading the kernels) run
    nvcc once and all get the whole library: before the per-source lock
    each ran nvcc into the same temporary file, and a card loaded a
    library while another thread rewrote it ("file too short", on four
    H100s in ``tests/test_torch_search.py::
    test_batched_bo_across_cards_matches_one_card``). Here a stand-in
    nvcc writes its output in two parts, a moment apart."""
    import threading

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'while [ "$1" != "-o" ]; do shift; done\n'
        f'echo run >> "{calls}"\n'
        'printf part1 > "$2"; sleep 0.3; printf part2 >> "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    got = []
    threads = [threading.Thread(
        target=lambda: got.append(build.compile_source("mapping_eval.cu")))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 4 and len(set(got)) == 1
    assert got[0].read_text() == "part1part2"
    assert calls.read_text().splitlines() == ["run"]
    assert not list(got[0].parent.glob("*.tmp"))


# An H100's limits: SMs, shared bytes a block may opt in to, per SM.
H100 = (132, 232448, 233472)


def _cap_t(n_batch, width, n_chips, fused, limits=H100):
    """The longest chain the shared route takes (plan by plan), with cost
    rows as long as the chain (L = T)."""
    lo, hi = 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        plan = me.row_plan(n_batch, 1, mid, width, n_chips, mid, fused,
                           *limits)
        lo, hi = (mid, hi) if plan.route == "shared" else (lo, mid - 1)
    return lo


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n_batch", [1, 3, 8])
def test_row_plan_fits_shared_memory(n_batch, fused):
    """Every plan fits an H100 block: its shared bytes are the layout's and
    at most 232,448, its threads are whole warps plus the producer, and
    its blocks cover the population."""
    for pop, t_len, width, n_chips in itertools.product(
            (1, 7, 64, 512, 2048, 4096), (1, 15, 80, 320, 3000), (1, 8, 11),
            (1, 16)):
        n_flat = t_len + 7 if fused else t_len
        plan = me.row_plan(n_batch, pop, t_len, width, n_chips, n_flat,
                           fused, *H100)
        assert plan.route == "shared"
        assert plan.smem_bytes == me.smem_bytes(
            n_batch, t_len, width, n_chips, n_flat, plan.ind_per_block,
            plan.tile, fused)
        assert plan.smem_bytes <= H100[1]
        assert plan.smem_bytes % 16 == 0
        assert plan.pairs_per_block == plan.ind_per_block * n_batch
        chain_warps = -(-plan.pairs_per_block // 32)
        assert plan.producer_warps == me.PRODUCERS * chain_warps
        assert plan.threads == 32 * (chain_warps + plan.producer_warps)
        assert plan.threads <= me.MAX_THREADS
        assert plan.tile in me.TILES
        assert 1 <= plan.ind_per_block <= pop
        assert plan.blocks == -(-pop // plan.ind_per_block)
        assert plan.blocks_per_sm >= 1


@pytest.mark.parametrize("n_batch,width,n_chips,fused",
                         [(1, 1, 2, True), (3, 8, 16, True),
                          (3, 8, 16, False), (8, 1, 2, False)])
def test_row_plan_route_switches_at_cap(n_batch, width, n_chips, fused):
    """The route turns global exactly where one individual's rows stop
    fitting at every staging tile, and nowhere before."""
    cap = _cap_t(n_batch, width, n_chips, fused)
    at = me.row_plan(n_batch, 5, cap, width, n_chips, cap, fused, *H100)
    past = me.row_plan(n_batch, 5, cap + 1, width, n_chips, cap + 1, fused,
                       *H100)
    assert at.route == "shared" and at.ind_per_block == 1
    assert at.smem_bytes <= H100[1]
    assert past.route == "global"
    assert past.pairs_per_block == past.threads == 64
    assert past.blocks == -(-n_batch * 5 // 64)
    assert all(me.smem_bytes(n_batch, cap + 1, width, n_chips, cap + 1, 1,
                             tile, fused) > H100[1] for tile in me.TILES)
    # an end row and a cost row of T floats per pair: about 29,000 / B
    # steps on an H100
    assert 25_000 < cap * n_batch < 29_100


def test_row_plan_edges():
    """T = 1, W = 1, C = 1 takes the smallest tile; a B * P that no block
    size divides leaves a partial last block; fewer SMs mean more
    individuals per block; the plan needs no device."""
    plan = me.row_plan(1, 1, 1, 1, 1, 1, True, *H100)
    assert plan == me.RowPlan("shared", 1, 1, 32 * (1 + me.PRODUCERS),
                              me.PRODUCERS, 4, plan.smem_bytes, 1,
                              plan.blocks_per_sm)
    plan = me.row_plan(3, 7, 320, 8, 16, 320, False, 2, 232448, 233472)
    assert plan.ind_per_block == 4 and plan.blocks == 2
    assert plan.ind_per_block * plan.blocks > 7
    assert plan.pairs_per_block == 12 and plan.producer_warps == me.PRODUCERS
    # the search's shape (T = L = 320): up to P 2048 all blocks in one
    # wave, the larger P taking a smaller tile first; P 4096 in two
    for fused in (False, True):
        plans = {pop: me.row_plan(3, pop, 320, 8, 16, 320, fused, *H100)
                 for pop in (64, 512, 2048, 4096)}
        for pop in (64, 512, 2048):
            assert plans[pop].blocks <= H100[0] * plans[pop].blocks_per_sm
        assert plans[2048].tile < plans[512].tile
        assert plans[4096].blocks <= 2 * H100[0] * plans[4096].blocks_per_sm


def _malform(chip, sched, n_chips, n_flat, at_chip, at_sched):
    """Copies with one chip id and one sched index out of range."""
    chip, sched = chip.copy(), sched.copy()
    chip[0, at_chip] = n_chips
    sched[0, at_sched] = n_flat
    sched[-1, at_sched] = -1
    return chip, sched


# (B, P, rows, cols, W, C): the old cases, then the search's graph (T 320,
# W 8, C 16), a T that no staging tile divides and that is not a multiple
# of 4 (so 4-byte copies), a ragged last tile with 16-byte copies, more
# than 8 predecessor lanes, T = 1, W = 1, C = 1, and a B * P that no block
# size divides
CUDA_CASES = [(nb, pop, 3, 5, 2, 4) for nb, pop in CASES] + [
    (3, 64, 4, 80, 8, 16), (3, 512, 4, 80, 8, 16), (2, 5, 7, 46, 3, 4),
    (3, 9, 2, 162, 8, 16), (2, 3, 5, 13, 11, 3), (1, 1, 1, 1, 1, 1),
    (3, 133, 2, 20, 4, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("grid_order", ["batch_major", "pop_major"])
@pytest.mark.parametrize("nb,pop,rows,cols,width,chips", CUDA_CASES)
def test_cuda_kernels_bitwise_plain(cuda_device, grid_order, nb, pop, rows,
                                    cols, width, chips):
    arrays = _fused_case(nb * 10 + pop, nb, pop, rows=rows, cols=cols,
                         width=width, chips=chips)
    t_proc, sched, chip, ppos = _torch(*arrays, device=cuda_device)
    for fused in (False, True):
        assert me.kernel_plan(t_proc, chip, ppos, chips,
                              fused).route == "shared"
    before = me.launch_counts()
    end_k, free_k = ops.mapping_eval_fused(t_proc, sched, chip, ppos, chips,
                                           grid_order=grid_order)
    end_p, free_p = me.mapping_eval_fused_plain(t_proc, sched, chip, ppos,
                                                chips)
    gathered = me.gather_sched(t_proc, sched).contiguous()
    end_u, free_u = ops.mapping_eval(gathered, chip, ppos, chips,
                                     grid_order=grid_order)
    torch.cuda.synchronize()
    after = me.launch_counts()
    assert after["mapping_eval_fused"] == before["mapping_eval_fused"] + 1
    assert after["mapping_eval"] == before["mapping_eval"] + 1
    assert torch.equal(end_k, end_p) and torch.equal(free_k, free_p)
    assert torch.equal(end_u, end_p) and torch.equal(free_u, free_p)
    # the global-row route gives the same bits
    end_g, free_g = me.mapping_eval_fused_cuda(t_proc, sched, chip, ppos,
                                               chips, grid_order, "global")
    end_gu, free_gu = me.mapping_eval_cuda(gathered, chip, ppos, chips,
                                           grid_order, "global")
    assert torch.equal(end_g, end_p) and torch.equal(free_g, free_p)
    assert torch.equal(end_gu, end_p) and torch.equal(free_gu, free_p)
    e_end, e_free = t_ref.mapping_eval_fused_reference(*arrays, chips)
    np.testing.assert_allclose(end_k.cpu().numpy(), e_end, rtol=1e-5)
    np.testing.assert_allclose(free_k.cpu().numpy(), e_free, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_kernels_bitwise_plain_at_the_cap(cuda_device, fused):
    """At the longest chain the card's plan keeps on the shared route, and
    one step past it (the global route): bitwise the plain version, and
    each call one launch of the kernel's counter."""
    nb, pop, width, chips = 8, 2, 1, 2
    limits = me.device_limits(cuda_device)
    cap = _cap_t(nb, width, chips, fused, limits)
    for t_len, route in ((cap, "shared"), (cap + 1, "global")):
        arrays = _fused_case(t_len, nb, pop, rows=1, cols=t_len,
                             width=width, chips=chips)
        t_proc, sched, chip, ppos = _torch(*arrays, device=cuda_device)
        assert me.kernel_plan(t_proc, chip, ppos, chips,
                              fused).route == route
        name = "mapping_eval_fused" if fused else "mapping_eval"
        before = me.launch_counts()[name]
        if fused:
            end_k, free_k = me.mapping_eval_fused_cuda(t_proc, sched, chip,
                                                       ppos, chips)
            end_p, free_p = me.mapping_eval_fused_plain(
                *(x.cpu() for x in (t_proc, sched, chip, ppos)), chips)
        else:
            tp = me.gather_sched(t_proc, sched).contiguous()
            end_k, free_k = me.mapping_eval_cuda(tp, chip, ppos, chips)
            end_p, free_p = me.mapping_eval_plain(
                *(x.cpu() for x in (tp, chip, ppos)), chips)
        torch.cuda.synchronize()
        assert me.launch_counts()[name] == before + 1
        assert torch.equal(end_k.cpu(), end_p)
        assert torch.equal(free_k.cpu(), free_p)
    with pytest.raises(ValueError, match="shared memory"):
        me.mapping_eval_fused_cuda(t_proc, sched, chip, ppos, chips,
                                   route="shared")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shared", "global"])
def test_cuda_out_of_range_is_nan_at_that_step(cuda_device, route):
    """A chip id outside [0, C) and a sched index outside [0, L) poison
    exactly their step with NaN; every step before it is the plain
    version's, and both routes agree bit for bit on the rest."""
    nb, pop, rows, cols, width, chips = 3, 6, 4, 80, 8, 16
    t_proc, sched, chip, ppos = _fused_case(5, nb, pop, rows, cols, width,
                                            chips)
    t_len, at_chip, at_sched = rows * cols, 200, 77
    bad_chip, bad_sched = _malform(chip, sched, chips, t_len, at_chip,
                                   at_sched)
    dev = cuda_device
    tp, sch, ch, pp = _torch(t_proc, bad_sched, bad_chip, ppos, device=dev)
    end_f, _ = me.mapping_eval_fused_cuda(tp, sch, ch, pp, chips,
                                          route=route)
    end_g, _ = me.mapping_eval_fused_cuda(tp, sch, ch, pp, chips,
                                          route="global")
    end_p, _ = me.mapping_eval_fused_plain(*_torch(t_proc, sched, chip,
                                                   ppos, device=dev), chips)
    torch.cuda.synchronize()
    end_f, end_g, end_p = (x.cpu() for x in (end_f, end_g, end_p))
    assert torch.equal(end_f.isnan(), end_g.isnan())
    assert torch.equal(torch.nan_to_num(end_f), torch.nan_to_num(end_g))
    # individual 0: the chip at step 200 and the sched index at step 77
    # (past L) are out of range; the last individual: a negative index
    assert end_f[:, 0, at_sched].isnan().all()
    assert end_f[:, 0, at_chip].isnan().all()
    assert end_f[:, -1, at_sched].isnan().all()
    assert torch.equal(end_f[:, 0, :at_sched], end_p[:, 0, :at_sched])
    assert torch.equal(end_f[:, -1, :at_sched], end_p[:, -1, :at_sched])
    assert not end_f[:, 1:-1].isnan().any()
    assert torch.equal(end_f[:, 1:-1], end_p[:, 1:-1])
    # the unfused kernel: the bad chip alone
    gathered = me.gather_sched(*_torch(t_proc, sched, device=dev))
    end_u, _ = me.mapping_eval_cuda(gathered.contiguous(),
                                    *_torch(bad_chip, ppos, device=dev),
                                    chips, route=route)
    end_u = end_u.cpu()
    assert end_u[:, 0, at_chip].isnan().all()
    assert torch.equal(end_u[:, 0, :at_chip], end_p[:, 0, :at_chip])
    assert torch.equal(end_u[:, 1:], end_p[:, 1:])
