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


@pytest.mark.cuda
@pytest.mark.parametrize("grid_order", ["batch_major", "pop_major"])
@pytest.mark.parametrize("nb,pop", CASES)
def test_cuda_kernels_bitwise_plain(cuda_device, grid_order, nb, pop):
    chips = 4
    arrays = _fused_case(nb * 10 + pop, nb, pop, rows=3, cols=5, width=2,
                         chips=chips)
    t_proc, sched, chip, ppos = _torch(*arrays, device=cuda_device)
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
    e_end, _ = t_ref.mapping_eval_fused_reference(*arrays, chips)
    np.testing.assert_allclose(end_k.cpu().numpy(), e_end, rtol=1e-5)
