"""The port's SSD scan: its plain torch version against the JAX package's
Pallas ``ssd_scan`` (interpret mode), the JAX package's chunked
``_ssd_xla`` and the float64 sequential reference on identical inputs,
the device routing and its counters, and (on a CUDA host) the hand-written
kernel against its plain version.

Tolerance 1e-4 (absolute and relative), as ``tests/test_kernels.py`` holds
the Pallas kernel to its oracle: the chunked form sums in float32 in
another order than the sequential recurrence. bfloat16 inputs: 2e-2 (one
rounding of y).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

TOL = 1e-4
# (B, L, H, P, N, chunk): the shapes of tests/test_kernels.py, then L 1,
# L 7 (< 8), a ragged L over two chunks, and several heads and sequences
# with a distinct decay per head (a head or batch indexing error shows)
CASES = [
    (1, 96, 2, 16, 8, 32),
    (2, 70, 3, 8, 16, 32),
    (1, 128, 1, 32, 32, 64),
    (2, 1, 3, 8, 16, 128),
    (2, 7, 3, 8, 16, 128),
    (2, 200, 4, 64, 16, 128),
    (3, 45, 5, 16, 24, 16),
]


def _inputs(seed, b, l, h, p, n):
    """x, B, C ~ N(0, 1); dt in (0.01, 0.2); a in (-2, -0.5), one per head."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, l, h, p)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(b, l, h)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(h,)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32),
            rng.normal(size=(b, l, n)).astype(np.float32))


def _t(arrays, dtype=torch.float32):
    """numpy -> torch; x, B and C (0, 3, 4) in ``dtype``, dt and a float32."""
    return [torch.as_tensor(a).to(dtype if i in (0, 3, 4) else torch.float32)
            for i, a in enumerate(arrays)]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float()),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("b,l,h,p,n,chunk", CASES)
def test_plain_matches_pallas_and_reference(b, l, h, p, n, chunk):
    import jax.numpy as jnp
    from repro.kernels import ops as j_ops

    arrays = _inputs(l * 5 + h, b, l, h, p, n)
    j_y, j_s = j_ops.ssd_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                              interpret=True)
    y, s = ss.ssd_scan_plain(*_t(arrays), chunk=chunk)
    assert y.dtype == torch.float32 and tuple(y.shape) == (b, l, h, p)
    assert s.dtype == torch.float32 and tuple(s.shape) == (b, h, n, p)
    _close(y, j_y)
    _close(s, j_s)
    r_y, r_s = t_ref.ssd_reference(*arrays)
    _close(y, r_y)
    _close(s, r_s)


@pytest.mark.parametrize("chunk", [16, 64])
def test_chunk_length_changes_only_the_rounding(chunk):
    """The CUDA kernel's chunk (64) is not the plain version's default
    (128): both give the function, within float32 rounding."""
    arrays = _t(_inputs(3, 2, 150, 3, 16, 16))
    y_a, s_a = ss.ssd_scan_plain(*arrays)
    y_b, s_b = ss.ssd_scan_plain(*arrays, chunk=chunk)
    _close(y_a, y_b.numpy(), 1e-5)
    _close(s_a, s_b.numpy(), 1e-5)
    assert ss.KERNEL_CHUNK == 64


def test_bfloat16_plain_matches_pallas():
    """bfloat16 x, B and C: both compute in float32 and round y once."""
    import jax.numpy as jnp
    from repro.kernels import ops as j_ops

    arrays = _inputs(9, 2, 70, 3, 8, 16)
    j_in = [jnp.asarray(a, jnp.bfloat16 if i in (0, 3, 4) else jnp.float32)
            for i, a in enumerate(arrays)]
    j_y, j_s = j_ops.ssd_scan(*j_in, chunk=32, interpret=True)
    y, s = ss.ssd_scan_plain(*_t(arrays, torch.bfloat16), chunk=32)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    _close(y, np.asarray(j_y, np.float32), 2e-2)
    _close(s, np.asarray(j_s), 2e-2)


@pytest.mark.parametrize("l", [1, 37, 130])
def test_chunked_from_a_state_matches_xla_and_reference(l):
    """The eager path's chunked SSD continues a given state exactly as the
    JAX package's ``_ssd_xla`` and the sequential recurrence do."""
    import jax.numpy as jnp
    from repro.models.mamba2 import _ssd_xla

    b, h, p, n = 2, 3, 16, 8
    arrays = _inputs(l, b, l, h, p, n)
    init = np.random.default_rng(l + 1).normal(
        size=(b, h, n, p)).astype(np.float32)
    j_y, j_s = _ssd_xla(*(jnp.asarray(a) for a in arrays), jnp.asarray(init))
    y, s = ss.ssd_chunked(*_t(arrays), torch.as_tensor(init))
    _close(y, j_y)
    _close(s, j_s)
    r_y, r_s = t_ref.ssd_reference(*arrays, init_state=init)
    _close(y, r_y)
    _close(s, r_s)


def test_padded_positions_leave_the_state():
    """dt = 0 past a true length (the engine's padded buckets) makes those
    positions identities on the state."""
    x, dt, a, bm, cm = _t(_inputs(4, 1, 12, 2, 8, 8))
    init = torch.zeros((1, 2, 8, 8))
    _, s_short = ss.ssd_chunked(x[:, :7], dt[:, :7], a, bm[:, :7],
                                cm[:, :7], init)
    dt_pad = dt.clone()
    dt_pad[:, 7:] = 0.0
    _, s_pad = ss.ssd_chunked(x, dt_pad, a, bm, cm, init)
    _close(s_pad, s_short.numpy(), 1e-6)


def test_routes_and_counters():
    """A CPU tensor runs the plain version and is counted as ``:plain``;
    the CUDA launcher refuses it; no device other than CPU or CUDA has a
    path; nothing is launched."""
    arrays = _t(_inputs(1, 1, 20, 2, 8, 8))
    before = ops.launch_counts()
    ops.clear_dispatch_stats()
    y, s = ops.ssd_scan(*arrays)
    y_p, s_p = ss.ssd_scan_plain(*arrays)
    assert torch.equal(y, y_p) and torch.equal(s, s_p)
    assert ops.dispatch_stats() == {"ssd_scan:plain": 1}
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_cuda(*arrays)
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta")
            for a in arrays]
    with pytest.raises(ValueError, match="meta"):
        ops.ssd_scan(*meta)
    with pytest.raises(TypeError):
        ops.ssd_scan(arrays[0].numpy(), *arrays[1:])
    assert ops.launch_counts() == before
    assert "ssd_scan" in ops.launch_counts()
    ops.reset_launch_counts()
    assert ops.launch_counts()["ssd_scan"] == 0


def test_build_source_exists():
    """The kernel is built from the checkout's csrc by the same build step
    as the others; asking for the path builds nothing."""
    from repro_torch.kernels import build

    assert (build.CSRC / "ssd_scan.cu").is_file()
    path = build.library_path("ssd_scan.cu")
    assert path.parent == build.build_dir() and path.suffix == ".so"


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernel has no "
                    "CPU mode (its plain version is tested above)")
    return torch.device("cuda", 0)


# (B, L, H, P, N) at the edges of the kernels' tiles: L of one chunk, its
# edge and two chunks, a ragged L; N 1 (B and C not 16-byte aligned in the
# fused row), 100, 256 (two state-row tiles); P 5 (x not aligned), 96 and
# 100 (a ragged second column tile); H 81; B 3
EDGES = [(2, 1, 8, 64, 128), (2, 63, 8, 64, 128), (2, 64, 8, 64, 128),
         (2, 65, 8, 64, 128), (1, 700, 8, 64, 128), (2, 200, 4, 64, 1),
         (2, 150, 4, 64, 100), (2, 300, 8, 64, 256), (2, 130, 8, 5, 128),
         (2, 130, 8, 96, 128), (2, 130, 8, 100, 128), (2, 130, 81, 64, 128),
         (3, 130, 8, 64, 128)]


# jamba-v0.1-52b's Mamba heads (d_inner 8,192 over 64 heads: P 128, N 16):
# its 2 x 512 prefill, a ragged L and a chunk edge
JAMBA = [(2, 512, 64, 128, 16), (2, 700, 64, 128, 16), (1, 65, 64, 128, 16)]


def _fused_inputs(device, b, l, h, p, n, dtype, seed):
    """x, dt, a, B, C with x, B and C slices of one fused projection."""
    rng = np.random.default_rng(seed)
    dt_ = getattr(torch, dtype)
    fused = torch.as_tensor(rng.normal(size=(b, l, h * p + 2 * n)),
                            device=device).to(dt_)
    x = fused[..., :h * p].reshape(b, l, h, p)
    bm, cm = fused[..., h * p:h * p + n], fused[..., h * p + n:]
    dt = torch.as_tensor(rng.uniform(0.01, 0.2, size=(b, l, h)),
                         dtype=torch.float32, device=device)
    a = torch.as_tensor(-rng.uniform(0.5, 2.0, size=h), dtype=torch.float32,
                        device=device)
    return x, dt, a, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,l,h,p,n", [c[:5] for c in CASES]
                         + [(2, 512, 80, 64, 128), (1, 700, 80, 64, 128)]
                         + EDGES + JAMBA)
def test_cuda_matches_plain(cuda_device, b, l, h, p, n, dtype, tol):
    """The kernels against their plain version, within ``tol`` of the
    largest value; x, B and C are slices of one fused projection, as the
    mixer hands them over. The first version of the kernel (timed beside
    them on the card) holds the same."""
    x, dt, a, bm, cm = _fused_inputs(cuda_device, b, l, h, p, n, dtype,
                                     l + n)
    before = ops.launch_counts()["ssd_scan"]
    y, s = ops.ssd_scan(x, dt, a, bm, cm)
    y_p, s_p = ss.ssd_scan_plain(x, dt, a, bm, cm)
    y_1, s_1 = ss._ssd_scan_serial_cuda(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ssd_scan"] == before + 1
    assert y.dtype == x.dtype and s.dtype == torch.float32
    for got, want in ((y, y_p), (s, s_p), (y_1, y_p), (s_1, s_p)):
        assert torch.isfinite(got).all()
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,p,n", [(1, 96, 2, 16, 8), (2, 130, 3, 5, 1)])
def test_cuda_matches_float64_reference(cuda_device, b, l, h, p, n):
    """y and the final state against the float64 sequential recurrence
    (``ref.ssd_reference``), within 1e-4 of the largest value."""
    arrays = _inputs(b + l, b, l, h, p, n)
    y, s = ss.ssd_scan_cuda(*(t.to(cuda_device) for t in _t(arrays)))
    r_y, r_s = t_ref.ssd_reference(*arrays)
    for got, want in ((y, r_y), (s, r_s)):
        err = np.abs(got.cpu().numpy().astype(np.float64) - want).max()
        assert err <= TOL * np.abs(want).max()


def test_plan_at_the_prefill_shape():
    """mamba2-2.7b's 2 x 512 prefill: C B^T once per (batch, chunk), 640
    state blocks (B H x 2 column tiles x 2 state-row tiles) and 1,280 y
    blocks, at least 640 independent blocks each where the first version
    ran 160; the workspace holds every chunk's float32 state and the
    64 x 64 C B^T tiles; shared bytes within the card's limit."""
    b, l, h, p, n = 2, 512, 80, 64, 128
    for item in (4, 2):
        plan = ss.ssd_plan(b, l, h, p, n, item)
        assert plan.chunks == 8 and plan.p_pad == 64
        assert plan.cb_blocks == b * plan.chunks == 16
        assert plan.state_blocks == b * h * 2 * 2 == 640
        assert plan.y_blocks == b * plan.chunks * h == 1280
        states = 4 * b * h * plan.chunks * n * p
        assert plan.workspace_bytes == states + 4 * b * plan.chunks * 64 * 64
        assert max(plan.state_smem, plan.y_smem) <= ss.MAX_SMEM
    f32, bf16 = ss.ssd_plan(b, l, h, p, n, 4), ss.ssd_plan(b, l, h, p, n, 2)
    assert (f32.state_smem, f32.y_smem) == (27_136, 36_608)
    assert (bf16.state_smem, bf16.y_smem) == (28_160, 54_528)


def test_plan_at_jambas_prefill_shape():
    """jamba-v0.1-52b's 2 x 512 prefill (H 64, P 128, N 16): the state
    blocks take 4 column tiles of 32 and one state-row tile of 64 rows, 48
    of them past N (dead); the y blocks two column tiles of 64."""
    b, l, h, p, n = 2, 512, 64, 128, 16
    for item in (4, 2):
        plan = ss.ssd_plan(b, l, h, p, n, item)
        assert (plan.chunks, plan.p_tiles, plan.s_tiles, plan.n_tiles) == \
            (8, 2, 4, 1)
        assert plan.n_tiles * 64 - n == 48
        assert plan.state_blocks == b * h * 4 == 512
        assert plan.y_blocks == b * plan.chunks * h * 2 == 2048
        assert plan.cb_blocks == b * plan.chunks == 16


@pytest.mark.parametrize("b,l,h,p,n", EDGES + JAMBA + [(2, 4096, 80, 64, 128),
                                                      (1, 0, 2, 8, 16)])
@pytest.mark.parametrize("item", [4, 2])
def test_plan_tiles_and_workspace(b, l, h, p, n, item):
    """Tile counts cover every position, column and state row once; the
    workspace rows are P rounded up to 4, each part 256-byte aligned;
    shared bytes do not depend on the shape and fit a block."""
    plan = ss.ssd_plan(b, l, h, p, n, item)
    assert plan.chunks * ss.KERNEL_CHUNK >= l > (plan.chunks - 1) * 64
    assert plan.p_tiles * 64 >= p > (plan.p_tiles - 1) * 64
    assert plan.s_tiles * 32 >= p > (plan.s_tiles - 1) * 32
    assert plan.n_tiles * 64 >= n > (plan.n_tiles - 1) * 64
    assert plan.p_pad % 4 == 0 and p <= plan.p_pad < p + 4
    assert plan.state_blocks == b * h * plan.s_tiles * plan.n_tiles
    assert plan.y_blocks == b * plan.chunks * h * plan.p_tiles
    assert plan.cb_blocks == b * plan.chunks
    states = 4 * b * h * plan.chunks * n * plan.p_pad
    assert plan.workspace_bytes == (-(-states // 256) * 256
                                    + 4 * b * plan.chunks * 64 * 64)
    ref = ss.ssd_plan(2, 512, 80, 64, 128, item)
    assert (plan.state_smem, plan.y_smem) == (ref.state_smem, ref.y_smem)
    assert max(plan.state_smem, plan.y_smem) <= ss.MAX_SMEM


def test_serial_launcher_refuses_cpu_and_is_not_counted():
    """The first version's private launcher takes CUDA tensors only and
    is not counted as a launch of the path's kernels."""
    arrays = _t(_inputs(2, 1, 20, 2, 8, 8))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ss._ssd_scan_serial_cuda(*arrays)
    assert ops.launch_counts() == before
