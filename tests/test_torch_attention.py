"""The port's attention kernels: their plain torch versions against the JAX
package's Pallas kernels (interpret mode) and the float64 references on
identical inputs, the device routing and its counters, and (on a CUDA
host) the hand-written kernels against their plain versions.

Tolerances are those of ``tests/test_kernels.py``: 2e-5 in float32 (sums
in another order), 2e-2 in bfloat16 (one rounding of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as t_ref

TOLS = [("float32", 2e-5), ("bfloat16", 2e-2)]
FLASH_CASES = [
    (1, 4, 4, 64, 64, 64, True),
    (2, 8, 2, 96, 160, 64, True),    # GQA + longer KV (cached prefix)
    (1, 6, 3, 33, 57, 32, False),    # ragged, bidirectional
    (1, 2, 1, 128, 128, 128, True),
]
DECODE_CASES = [
    (2, 8, 2, 257, 64),
    (1, 4, 4, 96, 32),
    (3, 4, 1, 130, 64),   # single shared KV head
]


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(x, dtype):
    """numpy float32 -> (JAX array, torch tensor) of ``dtype`` (both round
    to nearest even)."""
    import jax.numpy as jnp

    return jnp.asarray(x, getattr(jnp, dtype)), \
        torch.as_tensor(x).to(getattr(torch, dtype))


def _flash_inputs(seed, b, hq, hkv, lq, lk, d):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, hq, lq, d)), _normal(rng, (b, hkv, lk, d)),
            _normal(rng, (b, hkv, lk, d)))


def _decode_inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (_normal(rng, (b, hq, d)), _normal(rng, (b, s, hkv, d)),
            _normal(rng, (b, s, hkv, d)),
            rng.integers(1, s + 1, size=b).astype(np.int32))


def _f32(x):
    return np.asarray(torch.as_tensor(x).float() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", FLASH_CASES)
def test_flash_plain_matches_pallas(b, hq, hkv, lq, lk, d, causal, dtype,
                                    tol):
    pytest.importorskip("jax")
    from repro.kernels import ops as j_ops

    arrays = _flash_inputs(lq * 7 + lk, b, hq, hkv, lq, lk, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in arrays)
    want = j_ops.flash_attention(jq, jk, jv, causal=causal, block_q=32,
                                 block_k=32, interpret=True)
    got = fa.flash_attention_plain(tq, tk, tv, causal)
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, hq, lq, d)
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(
            _f32(got), t_ref.flash_attention_reference(*arrays, causal),
            atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,s,d", DECODE_CASES)
def test_decode_plain_matches_pallas(b, hq, hkv, s, d, dtype, tol):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as j_ops

    q, kc, vc, lens = _decode_inputs(s * 3 + b, b, hq, hkv, s, d)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kc, vc))
    want = j_ops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_s=64,
                                  interpret=True)
    got = da.decode_attention_plain(tq, tk, tv, torch.as_tensor(lens))
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, hq, d)
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(
            _f32(got), t_ref.decode_attention_reference(q, kc, vc, lens),
            atol=tol, rtol=tol)


def test_plain_edge_cases_follow_the_kernels():
    """A query row with no visible key gives 0 (weights zeroed after the
    exp, division by 1); a length past S reads all S rows; stale rows past
    a length never reach the output."""
    q, k, v = (torch.as_tensor(a) for a in _flash_inputs(5, 1, 2, 1, 6, 3,
                                                         32))
    out = fa.flash_attention_plain(q, k, v, causal=True)  # offset -3
    assert torch.equal(out[:, :, :3], torch.zeros_like(out[:, :, :3]))
    assert torch.isfinite(out).all()
    qd, kc, vc, _ = (torch.as_tensor(a) for a in _decode_inputs(6, 2, 4, 2,
                                                                16, 32))
    full = da.decode_attention_plain(qd, kc, vc, torch.tensor([16, 16]))
    past = da.decode_attention_plain(qd, kc, vc, torch.tensor([40, 17]))
    assert torch.equal(full, past)
    lens = torch.tensor([5, 9], dtype=torch.int32)
    base = da.decode_attention_plain(qd, kc, vc, lens)
    poisoned_k, poisoned_v = kc.clone(), vc.clone()
    poisoned_k[0, 5:], poisoned_v[1, 9:] = 7.7e4, -3e4
    assert torch.equal(base, da.decode_attention_plain(qd, poisoned_k,
                                                       poisoned_v, lens))


def test_routes_and_counters():
    """CPU tensors run the plain versions and are counted as ``:plain``;
    the CUDA launchers refuse them; no device other than CPU or CUDA has a
    path; nothing is launched."""
    q, k, v = (torch.as_tensor(a) for a in _flash_inputs(1, 1, 4, 2, 8, 8,
                                                         32))
    qd, kc, vc, lens = (torch.as_tensor(a)
                        for a in _decode_inputs(2, 2, 4, 2, 16, 32))
    before_l = ops.launch_counts()
    ops.clear_dispatch_stats()
    out = ops.flash_attention(q, k, v, causal=True)
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, True))
    out = ops.decode_attention(qd, kc, vc, lens)
    assert torch.equal(out, da.decode_attention_plain(qd, kc, vc, lens))
    assert ops.dispatch_stats() == {"flash_attention:plain": 1,
                                    "decode_attention:plain": 1}
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(qd, kc, vc, lens)
    meta = torch.empty(q.shape, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(meta, meta, meta)
    with pytest.raises(TypeError):
        ops.decode_attention(qd.numpy(), kc, vc, lens)
    assert ops.launch_counts() == before_l
    assert set(ops.launch_counts()) == {"mapping_eval", "mapping_eval_fused",
                                        "decode_attention",
                                        "flash_attention", "ssd_scan"}


def test_build_sources_exist():
    """Both kernels are built from the checkout's csrc by the same build
    step as the mapping-eval kernels; asking for the path builds nothing."""
    from repro_torch.kernels import build

    for src in ("decode_attention.cu", "flash_attention.cu"):
        assert (build.CSRC / src).is_file()
        path = build.library_path(src)
        assert path.parent == build.build_dir() and path.suffix == ".so"


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (their plain versions are tested above)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal",
                         FLASH_CASES + [(2, 24, 8, 512, 512, 128, True),
                                        (1, 24, 8, 100, 512, 128, True)])
def test_cuda_flash_matches_plain(cuda_device, b, hq, hkv, lq, lk, d, causal,
                                  dtype, tol):
    q, k, v = (torch.as_tensor(a, device=cuda_device).to(getattr(torch,
                                                                  dtype))
               for a in _flash_inputs(lq + lk, b, hq, hkv, lq, lk, d))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    # transposed views of a [B, L, H, D] projection go in without a copy
    got_t = fa.flash_attention_cuda(q.transpose(1, 2).contiguous()
                                    .transpose(1, 2), k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 2
    assert torch.equal(got, got_t)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,s,d",
                         DECODE_CASES + [(8, 24, 8, 1024, 128)])
def test_cuda_decode_matches_plain(cuda_device, b, hq, hkv, s, d, dtype,
                                   tol):
    q, kc, vc, lens = _decode_inputs(s + b, b, hq, hkv, s, d)
    q, kc, vc = (torch.as_tensor(a, device=cuda_device)
                 .to(getattr(torch, dtype)) for a in (q, kc, vc))
    lens = torch.as_tensor(lens, device=cuda_device)
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, kc, vc, lens)
    want = da.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
