"""The port's attention kernels: their plain torch versions against the JAX
package's Pallas kernels (interpret mode) and the float64 references on
identical inputs, the device routing and its counters, and (on a CUDA
host) the hand-written kernels against their plain versions.

Tolerances are those of ``tests/test_kernels.py``: 2e-5 in float32 (sums
in another order), 2e-2 in bfloat16 (one rounding of the output).
"""
import functools

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


@functools.lru_cache(maxsize=None)
def _pallas_decode(b, hq, hkv, s, d, dtype):
    """The JAX package's Pallas decode kernel (interpret mode) on the
    seeded inputs of a DECODE_CASES shape, as float32 numpy."""
    import jax.numpy as jnp
    from repro.kernels import ops as j_ops

    q, kc, vc, lens = _decode_inputs(s * 3 + b, b, hq, hkv, s, d)
    jq, jk, jv = (_both(a, dtype)[0] for a in (q, kc, vc))
    return np.asarray(j_ops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                             block_s=64, interpret=True),
                      np.float32)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,s,d", DECODE_CASES)
def test_decode_plain_matches_pallas(b, hq, hkv, s, d, dtype, tol, n_split):
    """The plain version in one range and under the kernel's split into
    ``n_split`` ranges (partials merged as the combine kernel merges
    them) against the Pallas kernel and the float64 reference."""
    pytest.importorskip("jax")

    q, kc, vc, lens = _decode_inputs(s * 3 + b, b, hq, hkv, s, d)
    tq, tk, tv = (_both(a, dtype)[1] for a in (q, kc, vc))
    want = _pallas_decode(b, hq, hkv, s, d, dtype)
    got = da.decode_attention_plain(tq, tk, tv, torch.as_tensor(lens),
                                    n_split=n_split)
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, hq, d)
    np.testing.assert_allclose(_f32(got), want, atol=tol, rtol=tol)
    if dtype == "float32":
        np.testing.assert_allclose(
            _f32(got), t_ref.decode_attention_reference(q, kc, vc, lens),
            atol=tol, rtol=tol)


def _edge_lengths(b, s, split_len):
    """0, 1, a split boundary - 1, at and + 1, S and past S, in turn."""
    edges = [0, 1, split_len - 1, split_len, split_len + 1, s, s + 9]
    return np.array([edges[i % len(edges)] for i in range(b)], np.int32)


# (B, Hq, Hkv, S, D, n_split): boundaries inside S; S below one tile (the
# second range starts past S); S not a whole number of tiles; ranges that
# are wholly empty for every length short of them
SPLIT_EDGE_CASES = [
    (7, 8, 2, 257, 64, 3),
    (5, 6, 2, 20, 32, 2),
    (7, 4, 1, 130, 64, 2),
    (7, 6, 3, 300, 32, 3),
    (4, 4, 4, 96, 32, 7),
]


@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,s,d,n_split", SPLIT_EDGE_CASES)
def test_decode_plain_split_edges(b, hq, hkv, s, d, n_split, dtype, tol):
    """Under a split plan, lengths at and around the range boundaries, 0
    and past S give what one range gives and what the float64 reference
    gives (a length of 0 gives 0, where the reference has no value), and
    stale rows past a length never reach the output."""
    q, kc, vc, _ = _decode_inputs(s + d, b, hq, hkv, s, d)
    split_len = da.split_len_of(s, n_split)
    lens = _edge_lengths(b, s, split_len)
    tq, tk, tv = (_both(a, dtype)[1] for a in (q, kc, vc))
    tl = torch.as_tensor(lens)
    got = da.decode_attention_plain(tq, tk, tv, tl, n_split=n_split)
    one = da.decode_attention_plain(tq, tk, tv, tl)
    assert got.dtype == tq.dtype and tuple(got.shape) == (b, hq, d)
    np.testing.assert_allclose(_f32(got), _f32(one), atol=tol, rtol=tol)
    empty = lens == 0
    assert empty.any() and not _f32(got)[empty].any()
    if dtype == "float32":
        live = ~empty
        want = t_ref.decode_attention_reference(q[live], kc[live], vc[live],
                                                lens[live])
        np.testing.assert_allclose(_f32(got)[live], want, atol=tol, rtol=tol)
    poisoned_k, poisoned_v = tk.clone(), tv.clone()
    for i, n in enumerate(lens):
        poisoned_k[i, n:], poisoned_v[i, n:] = 7.7e4, -3e4
    assert torch.equal(got, da.decode_attention_plain(
        tq, poisoned_k, poisoned_v, tl, n_split=n_split))


def test_split_plan_invariants():
    """The ranges cover S in whole tiles, 1 <= n_split <= ceil(S /
    MIN_SPLIT_LEN), the plan aims at WAVES waves of BLOCKS_PER_SM blocks,
    and one range is taken once B * Hkv blocks fill the card."""
    fill = da.WAVES * da.BLOCKS_PER_SM
    for n_sm in (1, 8, 114, 132):
        for b in (1, 2, 8, 33, 64):
            for hkv in (1, 2, 8, 32):
                for s in (1, 20, 31, 32, 96, 130, 257, 1024, 5000, 8192,
                          32768):
                    n_split, split_len = da.split_plan(b, hkv, s, n_sm)
                    cap = -(-s // da.MIN_SPLIT_LEN)
                    assert 1 <= n_split <= cap
                    assert split_len % da.TILE == 0 and split_len >= da.TILE
                    assert n_split * split_len >= s
                    assert split_len == da.split_len_of(s, n_split)
                    if b * hkv >= fill * n_sm:
                        assert n_split == 1
                    elif n_split < cap:
                        assert n_split * b * hkv >= fill * n_sm
    assert da.split_plan(8, 8, 8192, 132)[0] > 1


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
    # q and caches of different types: the plain version upcasts each
    # operand and keeps q's type; the launcher refuses the CPU tensors
    mixed = ops.decode_attention(qd, kc.bfloat16(), vc.bfloat16(), lens)
    assert torch.equal(mixed, da.decode_attention_plain(
        qd, kc.bfloat16().float(), vc.bfloat16().float(), lens))
    mixed = ops.decode_attention(qd.bfloat16(), kc, vc, lens)
    assert mixed.dtype == torch.bfloat16 and torch.equal(
        mixed, da.decode_attention_plain(qd.bfloat16().float(), kc, vc,
                                         lens).bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(qd, kc.bfloat16(), vc.bfloat16(), lens)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16())
    assert ops.launch_counts() == before_l
    assert set(ops.launch_counts()) == {"mapping_eval", "mapping_eval_fused",
                                        "decode_attention",
                                        "flash_attention",
                                        "flash_attention_bf16", "ssd_scan"}
    # float32 and bfloat16 each reach exactly one flash kernel, not the same
    assert fa.KERNEL_OF == {torch.float32: "flash_attention",
                            torch.bfloat16: "flash_attention_bf16"}
    assert set(fa.launch_counts()) == set(fa.KERNEL_OF.values())


def test_build_sources_exist():
    """Both kernels are built from the checkout's csrc by the same build
    step as the mapping-eval kernels; asking for the path builds nothing."""
    from repro_torch.kernels import build

    for src in ("decode_attention.cu", "flash_attention.cu"):
        assert (build.CSRC / src).is_file()
        path = build.library_path(src)
        assert path.parent == build.build_dir() and path.suffix == ".so"


# (B, Hq, Hkv, Lq, Lk, D): the serving shapes, a ragged Lq, Lq < Lk, Lq >
# Lk (rows that see no key), L < 16, Lk < 16 < Lq, and one query
PLAN_CASES = [
    (2, 24, 8, 512, 512, 128), (2, 24, 8, 2048, 2048, 128),
    (1, 24, 8, 100, 512, 128), (2, 8, 1, 200, 333, 96),
    (1, 2, 1, 100, 40, 64), (1, 3, 1, 9, 9, 128), (1, 16, 2, 5, 70, 64),
    (3, 4, 2, 70, 13, 32), (3, 5, 5, 1, 1, 128)]


@pytest.mark.parametrize("b,hq,hkv,lq,lk,d", PLAN_CASES)
def test_flash_f32_plan_covers_every_tile_longest_first(b, hq, hkv, lq, lk,
                                                        d):
    """The float32 plan's blocks cover every (b * Hq + h, query tile) once;
    in launch order the key tiles they walk never grow (every head's
    longest causal tile first); each walks exactly the key tiles that hold
    a key visible to one of its rows, and a bidirectional block all of Lk."""
    plan = fa.flash_f32_plan(b, hq, hkv, lq, lk, d)
    assert plan.q_tiles == -(-lq // fa.F32_BLOCK_Q)
    assert plan.grid == (b * hq, plan.q_tiles)
    assert plan.blocks == b * hq * plan.q_tiles
    order = [plan.block(i) for i in range(plan.blocks)]
    assert sorted(order) == [(bh, t) for bh in range(b * hq)
                             for t in range(plan.q_tiles)]
    walks = [plan.key_tiles(t, True) for _, t in order]
    assert walks == sorted(walks, reverse=True)
    for t in range(plan.q_tiles):
        rows = range(t * plan.block_q, min((t + 1) * plan.block_q, lq))
        visible = max(min(lk, r + lk - lq + 1) for r in rows)
        assert plan.key_tiles(t, True) == -(-max(visible, 0)
                                            // plan.block_k)
        assert plan.key_tiles(t, False) == -(-lk // plan.block_k)


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_f32_plan_shared_memory(d):
    """At every head dim a block's shared bytes stay within what a block
    may use (227 KB) and two blocks (8 warps) fit on an SM."""
    plan = fa.flash_f32_plan(2, 24, 8, 512, 512, d)
    assert plan.smem_bytes == fa.f32_smem_bytes(d)
    assert plan.smem_bytes <= fa.MAX_SMEM_BLOCK
    assert 2 * (plan.smem_bytes + fa.SMEM_RESERVED) <= fa.SMEM_PER_SM
    assert plan.blocks_per_sm >= 2
    assert plan.threads * plan.blocks_per_sm >= 8 * 32
    assert plan.block_q % 8 == 0 and plan.block_k % 16 == 0


def test_flash_f32_plan_refuses_and_first_kernel_needs_cuda():
    """The plan refuses a head dim the kernels lack and an Hq that is not
    a multiple of Hkv; the first float32 kernel's launcher, like the
    kernels', refuses CPU tensors, and counts nothing."""
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_f32_plan(1, 4, 2, 8, 8, 48)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_f32_plan(1, 6, 4, 8, 8, 64)
    q, k, v = (torch.as_tensor(a) for a in _flash_inputs(1, 1, 4, 2, 8, 8,
                                                         32))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fa._flash_attention_f32_first_cuda(q, k, v)
    assert ops.launch_counts() == before


@pytest.fixture
def cuda_device():
    """The first CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode (their plain versions are tested above)")
    return torch.device("cuda", 0)


# the card's parity shapes: every D, causal and bidirectional, Lq < Lk,
# ragged L (not a multiple of the 64-row tiles), L < 16, Hq / Hkv of 1, 3, 8
FLASH_CUDA_CASES = FLASH_CASES + [
    (2, 24, 8, 512, 512, 128, True), (1, 24, 8, 100, 512, 128, True),
    (1, 8, 8, 77, 77, 32, True), (1, 6, 2, 130, 200, 64, False),
    (2, 8, 1, 200, 333, 96, True), (1, 3, 1, 9, 9, 128, True),
    (1, 24, 8, 13, 13, 96, False), (1, 4, 4, 150, 150, 32, False),
    (1, 16, 2, 5, 70, 64, True), (1, 3, 3, 250, 250, 128, False),
    (2, 32, 32, 512, 512, 96, True),      # phi-3-vision's prefill: D 96, rep 1
    (2, 32, 8, 512, 512, 128, True),      # jamba-v0.1-52b's prefill: rep 4
    # the prefill heads of the configurations no whole-model card run
    # covers: glm4-9b (rep 16), qwen2-1.5b (rep 6), deepseek-moe-16b and
    # qwen1.5-0.5b (rep 1)
    (2, 32, 2, 512, 512, 128, True), (2, 12, 2, 512, 512, 128, True),
    (2, 16, 16, 512, 512, 128, True), (2, 16, 16, 512, 512, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", FLASH_CUDA_CASES)
def test_cuda_flash_matches_plain(cuda_device, b, hq, hkv, lq, lk, d, causal,
                                  dtype, tol):
    q, k, v = (torch.as_tensor(a, device=cuda_device).to(getattr(torch,
                                                                  dtype))
               for a in _flash_inputs(lq + lk, b, hq, hkv, lq, lk, d))
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal)
    # transposed views of a [B, L, H, D] projection go in without a copy
    got_t = fa.flash_attention_cuda(q.transpose(1, 2).contiguous()
                                    .transpose(1, 2), k, v, causal)
    want = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    name = fa.KERNEL_OF[q.dtype]            # the one kernel of this dtype
    assert {key: after[key] - before[key] for key in after} == \
        {key: 2 if key == name else 0 for key in after}
    assert torch.equal(got, got_t)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _digest(out) -> str:
    """sha256 of an output's values as float32 bytes."""
    import hashlib

    return hashlib.sha256(out.float().cpu().numpy().tobytes()).hexdigest()


def _cuda_flash_inputs(device, b, hq, hkv, lq, lk, d, dtype="float32"):
    return (torch.as_tensor(a, device=device).to(getattr(torch, dtype))
            for a in _flash_inputs(lq + lk, b, hq, hkv, lq, lk, d))


# sha256 of the first float32 kernel's output bytes at seeded inputs, as the
# kernel of the previous release (before the bfloat16 kernel was added)
# computed them on an H100 (sm_90a)
FLASH_F32_DIGESTS = {
    (1, 4, 4, 64, 64, 64, True):
        "540cc121e0e8700885faa167ade6b53c12616ac9e645e4c82613fc3733e2145f",
    (2, 8, 2, 96, 160, 64, True):
        "0fbe3678b7ba5d8def1c90b345f746d4eed7f7ae48610b9e2e2193550e4ab42f",
    (1, 6, 3, 33, 57, 32, False):
        "10bd73a8e325d5710d3044e1c7b18fdd64ec7dd2599e59b75cdcabecac3da721",
    (1, 2, 1, 128, 128, 128, True):
        "8744fb2ae524e26a8f664e68a36b89b170f23bcd3f64a1eae35d27a77acb9f31",
}


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", FLASH_CASES)
def test_cuda_flash_float32_is_unchanged(cuda_device, b, hq, hkv, lq, lk, d,
                                         causal):
    """The first float32 kernel, kept off the path, is bit for bit what it
    was before the bfloat16 kernel existed, and counts no launch."""
    q, k, v = _cuda_flash_inputs(cuda_device, b, hq, hkv, lq, lk, d)
    before = ops.launch_counts()
    out = fa._flash_attention_f32_first_cuda(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.launch_counts() == before
    digest = _digest(out)
    assert digest == FLASH_F32_DIGESTS[(b, hq, hkv, lq, lk, d, causal)], \
        digest


# sha256 of the float32 kernel's output bytes at seeded inputs, as the
# kernel with register tiles (8 query rows a thread, 64-key tiles) computed
# them on an H100 (sm_90a)
FLASH_F32_NEW_DIGESTS = {
    (1, 4, 4, 64, 64, 64, True):
        "e8ee43b36c6cca25a2186fd9c6e08ce91f5a3019fa65b1978a11b23c3d6700b3",
    (2, 8, 2, 96, 160, 64, True):
        "45ad92de6eed9c2cd18105f272a78860b49e1cbbcbfbd17345229eb71eb7f0d8",
    (1, 6, 3, 33, 57, 32, False):
        "3affced5aa7f330453253f6b8404e8504dddd4f0352971663dd60a44b5aeb046",
    (1, 2, 1, 128, 128, 128, True):
        "c8304eec9a2c00c9282fdcb26975d936b6e1e8f9d59647e70a545b1a76924dd4",
}


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", FLASH_CASES)
def test_cuda_flash_float32_digests(cuda_device, b, hq, hkv, lq, lk, d,
                                    causal):
    """The float32 route launches the float32 kernel (one count, none for
    bfloat16), whose output is bit for bit the recorded one."""
    q, k, v = _cuda_flash_inputs(cuda_device, b, hq, hkv, lq, lk, d)
    before = ops.launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bf16"] == before["flash_attention_bf16"]
    digest = _digest(out)
    assert digest == FLASH_F32_NEW_DIGESTS[(b, hq, hkv, lq, lk, d, causal)], \
        digest


# sha256 of the bfloat16 kernel's output values (as float32 bytes) at the
# seeded inputs rounded to bfloat16, recorded on an H100 (sm_90a) from the
# bfloat16 kernel as it was before the float32 kernel's redesign
FLASH_BF16_DIGESTS = {
    (1, 4, 4, 64, 64, 64, True):
        "dbb0340f8b7831772a074498eef4cc9865c65667a828b0b5367478cd522d0e99",
    (2, 8, 2, 96, 160, 64, True):
        "7e631eb74ef32e749ef60267099c26db311c226e2d0cfa8691b293a52e20058f",
    (1, 6, 3, 33, 57, 32, False):
        "58961abd5b02dd1744b0684ca19b2f5fb9ef110b1a4ad739755f2051cf01f27d",
    (1, 2, 1, 128, 128, 128, True):
        "baefdc87c6059a14649ee9b1479f909910f40e4522ca78ca59dfbff8f3aae90f",
}


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", FLASH_CASES)
def test_cuda_flash_bf16_is_unchanged(cuda_device, b, hq, hkv, lq, lk, d,
                                      causal):
    """The bfloat16 route launches the tensor-core kernel, bit for bit as
    it was before the float32 kernel was redesigned."""
    q, k, v = _cuda_flash_inputs(cuda_device, b, hq, hkv, lq, lk, d,
                                 "bfloat16")
    before = ops.launch_counts()
    out = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_bf16"] == \
        before["flash_attention_bf16"] + 1
    digest = _digest(out)
    assert digest == FLASH_BF16_DIGESTS[(b, hq, hkv, lq, lk, d, causal)], \
        digest


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,lq,lk,d,causal", FLASH_CUDA_CASES)
def test_cuda_flash_float32_matches_float64_reference(cuda_device, b, hq,
                                                      hkv, lq, lk, d, causal):
    """The float32 kernel and the first float32 kernel within float32's
    2e-5 of the float64 reference; at the serving shape (B 2, Hq 24, Hkv 8,
    L 512, D 128) the kernel at most twice as far from it as the plain
    version."""
    arrays = _flash_inputs(lq + lk, b, hq, hkv, lq, lk, d)
    want = t_ref.flash_attention_reference(*arrays, causal)
    q, k, v = (torch.as_tensor(a, device=cuda_device) for a in arrays)
    dist = {}
    for name, fn in (("kernel", fa.flash_attention_cuda),
                     ("first", fa._flash_attention_f32_first_cuda),
                     ("plain", fa.flash_attention_plain)):
        got = fn(q, k, v, causal)
        dist[name] = float(np.abs(got.double().cpu().numpy() - want).max())
    assert dist["kernel"] <= 2e-5 and dist["first"] <= 2e-5, dist
    if (b, hq, hkv, lq, lk, d) == (2, 24, 8, 512, 512, 128):
        assert dist["kernel"] <= 2 * dist["plain"], dist


# the card's decode shapes: the CPU cases, the engine's width at S 1024 and
# S 8192 with seeded lengths, then "edges" lengths (0, 1, a split boundary
# - 1, at and + 1, S, past S) under the kernel's own split plan: at the
# engine's width, at S 8192, S below one tile, S not a whole number of
# tiles; and (B = None) S 8192 with B * Hkv filling the card, one range
DECODE_CUDA_CASES = [c + (None,) for c in DECODE_CASES] + [
    (8, 24, 8, 1024, 128, None), (8, 24, 8, 8192, 128, None),
    (8, 24, 8, 1024, 128, "edges"), (7, 8, 2, 8192, 64, "edges"),
    (5, 6, 2, 20, 32, "edges"), (6, 4, 1, 300, 64, "edges"),
    (None, 32, 32, 8192, 32, "edges"),
    (8, 32, 32, 1024, 96, None),          # phi-3-vision's decode: D 96, rep 1
    # jamba-v0.1-52b's decode (Hq 32, Hkv 8, D 128), then glm4-9b's,
    # qwen2-1.5b's, deepseek-moe-16b's and qwen1.5-0.5b's, each with seeded
    # lengths and at the split edges
    (8, 32, 8, 1024, 128, None), (8, 32, 8, 1024, 128, "edges"),
    (8, 32, 2, 1024, 128, None), (8, 32, 2, 1024, 128, "edges"),
    (8, 12, 2, 1024, 128, None), (8, 12, 2, 1024, 128, "edges"),
    (8, 16, 16, 1024, 128, None), (8, 16, 16, 1024, 128, "edges"),
    (8, 16, 16, 1024, 64, None), (8, 16, 16, 1024, 64, "edges")]
# MLA's absorbed decode, k and v one tensor (the latent): deepseek-v2's
# 128 query heads over one latent head at D 576 (32 head groups of 4) at
# S 1024, S 8192 and the split edges; a rep that no head group divides
# (6 = 4 + 2); a GQA rep x D just past what one block holds (8 x 576); and
# the reduced config's shape (Hq 4, D 48: one head group)
MLA_CUDA_CASES = [
    (8, 128, 1, 1024, 576, None), (8, 128, 1, 8192, 576, None),
    (8, 128, 1, 1024, 576, "edges"), (2, 6, 1, 96, 576, None),
    (2, 16, 2, 100, 576, None), (2, 4, 1, 96, 48, None)]
DECODE_CUDA_CASES += MLA_CUDA_CASES


def _cuda_decode_inputs(device, b, hq, hkv, s, d, lengths):
    """Seeded float32 decode inputs on ``device`` (for an MLA case the
    caches are one tensor) and the kernel's split plan; B = None fills the
    card (one range)."""
    n_sm = da.sm_count(device)
    shared = (b, hq, hkv, s, d, lengths) in MLA_CUDA_CASES
    fill = b is None
    if fill:
        b = -(-da.WAVES * da.BLOCKS_PER_SM * n_sm // hkv)
    q, kc, vc, lens = _decode_inputs(s + b, b, hq, hkv, s, d)
    plan = da.decode_plan(b, hq, hkv, s, d, torch.float32, torch.float32,
                          n_sm, shared)
    assert plan.n_split == 1 or not fill
    if lengths == "edges":
        lens = _edge_lengths(b, s, plan.split_len)
    kc = torch.as_tensor(kc, device=device)
    return (torch.as_tensor(q, device=device), kc,
            kc if shared else torch.as_tensor(vc, device=device),
            torch.as_tensor(lens, device=device), plan.n_split)


def _caches_to(kc, vc, dtype):
    """Both caches in ``dtype``, still one tensor where they were one."""
    k2 = kc.to(getattr(torch, dtype))
    return k2, (k2 if vc is kc else vc.to(getattr(torch, dtype)))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype,tol",
                         [("float32", "bfloat16", 2e-5),
                          ("bfloat16", "float32", 2e-2)])
@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", DECODE_CUDA_CASES)
def test_cuda_decode_mixed_types(cuda_device, b, hq, hkv, s, d, lengths,
                                 q_dtype, kv_dtype, tol):
    """q and caches of different types (float32 weights over a bfloat16
    cache, bfloat16 weights over a float32 one): q is not rounded to the
    cache's type, the output is in q's type, and it is within the
    tolerance of q's type of the plain version, which upcasts each operand
    on its own, in one range and under the kernel's split plan."""
    q, kc, vc, lens, n_split = _cuda_decode_inputs(cuda_device, b, hq, hkv,
                                                   s, d, lengths)
    q = q.to(getattr(torch, q_dtype))
    kc, vc = _caches_to(kc, vc, kv_dtype)
    n_split = da.kernel_plan(q, kc, vc).n_split
    got = ops.decode_attention(q, kc, vc, lens)
    want = da.decode_attention_plain(q, kc, vc, lens)
    split = da.decode_attention_plain(q, kc, vc, lens, n_split=n_split)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), split.float(), atol=tol,
                               rtol=tol)
    if q_dtype == "float32":
        # what a kernel that rounded q to bfloat16 would give
        rounded = da.decode_attention_plain(q.bfloat16().float(), kc, vc,
                                            lens)
        assert float((rounded - want).abs().max()) > tol  # tells apart


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", TOLS)
@pytest.mark.parametrize("b,hq,hkv,s,d,lengths", DECODE_CUDA_CASES)
def test_cuda_decode_matches_plain(cuda_device, b, hq, hkv, s, d, lengths,
                                   dtype, tol):
    q, kc, vc, lens, n_split = _cuda_decode_inputs(cuda_device, b, hq, hkv,
                                                   s, d, lengths)
    q = q.to(getattr(torch, dtype))
    kc, vc = _caches_to(kc, vc, dtype)
    n_split = da.kernel_plan(q, kc, vc).n_split
    before = ops.launch_counts()["decode_attention"]
    got = ops.decode_attention(q, kc, vc, lens)
    want = da.decode_attention_plain(q, kc, vc, lens)
    split = da.decode_attention_plain(q, kc, vc, lens, n_split=n_split)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decode_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got.float(), split.float(), atol=tol,
                               rtol=tol)
    empty = lens == 0
    assert not got[empty].any()


# the shapes and type pairs (q, cache) whose decode outputs are pinned:
# llama3.2-3b's decode with seeded lengths and at the split edges, and
# phi-3-vision's (D 96, rep 1)
DECODE_DIGEST_SHAPES = [(8, 24, 8, 1024, 128, None),
                        (8, 24, 8, 1024, 128, "edges"),
                        (8, 32, 32, 1024, 96, None)]
DECODE_DIGEST_TYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
                       ("float32", "bfloat16")]


def _decode_digest(device, shape, types):
    """sha256 of the decode kernel's output at seeded inputs of ``shape``
    with q and the caches of ``types``."""
    q, kc, vc, lens, _ = _cuda_decode_inputs(device, *shape)
    q = q.to(getattr(torch, types[0]))
    kc, vc = _caches_to(kc, vc, types[1])
    out = da.decode_attention_cuda(q, kc, vc, lens)
    torch.cuda.synchronize()
    return _digest(out)


# sha256 of the decode kernel's output bytes, recorded on an H100 (sm_90a)
# from the kernel as it was before query-head groups were added: at every
# shape it took then, the head groups leave the plan, the blocks and the
# arithmetic as they were
DECODE_DIGESTS = {
    ((8, 24, 8, 1024, 128, None), ('float32', 'float32')):
        "0a4eca4e08864ca87307003bc972c95e36a7e25201fca6d89ab9edd9d55b7f9e",
    ((8, 24, 8, 1024, 128, None), ('bfloat16', 'bfloat16')):
        "6d3acaec0d1e2ee5f9057aff95726b331d3c032dbfa6ad28577f5022078e9e34",
    ((8, 24, 8, 1024, 128, None), ('float32', 'bfloat16')):
        "d11e502c4f3b2faac934aa9e461b5e4ccd0731f7ac1e8be505528c454c2da522",
    ((8, 24, 8, 1024, 128, 'edges'), ('float32', 'float32')):
        "30b1442b03c5a0b7d591eafce901160457b34a488fd2a5802729e334a7f3847d",
    ((8, 24, 8, 1024, 128, 'edges'), ('bfloat16', 'bfloat16')):
        "9e31b8f61b2968ebaca6eb62bd6e1600c194fa57cf0262a891a95adbabc8607e",
    ((8, 24, 8, 1024, 128, 'edges'), ('float32', 'bfloat16')):
        "091ffa261f5af30c2ff565891680cc080112a0e4e77d5c4d24774afbeaf4d431",
    ((8, 32, 32, 1024, 96, None), ('float32', 'float32')):
        "b30c3ea2a0fd4f757881a811ed97cbe511a5e851b7e0d5fc5bfa67e491100bca",
    ((8, 32, 32, 1024, 96, None), ('bfloat16', 'bfloat16')):
        "e1b3c12b4edce855a49e26001e440fa4869334a9fcad907c869b7a7709938da4",
    ((8, 32, 32, 1024, 96, None), ('float32', 'bfloat16')):
        "53d1508ad7597e69afd23d243b2bd9ee3171be94bf9192a0f553409fd40083c5",
}


@pytest.mark.cuda
@pytest.mark.parametrize("types", DECODE_DIGEST_TYPES)
@pytest.mark.parametrize("shape", DECODE_DIGEST_SHAPES)
def test_cuda_decode_digests(cuda_device, shape, types):
    digest = _decode_digest(cuda_device, shape, types)
    assert digest == DECODE_DIGESTS[(shape, types)], digest
