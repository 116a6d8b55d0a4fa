"""GQA KV-cache decode attention on the card: a hand-written split-S
("flash-decoding") CUDA kernel and its plain torch version.

One new token per sequence attends over its cache,

    o[b, h] = softmax_t(q[b, h] . k[b, t, h // rep] * scale) @ v[b, t, h // rep]

over the positions t < lengths[b] (clamped to the cache length S). The
kernels in ``csrc/decode_attention.cu`` replace the TPU kernel
``repro/kernels/decode_attention.py::decode_attention`` (body
``_decode_kernel``). Like it, one block serves all query heads of a kv
group wherever their q rows and sums fit a block, so each K/V row of the
cache is read once per sequence; where they do not (MLA's absorbed decode:
128 query heads over one latent kv head at D 576, which the TPU kernel
holds as one ``(hq, d)`` VMEM scratch), :func:`decode_plan` gives each
block a group of ``hpb`` heads and the ``n_hg`` groups of a kv head each
read its rows; running max,
sum and accumulator are float32, a masked score is -1e30 and its weight is
zeroed after the exp, and the output divides by the sum where it is not 0.
Like it, it takes q and a cache of different types (float32 weights over
the bfloat16 cache that ``init_cache`` defaults to, or bfloat16 weights
over a float32 cache), upcasting each operand on its own, and returns q's
type. What bounds it on an H100 is bytes: the live K/V rows,
sum(len) * Hkv * D * 2 * itemsize, at 3.35 TB/s (half that where K and V
are one tensor, as MLA's latent is).

Unlike the TPU kernel, which walks S in order on one core, the card needs
parallelism over S: :func:`split_plan` cuts the cache into ``n_split``
ranges of ``split_len`` positions from the shapes and the card's SM count
alone (no device value is read, so a call never syncs), one block per
(sequence, kv head, head group, range) streams its range through a ring of
asynchronous copies, and ``decode_attention_combine_kernel`` merges the
ranges' partial (max, sum, accumulator) in a second launch. One wrapper
call is one launch on :data:`LAUNCHES`, but two device kernels when
``n_split > 1``.

Beside the kernel: its plain torch version (the CPU path and the card's
parity partner, which follows any split plan it is given) and a launch
counter (:data:`LAUNCHES`), bumped once per launch and nowhere else.
:mod:`repro_torch.kernels.ops` dispatches between the two by the device of
the tensors it is given.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from . import build

_SOURCE = "decode_attention.cu"
NEG_INF = -1e30
MAX_HEAD_DIM = 576
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's split plan: positions per tile (kTile in the source), the
# shortest range worth a block of its own, and the blocks to aim for on
# each SM (WAVES x BLOCKS_PER_SM of them); MIN_SPLIT_LEN and BLOCKS_PER_SM
# were chosen on an H100 with tools/decode_split_sweep.py
TILE = 32
MIN_SPLIT_LEN = 64
WAVES = 2
BLOCKS_PER_SM = 4

# the kernel's block (kThreads, kHeads, kMaxAcc, kStages, kMaxSmem in the
# source): threads, heads per scoring pass and p @ V unit, float32 sums a
# thread may hold, K/V ring stages, and shared bytes a block may use
THREADS = 128
UNIT_HEADS = 4
MAX_ACC = 32
STAGES = 2
MAX_SMEM = 232_448

LAUNCHES = {"decode_attention": 0}
_LAUNCH_LOCK = threading.Lock()


def launch_counts() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES["decode_attention"] = 0


def _scale(d: int, scale: float | None) -> float:
    return float(1.0 / (d ** 0.5)) if scale is None else float(scale)


def split_len_of(s: int, n_split: int) -> int:
    """Positions per range when S is cut into ``n_split`` ranges: a whole
    number of tiles, at least one."""
    per = -(-s // n_split)
    return max(TILE, -(-per // TILE) * TILE)


def split_plan(b: int, hkv: int, s: int, n_sm: int,
               n_hg: int = 1) -> tuple[int, int]:
    """(n_split, split_len) for B sequences of Hkv kv heads, each served by
    ``n_hg`` head groups, over a cache of S positions on a card of ``n_sm``
    SMs: enough ranges for WAVES waves of BLOCKS_PER_SM blocks on every SM,
    none shorter than MIN_SPLIT_LEN, and one range once B * Hkv * n_hg
    blocks fill the card. The ranges cover S; the last ones may start past
    it (their blocks write empty partials)."""
    cap = max(1, -(-s // MIN_SPLIT_LEN))
    want = -(-WAVES * n_sm * BLOCKS_PER_SM // max(1, b * hkv * n_hg))
    n_split = min(max(want, 1), cap)
    return n_split, split_len_of(s, n_split)


def _padded(heads: int) -> int:
    return -(-heads // UNIT_HEADS) * UNIT_HEADS


def smem_bytes(heads: int, d: int, kv_dtype, shared: bool = False) -> int:
    """Dynamic shared bytes of a block serving ``heads`` query heads
    (``smem_bytes`` in the source): the ring in the cache's type (a K and
    a V tile per stage, one tile where K and V are one tensor), or the
    p @ V partials that reuse it, whichever is larger, then float32 q rows,
    weights and three floats per head."""
    size = kv_dtype.itemsize
    ring = size * (1 if shared else 2) * STAGES * TILE * d
    red = 4 * UNIT_HEADS * (16 // size) * THREADS
    floats = heads * d + TILE * _padded(heads) + 3 * heads
    return max(ring, red) + 4 * floats


def heads_fit(heads: int, d: int, kv_dtype, shared: bool = False) -> bool:
    """Whether one block holds ``heads`` query heads at head dim ``d``:
    their (UNIT_HEADS heads, 16-byte chunk) p @ V units fit the threads'
    MAX_ACC sums, and the block's shared bytes fit MAX_SMEM."""
    vec = 16 // kv_dtype.itemsize
    units = _padded(heads) // UNIT_HEADS * (d // vec)
    return units <= THREADS * (MAX_ACC // (UNIT_HEADS * vec)) \
        and smem_bytes(heads, d, kv_dtype, shared) <= MAX_SMEM


class DecodePlan(NamedTuple):
    """How one call runs: heads per block, head groups per kv head, the
    split of S, each block's dynamic shared bytes, and the split grid
    (B * Hkv * n_hg, n_split)."""
    hpb: int
    n_hg: int
    n_split: int
    split_len: int
    smem_bytes: int
    grid: tuple[int, int]

    def heads(self, hq: int, hkv: int, x: int) -> range:
        """The query heads block row ``x`` of the grid serves."""
        rep = hq // hkv
        bg, i = divmod(x, self.n_hg)
        g = bg % hkv
        return range(g * rep + i * self.hpb,
                     g * rep + min(rep, (i + 1) * self.hpb))


def decode_plan(b: int, hq: int, hkv: int, s: int, d: int, q_dtype,
                kv_dtype, n_sm: int, shared: bool = False) -> DecodePlan:
    """The plan of a call at q [b, hq, d] of ``q_dtype`` over caches
    [b, s, hkv, d] of ``kv_dtype`` (``shared``: k and v are one tensor) on
    a card of ``n_sm`` SMs, from the shapes alone: all ``rep = hq / hkv``
    heads in one block where they fit (one head group, and the split plan
    of the kernel without head groups), else the largest multiple of
    UNIT_HEADS that fits."""
    if q_dtype not in DTYPES or kv_dtype not in DTYPES:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q and "
                        f"caches; got q {q_dtype}, cache {kv_dtype}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 in "
                         f"[8, {MAX_HEAD_DIM}]")
    rep = hq // hkv
    fits = [h for h in [rep, *range((rep - 1) // UNIT_HEADS * UNIT_HEADS, 0,
                                    -UNIT_HEADS)]
            if heads_fit(h, d, kv_dtype, shared)]
    if not fits:
        raise ValueError(f"no head group fits a block at D {d} over a "
                         f"{kv_dtype} cache with separate K and V tensors "
                         f"(its K/V ring alone takes "
                         f"{smem_bytes(0, d, kv_dtype)} of {MAX_SMEM} "
                         f"shared bytes)")
    hpb = fits[0]
    n_hg = -(-rep // hpb)
    n_split, split_len = split_plan(b, hkv, s, n_sm, n_hg)
    return DecodePlan(hpb, n_hg, n_split, split_len,
                      smem_bytes(hpb, d, kv_dtype, shared),
                      (b * hkv * n_hg, n_split))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The SM count of a CUDA device (read once per device)."""
    dev = torch.device(device)
    return _sm_count(torch.cuda.current_device() if dev.index is None
                     else dev.index)


def shared_kv(k_cache, v_cache) -> bool:
    """Whether k and v are one tensor (MLA's latent cache passed as both):
    the same start, shape and strides."""
    return k_cache.data_ptr() == v_cache.data_ptr() \
        and k_cache.shape == v_cache.shape \
        and k_cache.stride() == v_cache.stride()


def kernel_plan(q, k_cache, v_cache) -> DecodePlan:  # repro-lint: hot
    """The plan the kernel takes for these CUDA operands."""
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    return decode_plan(b, hq, hkv, s, d, q.dtype, k_cache.dtype,
                       sm_count(q.device), shared_kv(k_cache, v_cache))


def decode_attention_plain(q, k_cache, v_cache, lengths, scale=None,
                           n_split: int = 1):
    """q [B, Hq, D], caches [B, S, Hkv, D], lengths [B] -> [B, Hq, D] in
    q's dtype: the kernel's arithmetic as torch ops, float32 throughout.
    With ``n_split == 1``, one pass over all S positions (the kernel's
    online rescaling gives the same values up to float32 rounding); with
    more, the kernel's split: each range of ``split_len_of(S, n_split)``
    positions gives a partial (max, sum, accumulator), and the partials are
    merged as the combine kernel merges them."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    qg = q.float().reshape(b, hkv, rep, d)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, k_cache.float()) \
        * _scale(d, scale)
    lengths = lengths.to(q.device)
    if n_split == 1:
        pos = torch.arange(s, device=q.device)
        mask = (pos[None, :] < lengths[:, None])[:, None, None, :]
        logits = torch.where(mask, logits, NEG_INF)
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(logits - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bgrs,bsgd->bgrd", p, v_cache.float())
        o = o / torch.where(l == 0, 1.0, l)
        return o.reshape(b, hq, d).to(q.dtype)
    split_len = split_len_of(s, n_split)
    pad = n_split * split_len - s
    pos = torch.arange(s + pad, device=q.device)
    mask = (pos[None, :] < lengths.clamp(max=s)[:, None])
    mask = mask.reshape(b, 1, 1, n_split, split_len)
    logits = torch.nn.functional.pad(logits, (0, pad), value=NEG_INF)
    logits = torch.where(mask, logits.reshape(b, hkv, rep, n_split,
                                              split_len), NEG_INF)
    vf = torch.nn.functional.pad(v_cache.float(), (0, 0, 0, 0, 0, pad))
    m = logits.amax(dim=-1, keepdim=True)              # [b, g, r, n, 1]
    p = torch.where(mask, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1)                                  # [b, g, r, n]
    acc = torch.einsum("bgrnt,bntgd->bgrnd", p,
                       vf.reshape(b, n_split, split_len, hkv, d))
    m = m[..., 0]
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))    # [b, g, r, n]
    total = (l * w).sum(dim=-1, keepdim=True)
    o = (acc * w[..., None]).sum(dim=-2) / torch.where(total == 0, 1.0,
                                                       total)
    return o.reshape(b, hq, d).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library (built on first use), with its C signatures."""
    return bind(build.load(_SOURCE))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a library built from ``_SOURCE``."""
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention_launch.argtypes = (
        [ci] * 2 + [vp] * 6 + [ci] * 10 + [ctypes.c_float] + [ll] * 8
        + [vp])
    lib.decode_attention_launch.restype = ci
    lib.decode_attention_blocks_per_sm.argtypes = [ci, ci, ci, vp]
    lib.decode_attention_blocks_per_sm.restype = ci
    lib.decode_attention_error_string.argtypes = [ci]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def blocks_per_sm(plan: DecodePlan, q_dtype, kv_dtype, device) -> int:
    """Resident split blocks per SM under ``plan`` on ``device``, from the
    card's occupancy calculator."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _lib().decode_attention_blocks_per_sm(
            DTYPES[kv_dtype], DTYPES[q_dtype], plan.smem_bytes,
            ctypes.byref(out))
    if rc != 0:
        msg = _lib().decode_attention_error_string(rc).decode()
        raise RuntimeError(f"decode_attention occupancy query failed: CUDA "
                           f"error {rc} ({msg})")
    return out.value


def _check_operand(name, x, dtype, device, dims):  # repro-lint: hot
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got "
                        f"{type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != dims:
        raise ValueError(f"{name} must have {dims} dimensions, got "
                         f"{tuple(x.shape)}")
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]) \
            or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous last dimension, "
                         f"strides that are multiples of 8 elements and a "
                         f"16-byte aligned start; got strides {x.stride()}")


# repro-lint: hot
def decode_attention_cuda(q, k_cache, v_cache, lengths, scale=None):
    """Launch ``decode_attention_kernel`` and, when the split plan has more
    than one range, ``decode_attention_combine_kernel`` on the current
    stream (no sync): q [B, Hq, D] and k/v caches [B, S, Hkv, D] (float32
    or bfloat16, the caches of one dtype, q of its own; D a multiple of 8
    up to 576, D contiguous; k and v may be one tensor), lengths [B] int32
    -> [B, Hq, D] in q's dtype, under :func:`decode_plan`."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    kv_dtype = getattr(k_cache, "dtype", None)
    if q.dtype not in DTYPES or kv_dtype not in DTYPES:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q and "
                        f"caches; got q {q.dtype}, cache {kv_dtype}")
    _check_operand("q", q, q.dtype, dev, 3)
    _check_operand("k_cache", k_cache, kv_dtype, dev, 4)
    _check_operand("v_cache", v_cache, kv_dtype, dev, 4)
    b, hq, d = q.shape
    _, s, hkv, _ = k_cache.shape
    if tuple(k_cache.shape) != (b, s, hkv, d) \
            or tuple(v_cache.shape) != (b, s, hkv, d):
        raise ValueError(f"caches must be [B, S, Hkv, D] = [{b}, S, Hkv, "
                         f"{d}] alike; got {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)}")
    if not isinstance(lengths, torch.Tensor) or lengths.device != dev \
            or lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,) \
            or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous int32 [{b}] tensor "
                         f"on {dev}")
    shared = shared_kv(k_cache, v_cache)
    plan = decode_plan(b, hq, hkv, s, d, q.dtype, kv_dtype,
                       _sm_count(dev.index), shared)
    n_split = plan.n_split
    lib = _lib()
    out = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    part = torch.empty((b, hq, n_split, d + 2), dtype=torch.float32,
                       device=dev) if n_split > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.decode_attention_launch(
            DTYPES[kv_dtype], DTYPES[q.dtype], q.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), b, s,
            hq, hkv, d, int(shared), plan.hpb, plan.smem_bytes, n_split,
            plan.split_len,
            _scale(d, scale), q.stride(0),
            q.stride(1), *k_cache.stride()[:3], *v_cache.stride()[:3], stream)
    if rc != 0:
        msg = lib.decode_attention_error_string(rc).decode()
        raise RuntimeError(f"decode_attention launch failed: CUDA error {rc} "
                           f"({msg})")
    with _LAUNCH_LOCK:
        LAUNCHES["decode_attention"] += 1
    return out
