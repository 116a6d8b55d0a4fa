"""Blocked online-softmax GQA attention on the card (the prefill path): two
hand-written CUDA kernels, one per storage type, and their plain torch
version.

    o[b, h, i] = softmax_j(q[b, h, i] . k[b, h // rep, j] * scale) @ v[b, h // rep, j]

over keys j < Lk and, when causal, j <= i + (Lk - Lq): the queries sit at
the end of the Lk-long context. Both kernels, in ``csrc/flash_attention.cu``,
replace the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(body ``_flash_kernel``): online softmax over key tiles held in shared
memory with float32 running max, sum and accumulator, tiles wholly past the
causal frontier skipped, padding guarded by ``kpos < Lk``, a masked score
-1e30 with its weight zeroed after the exp, and a division by the sum where
it is not 0. What bounds them on an H100 is operations, 4 * B * Hq * D per
visible (query, key) pair, at the rate of the inputs' type.

* float32 goes to ``flash_attention_kernel``: float32 FMAs (TF32 tensor
  cores would round the inputs past float32's tolerance), so its bound is
  67 TFLOP/s. Each thread owns 8 query rows: an 8 x 4 tile of the scores
  of a 64-key tile and an 8 x D / 16 tile of the output, fed by float4
  reads of row-major Q, K, V and weight tiles in shared memory; one K and
  one V buffer take ``cp.async`` copies, each in flight while the other
  product runs; every head's last query tile goes out first. Its tiles,
  shared bytes, grid and block order come from :func:`flash_f32_plan`,
  which the C launcher checks.
* bfloat16 goes to ``flash_attention_bf16_kernel``: FlashAttention-2's
  structure on the tensor cores (``mma.sync`` m16n8k16 with float32
  accumulators, ``ldmatrix``, a 2-stage ``cp.async`` K/V ring), bound by
  989 TFLOP/s. It rounds the softmax weights to bfloat16 before the
  product with V, as SDPA does; the plain version does not, which the
  bfloat16 tolerance covers. ``wgmma``, TMA and warp specialisation are
  later work.

The first float32 kernel (scalar shared-memory reads, synchronous tile
loads) stays as ``flash_attention_f32_first_kernel``, reached only by
:func:`_flash_attention_f32_first_cuda`, which no path calls and which is
not counted: the card's smoke run times it in turns with the new kernel.

Beside the kernels: their plain torch version (the CPU path and the card's
parity partner) and one launch counter per kernel (:data:`LAUNCHES`),
bumped once per launch and nowhere else. :mod:`repro_torch.kernels.ops`
dispatches between kernel and plain version by the device of the tensors it
is given.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from . import build
from .decode_attention import DTYPES, NEG_INF, _check_operand, _scale

_SOURCE = "flash_attention.cu"
HEAD_DIMS = (32, 64, 96, 128)
# the float32 kernel's layout (kF32* in the source)
F32_BLOCK_Q = 64           # queries per block
F32_BLOCK_K = 64           # keys per K/V tile
F32_THREADS = 128
MAX_SMEM_BLOCK = 232_448   # shared bytes a block may use on an H100
SMEM_PER_SM = 233_472      # shared bytes of an SM ...
SMEM_RESERVED = 1_024      # ... of which the runtime keeps this per block
THREADS_PER_SM = 2_048

# the kernel each storage type reaches, by its launch counter's name
KERNEL_OF = {torch.float32: "flash_attention",
             torch.bfloat16: "flash_attention_bf16"}
LAUNCHES = {name: 0 for name in KERNEL_OF.values()}
_LAUNCH_LOCK = threading.Lock()


def launch_counts() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def flash_attention_plain(q, k, v, causal: bool = True, scale=None):
    """q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] -> [B, Hq, Lq, D] in q's
    dtype: the kernel's arithmetic as torch ops, float32 throughout (one
    pass over all keys; the kernel's online rescaling gives the same
    values up to float32 rounding)."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.float().reshape(b, hkv, rep, lq, d)
    s = torch.einsum("bgrqd,bgkd->bgrqk", qg, k.float()) * _scale(d, scale)
    if causal:
        qi = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
        ki = torch.arange(lk, device=q.device)[None, :]
        mask = ki <= qi
    else:
        mask = torch.ones((lq, lk), dtype=torch.bool, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bgrqk,bgkd->bgrqd", p, v.float())
    o = o / torch.where(l == 0, 1.0, l)
    return o.reshape(b, hq, lq, d).to(q.dtype)


def f32_smem_bytes(d: int) -> int:
    """Dynamic shared memory of one float32 block (``f32_smem_bytes`` in
    ``csrc/flash_attention.cu``): the Q tile, one K and one V tile, rows of
    D floats (no padding: the Q and K chunks are permuted instead), and the
    weights."""
    return 4 * (F32_BLOCK_Q * d + 2 * F32_BLOCK_K * d
                + F32_BLOCK_Q * F32_BLOCK_K)


class FlashF32Plan(NamedTuple):
    """How one float32 call runs: tiles, threads, the grid (x = b * Hq + h
    fastest, y the query tile from the last), dynamic shared bytes and the
    blocks an SM holds by shared memory and threads."""
    lq: int
    lk: int
    block_q: int
    block_k: int
    threads: int
    q_tiles: int
    grid: tuple[int, int]
    blocks: int
    smem_bytes: int
    blocks_per_sm: int

    def block(self, i: int) -> tuple[int, int]:
        """(b * Hq + h, query tile) of the i-th block in launch order
        (linear index x + y * grid_x): every head's last query tile first."""
        x, y = i % self.grid[0], i // self.grid[0]
        return x, self.q_tiles - 1 - y

    def key_tiles(self, q_tile: int, causal: bool) -> int:
        """K/V tiles the block of ``q_tile`` walks: up to the causal
        frontier of its last query (or Lk), none past it."""
        end = self.lk
        if causal:
            end = min(self.lk, min((q_tile + 1) * self.block_q, self.lq)
                      + self.lk - self.lq)
        return -(-end // self.block_k) if end > 0 else 0


@functools.lru_cache(maxsize=1024)
def flash_f32_plan(b: int, hq: int, hkv: int, lq: int, lk: int,
                   d: int) -> FlashF32Plan:
    """The plan of a float32 call at q [b, hq, lq, d], k/v [b, hkv, lk, d],
    from the shapes alone."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    q_tiles = -(-lq // F32_BLOCK_Q)
    nbytes = f32_smem_bytes(d)
    per_sm = min(SMEM_PER_SM // (nbytes + SMEM_RESERVED),
                 THREADS_PER_SM // F32_THREADS)
    return FlashF32Plan(lq, lk, F32_BLOCK_Q, F32_BLOCK_K, F32_THREADS,
                        q_tiles, (b * hq, q_tiles), b * hq * q_tiles, nbytes,
                        per_sm)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a library built from ``_SOURCE``."""
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [ci] + [vp] * 4 + [ci] * 7 + [ctypes.c_float] + [ll] * 9 + [ci] * 3
        + [vp])
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_f32_first_launch.argtypes = (
        [vp] * 4 + [ci] * 7 + [ctypes.c_float] + [ll] * 9 + [vp])
    lib.flash_attention_f32_first_launch.restype = ci
    lib.flash_attention_f32_blocks_per_sm.argtypes = [ci, vp]
    lib.flash_attention_f32_blocks_per_sm.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (built on first use), with its C signatures."""
    return bind(build.load(_SOURCE))


def f32_blocks_per_sm(d: int, device) -> int:
    """Resident blocks per SM of the float32 kernel at head dim ``d`` on
    ``device``, from the card's occupancy calculator."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _lib().flash_attention_f32_blocks_per_sm(d, ctypes.byref(out))
    _raise_on(rc, "the flash_attention occupancy query")
    return out.value


def _operands(q, k, v):
    """Check the kernels' operands; returns (B, Hq, Hkv, Lq, Lk, D)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, q.dtype, dev, 4)
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if tuple(k.shape) != (b, hkv, lk, d) or tuple(v.shape) != (b, hkv, lk, d):
        raise ValueError(f"k and v must be [B, Hkv, Lk, D] = [{b}, Hkv, Lk, "
                         f"{d}] alike; got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if b * hq > 65_535 or -(-lq // 64) > 65_535:
        raise ValueError(f"B * Hq = {b * hq} or Lq / 64 = {-(-lq // 64)} "
                         f"exceeds the grid's 65,535")
    return b, hq, hkv, lq, lk, d


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().flash_attention_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def flash_attention_cuda(q, k, v, causal: bool = True, scale=None):
    """Launch the kernel of q's dtype (``flash_attention_kernel`` for
    float32, under :func:`flash_f32_plan`; ``flash_attention_bf16_kernel``
    for bfloat16) on the current stream (no sync): q [B, Hq, Lq, D], k/v
    [B, Hkv, Lk, D] (one dtype, D in {32, 64, 96, 128} and contiguous; rows
    starting on 16-byte boundaries: any strides over (b, h, l) that are
    multiples of 8 and a 16-byte aligned start, so the transposed views of
    a [B, L, H, D] projection go in without a copy) -> contiguous
    [B, Hq, Lq, D] in q's dtype."""
    b, hq, hkv, lq, lk, d = _operands(q, k, v)
    dev = q.device
    plan = (0, 0, 0)
    if q.dtype == torch.float32:
        p = flash_f32_plan(b, hq, hkv, lq, lk, d)
        plan = (p.block_q, p.block_k, p.smem_bytes)
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, hq, hkv, lq, lk, d, int(bool(causal)),
            _scale(d, scale), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *plan, stream)
    _raise_on(rc, "flash_attention launch")
    with _LAUNCH_LOCK:
        LAUNCHES[KERNEL_OF[q.dtype]] += 1
    return out


def _flash_attention_f32_first_cuda(q, k, v, causal: bool = True,
                                    scale=None):
    """The first float32 kernel (``flash_attention_f32_first_kernel``),
    same operands and result as :func:`flash_attention_cuda` in float32.
    Not on any path and not counted: the card's smoke run times it in turns
    with the new kernel."""
    b, hq, hkv, lq, lk, d = _operands(q, k, v)
    if q.dtype != torch.float32:
        raise TypeError(f"the first flash kernel takes float32, got "
                        f"{q.dtype}")
    dev = q.device
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_f32_first_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            hkv, lq, lk, d, int(bool(causal)), _scale(d, scale),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], stream)
    _raise_on(rc, "flash_attention launch (first float32 kernel)")
    return out
