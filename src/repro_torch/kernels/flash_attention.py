"""Blocked online-softmax GQA attention on the card (the prefill path): one
hand-written CUDA kernel and its plain torch version.

    o[b, h, i] = softmax_j(q[b, h, i] . k[b, h // rep, j] * scale) @ v[b, h // rep, j]

over keys j < Lk and, when causal, j <= i + (Lk - Lq): the queries sit at
the end of the Lk-long context. The kernel ``flash_attention_kernel`` in
``csrc/flash_attention.cu`` replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (body
``_flash_kernel``): float32 online softmax over key tiles held in shared
memory, tiles wholly past the causal frontier skipped, padding guarded by
``kpos < Lk``, a masked score -1e30 with its weight zeroed after the exp,
and a division by the sum where it is not 0. What bounds it on an H100 is
operations, 4 * B * Hq * D per visible (query, key) pair, at the rate of
the inputs' type; this first version does its products as float32 FMAs
(no tensor cores, no TMA), so in bfloat16 it is far from the tensor-core
bound. ``wgmma`` tiles are later work.

Beside the kernel: its plain torch version (the CPU path and the card's
parity partner) and a launch counter (:data:`LAUNCHES`), bumped once per
launch and nowhere else. :mod:`repro_torch.kernels.ops` dispatches between
the two by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import build
from .decode_attention import DTYPES, NEG_INF, _check_operand, _scale

_SOURCE = "flash_attention.cu"
HEAD_DIMS = (32, 64, 96, 128)

LAUNCHES = {"flash_attention": 0}
_LAUNCH_LOCK = threading.Lock()


def launch_counts() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES["flash_attention"] = 0


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


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library (built on first use), with its C signatures."""
    lib = build.load(_SOURCE)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [ci] + [vp] * 4 + [ci] * 7 + [ctypes.c_float] + [ll] * 9 + [vp])
    lib.flash_attention_launch.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention_cuda(q, k, v, causal: bool = True, scale=None):
    """Launch ``flash_attention_kernel`` on the current stream (no sync):
    q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] (float32 or bfloat16, one dtype,
    D in {32, 64, 96, 128} and contiguous; any strides over (b, h, l) that
    are multiples of 8, so the transposed views of a [B, L, H, D]
    projection go in without a copy) -> contiguous [B, Hq, Lq, D] in q's
    dtype."""
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
    if b * hq > 65_535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's 65,535")
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(
            DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, hq, hkv, lq, lk, d, int(bool(causal)),
            _scale(d, scale), *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc} "
                           f"({msg})")
    with _LAUNCH_LOCK:
        LAUNCHES["flash_attention"] += 1
    return out
