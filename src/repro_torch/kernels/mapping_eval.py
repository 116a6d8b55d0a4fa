"""Pass B of the evaluation engine on the card: the population-parallel
timing recurrence, as two hand-written CUDA kernels and their plain torch
versions.

Every GA generation prices each (batch b, individual p) pair with a
sequential recurrence over the mapping's scheduled op order:

    start_t = max(chip_free[chip_t], max_w end[ppos[t, w]])
    end[t] = chip_free[chip_t] = start_t + t_proc[t]

``ppos`` is the padded predecessor-position layout the structural pass
emits; the sentinel T reads as 0 (the oracle's ``max(..., 0)``).

``mapping_eval`` (kernel ``mapping_eval_kernel`` in
``csrc/mapping_eval.cu``) replaces the TPU kernel
``repro/kernels/mapping_eval.py::mapping_eval`` (body
``_mapping_eval_kernel``): it takes the scheduled ``t_proc`` (B, P, T).
``mapping_eval_fused`` (kernel ``mapping_eval_fused_kernel``) replaces
``repro/kernels/mapping_eval.py::mapping_eval_fused`` (body
``_mapping_eval_fused_kernel``): it also runs pass A, gathering step t's
processing time as ``t_proc[sched_idx[t]]`` from the un-gathered (B, P, L)
cost rows, so the (B, P, T) scheduled tensor is never written.

What bounds them on an H100: each (b, p) pair is a T-step chain of
dependent loads, so a pair's time is T load latencies, not bytes; the
bytes (inputs read once, outputs written once) bound the whole call at
3.35 TB/s only once enough pairs are in flight to hide that chain. This
first design runs one thread per pair (6,144 threads at B = 3, P = 2048 —
too few to fill 132 SMs) and is latency-bound; shared-memory rows, a warp
per pair and overlapped loads are left for later revisions.

Each kernel keeps beside it: its plain torch version (the CPU path and the
card's parity partner, bitwise equal by construction: one exact max chain
and one add per step in the same order) and a launch counter
(:data:`LAUNCHES`), bumped once per launch and nowhere else.
:mod:`repro_torch.kernels.ops` dispatches between the two by the device of
the tensors it is given.
"""
from __future__ import annotations

import ctypes
import functools
import os
import threading

import torch

from . import build

GRID_ORDERS = ("batch_major", "pop_major")
_GRID_ORDER_ENV = "REPRO_FUSED_GRID_ORDER"
_SOURCE = "mapping_eval.cu"

LAUNCHES = {"mapping_eval": 0, "mapping_eval_fused": 0}
_LAUNCH_LOCK = threading.Lock()
_AUTOTUNE_CACHE: dict[tuple, str] = {}


def launch_counts() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def default_grid_order() -> str:
    """``REPRO_FUSED_GRID_ORDER`` if set, else ``batch_major``."""
    order = os.environ.get(_GRID_ORDER_ENV, "batch_major")
    if order not in GRID_ORDERS:
        raise ValueError(f"{_GRID_ORDER_ENV}={order!r}; "
                         f"choose from {GRID_ORDERS}")
    return order


def check_grid_order(order: str) -> int:
    if order not in GRID_ORDERS:
        raise ValueError(f"unknown grid order {order!r}; "
                         f"choose from {GRID_ORDERS}")
    return GRID_ORDERS.index(order)


# --------------------------------------------------------------------------
# Plain torch versions
# --------------------------------------------------------------------------


def mapping_eval_plain(t_proc, chip, ppos, n_chips: int):
    """The recurrence over T as torch ops, vectorised over (B, P):
    (B, P, T) f32, (P, T), (P, T, W) -> (end (B, P, T), free (B, P, C)).
    Slot T of the end vector is the sentinel and stays 0."""
    n_batch, pop, t_len = t_proc.shape
    width = ppos.shape[-1]
    dev = t_proc.device
    end = torch.zeros((n_batch, pop, t_len + 1), dtype=torch.float32,
                      device=dev)
    free = torch.zeros((n_batch, pop, n_chips), dtype=torch.float32,
                       device=dev)
    chip = chip.long()
    ppos = ppos.long()
    t_proc = t_proc.float()
    for t in range(t_len):
        pp = ppos[:, t, :].unsqueeze(0).expand(n_batch, pop, width)
        pred = end.gather(2, pp).amax(dim=2)
        c = chip[:, t].view(1, pop, 1).expand(n_batch, pop, 1)
        fin = torch.maximum(free.gather(2, c).squeeze(2), pred) \
            + t_proc[:, :, t]
        end[:, :, t] = fin
        free.scatter_(2, c, fin.unsqueeze(2))
    return end[:, :, :t_len].contiguous(), free


def gather_sched(t_proc_flat, sched_idx):
    """Pass A: (B, P, L) cost rows, (P, T) flat index -> (B, P, T)."""
    n_batch = t_proc_flat.shape[0]
    idx = sched_idx.long().unsqueeze(0).expand(n_batch, -1, -1)
    return t_proc_flat.gather(2, idx)


def mapping_eval_fused_plain(t_proc, sched_idx, chip, ppos, n_chips: int):
    """Pass A as a torch gather, then :func:`mapping_eval_plain`."""
    return mapping_eval_plain(gather_sched(t_proc.float(), sched_idx), chip,
                              ppos, n_chips)


# --------------------------------------------------------------------------
# CUDA launchers
# --------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (built on first use), with every entry's C
    signature declared: pointers and the stream as ``c_void_p``."""
    lib = build.load(_SOURCE)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mapping_eval_launch.argtypes = [vp] * 5 + [ci] * 6 + [vp]
    lib.mapping_eval_launch.restype = ci
    lib.mapping_eval_fused_launch.argtypes = [vp] * 6 + [ci] * 7 + [vp]
    lib.mapping_eval_fused_launch.restype = ci
    lib.mapping_eval_error_string.argtypes = [ci]
    lib.mapping_eval_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got "
                        f"{type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().mapping_eval_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _count(name: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


def _common_checks(t_proc, chip, ppos, n_chips):
    dev = t_proc.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if t_proc.dim() != 3 or chip.dim() != 2 or ppos.dim() != 3:
        raise ValueError("expected t_proc (B, P, *), chip (P, T), "
                         "ppos (P, T, W)")
    pop, t_len = chip.shape
    width = ppos.shape[-1]
    if width < 1 or n_chips < 1:
        raise ValueError(f"need W >= 1 and n_chips >= 1, got W={width}, "
                         f"n_chips={n_chips}")
    _check("chip", chip, torch.int32, (pop, t_len), dev)
    _check("ppos", ppos, torch.int32, (pop, t_len, width), dev)
    return dev, pop, t_len, width


def mapping_eval_cuda(t_proc, chip, ppos, n_chips: int,
                      grid_order: str = "batch_major"):
    """Launch ``mapping_eval_kernel`` on the current stream (no sync):
    t_proc (B, P, T) f32, chip (P, T) i32, ppos (P, T, W) i32, all
    contiguous on one CUDA device -> (end (B, P, T), free (B, P, C))."""
    order = check_grid_order(grid_order)
    dev, pop, t_len, width = _common_checks(t_proc, chip, ppos, n_chips)
    n_batch = t_proc.shape[0]
    _check("t_proc", t_proc, torch.float32, (n_batch, pop, t_len), dev)
    end = torch.empty((n_batch, pop, t_len), dtype=torch.float32, device=dev)
    free = torch.empty((n_batch, pop, n_chips), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mapping_eval_launch(
            t_proc.data_ptr(), chip.data_ptr(), ppos.data_ptr(),
            end.data_ptr(), free.data_ptr(), n_batch, pop, t_len, width,
            n_chips, order, stream)
    _raise_on(rc, "mapping_eval")
    _count("mapping_eval")
    return end, free


def mapping_eval_fused_cuda(t_proc, sched_idx, chip, ppos, n_chips: int,
                            grid_order: str = "batch_major"):
    """Launch ``mapping_eval_fused_kernel`` on the current stream (no
    sync): t_proc (B, P, L) f32 un-gathered cost rows, sched_idx (P, T)
    i32, chip (P, T) i32, ppos (P, T, W) i32 -> (end, free)."""
    order = check_grid_order(grid_order)
    dev, pop, t_len, width = _common_checks(t_proc, chip, ppos, n_chips)
    n_batch, _, n_flat = t_proc.shape
    _check("t_proc", t_proc, torch.float32, (n_batch, pop, n_flat), dev)
    _check("sched_idx", sched_idx, torch.int32, (pop, t_len), dev)
    end = torch.empty((n_batch, pop, t_len), dtype=torch.float32, device=dev)
    free = torch.empty((n_batch, pop, n_chips), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mapping_eval_fused_launch(
            t_proc.data_ptr(), sched_idx.data_ptr(), chip.data_ptr(),
            ppos.data_ptr(), end.data_ptr(), free.data_ptr(), n_batch, pop,
            t_len, width, n_chips, n_flat, order, stream)
    _raise_on(rc, "mapping_eval_fused")
    _count("mapping_eval_fused")
    return end, free


def autotune_grid_order(t_proc, sched_idx, chip, ppos, n_chips: int) -> str:
    """The faster fused grid order for this shape on the card: both orders
    are launched once to warm up and once under CUDA events, and the
    choice is cached per (B, P, L, T, W, C). ``REPRO_FUSED_GRID_ORDER``
    always wins; CPU tensors never probe (the plain version has no grid)."""
    if os.environ.get(_GRID_ORDER_ENV) or t_proc.device.type != "cuda":
        return default_grid_order()
    key = (tuple(t_proc.shape), chip.shape[-1], ppos.shape[-1], n_chips,
           t_proc.device.index)
    hit = _AUTOTUNE_CACHE.get(key)
    if hit is not None:
        return hit
    times = {}
    with torch.cuda.device(t_proc.device):
        for order in GRID_ORDERS:
            mapping_eval_fused_cuda(t_proc, sched_idx, chip, ppos, n_chips,
                                    order)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            mapping_eval_fused_cuda(t_proc, sched_idx, chip, ppos, n_chips,
                                    order)
            stop.record()
            stop.synchronize()
            times[order] = start.elapsed_time(stop)
    best = min(times, key=times.get)
    _AUTOTUNE_CACHE[key] = best
    return best
