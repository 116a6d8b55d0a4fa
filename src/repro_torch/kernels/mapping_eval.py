"""Pass B of the evaluation engine on the card: the population-parallel
timing recurrence, as two hand-written CUDA kernels and their plain torch
versions.

Every GA generation prices each (batch b, individual p) pair with a
sequential recurrence over the mapping's scheduled op order:

    start_t = max(chip_free[chip_t], max_w end[ppos[t, w]])
    end[t] = chip_free[chip_t] = start_t + t_proc[t]

``ppos`` is the padded predecessor-position layout the structural pass
emits; the sentinel T reads as 0 (the oracle's ``max(..., 0)``).

``mapping_eval`` (kernel ``mapping_eval_kernel<false>`` in
``csrc/mapping_eval.cu``) replaces the TPU kernel
``repro/kernels/mapping_eval.py::mapping_eval`` (body
``_mapping_eval_kernel``): it takes the scheduled ``t_proc`` (B, P, T).
``mapping_eval_fused`` (kernel ``mapping_eval_kernel<true>``) replaces
``repro/kernels/mapping_eval.py::mapping_eval_fused`` (body
``_mapping_eval_fused_kernel``): it also runs pass A, gathering step t's
processing time as ``t_proc[sched_idx[t]]`` from the un-gathered (B, P, L)
cost rows, so the (B, P, T) scheduled tensor is never written.

On the card each kernel has two routes, chosen by shape on the host
(:func:`row_plan`, which reads nothing back from the device). The
**shared** route (one templated body whose switch is pass A) is the main
path: a block serves a few
individuals and all B batches of each, keeps every pair's end row and
chip-free times in shared memory for the whole chain, and has a producer
warp stage the index tiles (and the costs, gathered one tile ahead)
through a ``cp.async`` ring and write the finished rows behind the chain.
What bounds it on an H100 is one chain's latency (T dependent
shared-memory steps) at small P, where every pair is in flight at once,
and instruction issue and shared-memory bandwidth at large P; the bytes
(inputs read once, outputs written once, at 3.35 TB/s) are far below
either. The **global** route (``mapping_eval_global_kernel``,
``mapping_eval_fused_global_kernel``) is the first design, one thread per
pair reading its predecessors back from its global output row; it serves
chains whose end and cost rows do not fit in a block's shared memory
(T + L past about 58,000 / B on an H100). Both routes count as one
launch of their kernel.

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
from typing import NamedTuple

import torch

from . import build

GRID_ORDERS = ("batch_major", "pop_major")
ROUTES = ("shared", "global")
# the shared route's plan: staging tiles tried (steps per tile, largest
# first), producer warps for each chain warp, the threads a block may
# have, and the shared memory the runtime keeps per resident block on
# sm_90
TILES = (32, 16, 8, 4)
LANES = 8          # predecessor lanes a chain step reads as two int4s
PRODUCERS = 2      # producer warps for each chain warp
RAW_STAGES = 3     # raw index tiles in flight (kRawStages in the source)
MAX_THREADS = 512
RESERVED_SMEM = 1024
_GRID_ORDER_ENV = "REPRO_FUSED_GRID_ORDER"
_SOURCE = "mapping_eval.cu"

LAUNCHES = {"mapping_eval": 0, "mapping_eval_fused": 0}
# the same launches by route ("<kernel>:shared" / "<kernel>:global")
ROUTE_LAUNCHES = {f"{k}:{r}": 0 for k in LAUNCHES for r in ROUTES}
_LAUNCH_LOCK = threading.Lock()
_AUTOTUNE_CACHE: dict[tuple, str] = {}


def launch_counts() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)


def route_counts() -> dict[str, int]:
    """The launches since the last reset, split by route."""
    with _LAUNCH_LOCK:
        return dict(ROUTE_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for counts in (LAUNCHES, ROUTE_LAUNCHES):
            for k in counts:
                counts[k] = 0


def default_grid_order() -> str:  # repro-lint: hot
    """``REPRO_FUSED_GRID_ORDER`` if set, else ``batch_major``."""
    # repro-lint: disable=RT004 -- read on every fused launch: the wrappers' host time, ROADMAP R-9
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


def mapping_eval_plain(t_proc, chip, ppos, n_chips: int):  # repro-lint: hot
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


def gather_sched(t_proc_flat, sched_idx):  # repro-lint: hot
    """Pass A: (B, P, L) cost rows, (P, T) flat index -> (B, P, T)."""
    n_batch = t_proc_flat.shape[0]
    idx = sched_idx.long().unsqueeze(0).expand(n_batch, -1, -1)
    return t_proc_flat.gather(2, idx)


def mapping_eval_fused_plain(t_proc, sched_idx, chip, ppos, n_chips: int):
    """Pass A as a torch gather, then :func:`mapping_eval_plain`."""
    return mapping_eval_plain(gather_sched(t_proc.float(), sched_idx), chip,
                              ppos, n_chips)


# --------------------------------------------------------------------------
# The host plan
# --------------------------------------------------------------------------


class RowPlan(NamedTuple):
    """How one call runs: ``route`` ("shared" or "global"), individuals and
    (b, p) pairs per block, threads per block and how many of them are
    producer warps, steps per staged tile, the dynamic shared bytes,
    blocks, and resident blocks per SM by shared memory and threads (the
    card's occupancy calculator may say fewer)."""
    route: str
    ind_per_block: int
    pairs_per_block: int
    threads: int
    producer_warps: int
    tile: int
    smem_bytes: int
    blocks: int
    blocks_per_sm: int


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def smem_bytes(n_batch: int, t_len: int, width: int, n_chips: int,
               n_flat: int, ind: int, tile: int, fused: bool) -> int:
    """Dynamic shared memory of one shared-route block (``layout_of`` in
    ``csrc/mapping_eval.cu``, which refuses a launch whose bytes differ),
    one column per pair: the end rows with a zero and a -inf row, the
    chip-free times, the cost rows (L = ``n_flat``) with a NaN row; then
    RAW_STAGES stages of raw chip, ppos (and sched) tiles, two of placed
    offsets; the pairs' row table."""
    pairs = ind * n_batch
    stride = pairs if ind == 1 else -(-pairs // 32) * 32
    out_width = _up4(max(width, LANES) + 2)
    words = (_up4((t_len + 2) * stride) + _up4(n_chips * stride)
             + _up4((n_flat + 1) * stride)
             + RAW_STAGES * ind * (tile + 4) * (2 if fused else 1)
             + RAW_STAGES * ind * (tile * width + 4)
             + 2 * ind * (tile * out_width + 4) + _up4(2 * pairs))
    return 4 * words


def _producer_warps(pairs: int) -> int:
    return PRODUCERS * -(-pairs // 32)


def _threads(pairs: int) -> int:
    """Chain threads in whole warps, and the producer warps."""
    return 32 * (-(-pairs // 32) + _producer_warps(pairs))


@functools.lru_cache(maxsize=1024)
def row_plan(n_batch: int, pop: int, t_len: int, width: int, n_chips: int,
             n_flat: int, fused: bool, n_sm: int, smem_per_block: int,
             smem_per_sm: int) -> RowPlan:
    """The layout of one call on a card of ``n_sm`` SMs with
    ``smem_per_block`` bytes of shared memory a block may opt in to and
    ``smem_per_sm`` per SM. For each staging tile (largest first) it takes
    the most individuals per block that fit, capped at one block per SM
    for the population (P / n_sm individuals), and keeps the tile that
    needs the fewest waves of blocks. Where not even one individual's B
    rows fit, the route is "global": one thread per pair, 64 a block.
    Plans are cached by their arguments: a launch looks its plan up."""
    best = None
    for tile in TILES:
        if tile > max(4, _up4(t_len)) and tile != TILES[-1]:
            continue

        def fits(ind, tile=tile):
            return (smem_bytes(n_batch, t_len, width, n_chips, n_flat, ind,
                               tile, fused) <= smem_per_block
                    and _threads(ind * n_batch) <= MAX_THREADS)

        if not fits(1):
            continue
        lo, hi = 1, pop
        while lo < hi:                      # the most individuals that fit
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
        ind = min(lo, max(1, -(-pop // n_sm)))
        nbytes = smem_bytes(n_batch, t_len, width, n_chips, n_flat, ind,
                            tile, fused)
        threads = _threads(ind * n_batch)
        per_sm = max(1, min(smem_per_sm // (nbytes + RESERVED_SMEM),
                            2048 // threads, 32))
        blocks = -(-pop // ind)
        waves = -(-blocks // (n_sm * per_sm))
        plan = RowPlan("shared", ind, ind * n_batch, threads,
                       _producer_warps(ind * n_batch), tile, nbytes, blocks,
                       per_sm)
        if best is None or waves < best[0]:
            best = (waves, plan)
    if best is not None:
        return best[1]
    return RowPlan("global", 0, 64, 64, 0, 0, 0, -(-n_batch * pop // 64), 0)


@functools.cache
def _device_limits(index: int) -> tuple[int, int, int]:
    out = (ctypes.c_int * 3)()
    rc = _lib().mapping_eval_device_limits(index, out)
    _raise_on(rc, "mapping_eval_device_limits")
    return tuple(out)


def device_limits(device) -> tuple[int, int, int]:
    """(SM count, shared bytes a block may opt in to, shared bytes per SM)
    of a CUDA device, read once per device."""
    dev = torch.device(device)
    return _device_limits(torch.cuda.current_device() if dev.index is None
                          else dev.index)


# repro-lint: hot
def kernel_plan(t_proc, chip, ppos, n_chips: int, fused: bool) -> RowPlan:
    """The plan the kernel takes for these CUDA operands."""
    n_batch, _, n_flat = t_proc.shape
    pop, t_len = chip.shape
    return row_plan(n_batch, pop, t_len, ppos.shape[-1], n_chips, n_flat,
                    fused, *device_limits(t_proc.device))


def blocks_per_sm(plan: RowPlan, fused: bool, device) -> int:
    """Resident blocks per SM of a shared-route plan, from the card's
    occupancy calculator."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _lib().mapping_eval_blocks_per_sm(int(fused), plan.threads,
                                               plan.smem_bytes,
                                               ctypes.byref(out))
    _raise_on(rc, "mapping_eval_blocks_per_sm")
    return out.value


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
    lib.mapping_eval_rows_launch.argtypes = ([ci] + [vp] * 6 + [ci] * 10
                                             + [ctypes.c_longlong, vp])
    lib.mapping_eval_rows_launch.restype = ci
    lib.mapping_eval_device_limits.argtypes = [ci, ctypes.POINTER(ci)]
    lib.mapping_eval_device_limits.restype = ci
    lib.mapping_eval_blocks_per_sm.argtypes = [ci, ci, ctypes.c_longlong,
                                               ctypes.POINTER(ci)]
    lib.mapping_eval_blocks_per_sm.restype = ci
    lib.mapping_eval_error_string.argtypes = [ci]
    lib.mapping_eval_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, dtype, shape, device):  # repro-lint: hot
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


def _count(name: str, route: str) -> None:
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
        ROUTE_LAUNCHES[f"{name}:{route}"] += 1


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


def _launch(name: str, t_proc, sched_idx, chip, ppos, n_chips: int,
            grid_order: str, route: str | None):  # repro-lint: hot
    """Check the operands, plan the call and launch the route's kernel on
    the current stream (no sync). ``sched_idx`` is None for the unfused
    kernel. ``route`` None takes the plan's; "global" forces the global-row
    kernel (for timing it beside the shared one); "shared" raises where the
    plan cannot take it."""
    order = check_grid_order(grid_order)
    if route not in (None, *ROUTES):
        raise ValueError(f"unknown route {route!r}; choose from {ROUTES}")
    fused = sched_idx is not None
    dev, pop, t_len, width = _common_checks(t_proc, chip, ppos, n_chips)
    n_batch, n_flat = t_proc.shape[0], t_proc.shape[-1]
    if fused:
        _check("sched_idx", sched_idx, torch.int32, (pop, t_len), dev)
    else:
        n_flat = t_len
    _check("t_proc", t_proc, torch.float32, (n_batch, pop, n_flat), dev)
    plan = kernel_plan(t_proc, chip, ppos, n_chips, fused)
    if route == "shared" and plan.route != "shared":
        raise ValueError(f"{name}: T={t_len} rows of {n_batch} batches do "
                         f"not fit a block's shared memory")
    end = torch.empty((n_batch, pop, t_len), dtype=torch.float32, device=dev)
    free = torch.empty((n_batch, pop, n_chips), dtype=torch.float32,
                       device=dev)
    lib = _lib()
    ptrs = (t_proc.data_ptr(), sched_idx.data_ptr() if fused else None,
            chip.data_ptr(), ppos.data_ptr(), end.data_ptr(),
            free.data_ptr())
    route = route or plan.route
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "shared":
            rc = lib.mapping_eval_rows_launch(
                int(fused), *ptrs, n_batch, pop, t_len, width, n_chips,
                n_flat, plan.ind_per_block, plan.tile, plan.producer_warps,
                order, plan.smem_bytes, stream)
        elif fused:
            rc = lib.mapping_eval_fused_launch(
                *ptrs, n_batch, pop, t_len, width, n_chips, n_flat, order,
                stream)
        else:
            rc = lib.mapping_eval_launch(
                ptrs[0], *ptrs[2:], n_batch, pop, t_len, width, n_chips,
                order, stream)
    _raise_on(rc, name)
    _count(name, route)
    return end, free


def mapping_eval_cuda(t_proc, chip, ppos, n_chips: int,  # repro-lint: hot
                      grid_order: str = "batch_major",
                      route: str | None = None):
    """Launch ``mapping_eval_kernel<false>`` (or, for long chains, the
    global-row kernel) on the current stream (no sync): t_proc (B, P, T)
    f32, chip (P, T) i32, ppos (P, T, W) i32, all contiguous on one CUDA
    device -> (end (B, P, T), free (B, P, C)). ``route`` as in
    :func:`_launch`."""
    return _launch("mapping_eval", t_proc, None, chip, ppos, n_chips,
                   grid_order, route)


# repro-lint: hot
def mapping_eval_fused_cuda(t_proc, sched_idx, chip, ppos, n_chips: int,
                            grid_order: str = "batch_major",
                            route: str | None = None):
    """Launch ``mapping_eval_kernel<true>`` (or the fused global-row
    kernel) on the current stream (no sync): t_proc (B, P, L) f32
    un-gathered cost rows, sched_idx (P, T) i32, chip (P, T) i32, ppos
    (P, T, W) i32 -> (end, free)."""
    return _launch("mapping_eval_fused", t_proc, sched_idx, chip, ppos,
                   n_chips, grid_order, route)


# repro-lint: hot
def autotune_grid_order(t_proc, sched_idx, chip, ppos, n_chips: int) -> str:
    """The faster fused grid order for this shape on the card: both orders
    are launched once to warm up and once under CUDA events, and the
    choice is cached per (B, P, L, T, W, C). ``REPRO_FUSED_GRID_ORDER``
    always wins; CPU tensors never probe (the plain version has no grid)."""
    # repro-lint: disable=RT004 -- read on every fused launch: the wrappers' host time, ROADMAP R-9
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
