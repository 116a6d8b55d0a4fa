"""Mamba-2 SSD (state-space duality) chunked scan on the card: two
hand-written CUDA kernels behind one launcher, and their plain torch
version.

For each (batch, head), with B and C shared across heads and a zero
initial (N, P) state S, chunk by chunk over the sequence:

    cum   = cumsum(a * dt)                                   (within the chunk)
    y[t] += sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u   (intra)
    y[t] += exp(cum_t) C_t S                                         (inter)
    S     = exp(cum_last) S + sum_u dt_u exp(cum_last - cum_u) B_u x_u^T

which equals the sequential recurrence S_t = exp(a dt_t) S_{t-1} +
dt_t B_t x_t^T, y_t = C_t S_t (``ref.ssd_reference``) up to float32
rounding. The kernels in ``csrc/ssd_scan.cu`` replace the TPU kernel
``repro/kernels/ssd_scan.py::ssd_scan`` (body ``_ssd_kernel``), whose grid
walks the chunks of one (batch * head) in order and keeps the state in
VMEM. What bounds them on an H100 is operations: per (batch, head, chunk)
2 Q N P for the inter term, 2 Q N P for the state update and 2 Q^2 P for
the intra term, plus 2 Q^2 N per (batch, chunk) for C B^T -- at the serving
shapes about 80x more operations than bytes at the float32 FMA rate. TF32
tensor cores would round the inputs past the 1e-4 tolerance, so both
dtypes run float32 FMAs (bfloat16 inputs widened in shared memory). Two
launches: ``ssd_state_kernel`` carries each (batch, head, 32 columns of P,
64 state rows) part of the state across the chunks in order, in
registers, and writes the state each chunk starts from to a workspace (in
B L / Q more blocks it forms C B^T once per (batch, chunk) for all heads);
``ssd_y_kernel`` then forms every chunk's y independently from that state
and the decay-masked C B^T. At the prefill shape that is 656 blocks of
128 threads and 1,280 of 256 (the first version ran 160 blocks that
walked the chunks in series). Each block stages its operands through a two-stage
``cp.async`` ring. What bounds the pair today is as much the ~125 MB each
moves from L2 to shared memory (B re-read for every head and column tile,
C for every head) as the FMAs. The chunk is 64 positions, not the TPU's
128; the chunk length changes only the rounding, not the function. The
workspace (:func:`ssd_plan`: B H (L / Q) N P float32 states and the C B^T
tiles) comes from torch's allocator on the call's stream. The first
version stays as ``ssd_serial_kernel``, reached only by
:func:`_ssd_scan_serial_cuda`, the partner the card's smoke run times in
turns with the new kernels.

The plain version is also the model's eager SSD (``models/mamba2.py``,
the JAX package's ``_ssd_xla``): it takes an initial state, which the
kernels do not.

Beside the kernels: a launch counter (:data:`LAUNCHES`), bumped once per
call of :func:`ssd_scan_cuda` (its two device kernels are one launch)
and nowhere else. :mod:`repro_torch.kernels.ops` dispatches between
the two by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from .decode_attention import DTYPES

_SOURCE = "ssd_scan.cu"
DEFAULT_CHUNK = 128
KERNEL_CHUNK = 64          # the CUDA kernel's chunk (csrc/ssd_scan.cu kChunk)
MAX_STATE = 256            # the largest N the kernels take
MAX_SMEM = 232_448         # shared bytes a block may use on an H100

LAUNCHES = {"ssd_scan": 0}
_LAUNCH_LOCK = threading.Lock()


def launch_counts() -> dict[str, int]:
    with _LAUNCH_LOCK:
        return dict(LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        LAUNCHES["ssd_scan"] = 0


def ssd_chunked(x, dt, a, b_mat, c_mat, init_state, chunk: int = DEFAULT_CHUNK):
    """The chunked SSD from ``init_state`` in float32 torch ops: x
    [B, L, H, P], dt [B, L, H], a [H], b_mat/c_mat [B, L, N], init_state
    [B, H, N, P] -> (y [B, L, H, P] float32, final state [B, H, N, P]
    float32). L is padded with zeros to a multiple of ``chunk``; a padded
    position has dt = 0 and x = 0, so it leaves the state as it is."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    nc = -(-l // chunk)
    pad = nc * chunk - l
    f32 = torch.float32
    xq = F.pad(x.to(f32), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, chunk, h, p)
    dtq = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(bsz, nc, chunk, h)
    bq = F.pad(b_mat.to(f32), (0, 0, 0, pad)).reshape(bsz, nc, chunk, n)
    cq = F.pad(c_mat.to(f32), (0, 0, 0, pad)).reshape(bsz, nc, chunk, n)
    a = a.to(f32)
    if nc == 0:
        return xq.new_zeros((bsz, 0, h, p)), init_state.to(f32)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    state = init_state.to(f32)
    ys = []
    for c in range(nc):
        xc, dtc, bc, cc = xq[:, c], dtq[:, c], bq[:, c], cq[:, c]
        cum = torch.cumsum(a[None, None, :] * dtc, dim=1)        # [B, Q, H]
        seg = cum[:, :, None, :] - cum[:, None, :, :]            # [B, Q, U, H]
        # exp only where u <= t: the upper triangle would overflow
        decay = torch.exp(torch.where(causal, seg, 0.0)) * causal
        g = torch.einsum("bqn,bun->bqu", cc, bc)                 # [B, Q, U]
        gd = g[..., None] * decay * dtc[:, None, :, :]           # [B, Q, U, H]
        y_intra = torch.einsum("bquh,buhp->bqhp", gd, xc)
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "bqn,bhnp->bqhp", cc, state)
        w = dtc * torch.exp(cum[:, -1:, :] - cum)                # [B, Q, H]
        upd = torch.einsum("bqn,bqhp->bhnp", bc, w[..., None] * xc)
        state = torch.exp(cum[:, -1, :])[:, :, None, None] * state + upd
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(bsz, nc * chunk, h, p)[:, :l]
    return y, state


def ssd_scan_plain(x, dt, a, b_mat, c_mat, chunk: int = DEFAULT_CHUNK):
    """The TPU kernel's function in torch ops: from a zero state, chunk
    ``min(chunk, max(L, 8))`` -> (y [B, L, H, P] in x's dtype, final state
    [B, H, N, P] float32)."""
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1]
    init = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    y, state = ssd_chunked(x, dt, a, b_mat, c_mat, init,
                           min(chunk, max(l, 8)))
    return y.to(x.dtype), state


def _pitch(cols: int, item: int) -> int:
    """A shared tile row: ``cols`` elements and one 16-byte chunk of
    padding (``pitch_of`` in ``csrc/ssd_scan.cu``)."""
    return cols + 16 // item


def _r256(n: int) -> int:
    return -(-n // 256) * 256


class SsdPlan(NamedTuple):
    """How one call of :func:`ssd_scan_cuda` is cut (``dims_of``,
    ``workspace_of`` and the ``*Layout`` structs in ``csrc/ssd_scan.cu``,
    which refuse a launch whose bytes differ)."""
    chunks: int          # ceil(L / KERNEL_CHUNK)
    p_tiles: int         # y blocks: 64 columns of P a tile
    s_tiles: int         # state blocks: 32 columns of P a tile ...
    n_tiles: int         # ... and 64 state rows
    p_pad: int           # workspace row: P rounded up to 4
    cb_blocks: int       # C B^T: one block per (batch, chunk)
    state_blocks: int    # states: (batch, head, P tile, N tile), in order
    y_blocks: int        # y: (batch, chunk, head, P tile)
    workspace_bytes: int  # the chunks' incoming states and C B^T, float32
    state_smem: int      # dynamic shared bytes of a state / C B^T block
    y_smem: int          # ... of a y block


@functools.lru_cache(maxsize=1024)
def ssd_plan(n_batch: int, length: int, heads: int, p: int, n: int,
             itemsize: int) -> SsdPlan:
    """The plan of a call at x [n_batch, length, heads, p], B/C [.., n]
    with ``itemsize`` bytes per element of x, B and C (4 or 2)."""
    q = KERNEL_CHUNK
    chunks = -(-length // q)
    p_tiles, s_tiles, n_tiles = -(-p // 64), -(-p // 32), -(-n // 64)
    p_pad = -(-p // 4) * 4
    head = 3 * q * 4
    f32 = itemsize == 4
    # state blocks: two chunks' dt, then ring stages of half a chunk: B
    # (32 positions x 64 state rows) and x (32 x 32)
    stage = 32 * (_pitch(64, itemsize) + _pitch(32, itemsize)) * itemsize
    wide = 0 if f32 else 4 * 32 * (_pitch(64, 4) + _pitch(32, 4))
    state_smem = 2 * q * 4 + 2 * stage + wide
    # y blocks: 32 state rows or positions a slice (C or C B^T, S or x)
    a_bytes = max(q * _pitch(32, itemsize) * itemsize, q * _pitch(32, 4) * 4)
    b_bytes = max(32 * _pitch(64, 4) * 4, 32 * _pitch(64, itemsize) * itemsize)
    wide = 0 if f32 else 4 * (q * _pitch(32, 4) + 32 * _pitch(64, 4))
    y_smem = head + 2 * (a_bytes + b_bytes) + wide
    work = _r256(4 * n_batch * heads * chunks * n * p_pad) \
        + 4 * n_batch * chunks * q * q
    return SsdPlan(chunks, p_tiles, s_tiles, n_tiles, p_pad,
                   n_batch * chunks, n_batch * heads * s_tiles * n_tiles,
                   n_batch * chunks * heads * p_tiles, work, state_smem,
                   y_smem)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signatures of a library built from ``_SOURCE``."""
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = (
        [ci] + [vp] * 8 + [ll] + [ci] * 7 + [ll] * 10 + [vp])
    lib.ssd_scan_launch.restype = ci
    lib.ssd_scan_serial_launch.argtypes = (
        [ci] + [vp] * 7 + [ci] * 5 + [ll] * 10 + [vp])
    lib.ssd_scan_serial_launch.restype = ci
    lib.ssd_scan_error_string.argtypes = [ci]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (built on first use), with its C signatures."""
    return bind(build.load(_SOURCE))


def _check(name, t, dtype, device, shape):  # repro-lint: hot
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name} needs a contiguous last dimension; got "
                         f"strides {t.stride()}")


def _operands(x, dt, a, b_mat, c_mat):  # repro-lint: hot
    """Check the kernels' operands; returns (B, L, H, P, N)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if x.dtype not in DTYPES:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, L, H, P], got {tuple(x.shape)}")
    bsz, l, h, p = x.shape
    n = b_mat.shape[-1] if isinstance(b_mat, torch.Tensor) else -1
    _check("x", x, x.dtype, dev, (bsz, l, h, p))
    _check("dt", dt, torch.float32, dev, (bsz, l, h))
    _check("a", a, torch.float32, dev, (h,))
    _check("b_mat", b_mat, x.dtype, dev, (bsz, l, n))
    _check("c_mat", c_mat, x.dtype, dev, (bsz, l, n))
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"state size N = {n} is not in [1, {MAX_STATE}]")
    if bsz > 65_535 or h > 65_535:
        raise ValueError(f"B = {bsz} or H = {h} exceeds the grid's 65,535")
    return bsz, l, h, p, n


def _strides(x, dt, b_mat, c_mat):  # repro-lint: hot
    return (*x.stride()[:3], *dt.stride()[:3], b_mat.stride(0),
            b_mat.stride(1), c_mat.stride(0), c_mat.stride(1))


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def ssd_scan_cuda(x, dt, a, b_mat, c_mat):  # repro-lint: hot
    """Launch the SSD kernels on the current stream (no sync): x
    [B, L, H, P] and b_mat/c_mat [B, L, N] (float32 or bfloat16, one dtype,
    last dimension contiguous, any other strides: the slices of a fused
    projection go in without a copy), dt [B, L, H] and a [H] float32, N up
    to 256 -> (y contiguous [B, L, H, P] in x's dtype, final state
    contiguous [B, H, N, P] float32). The kernels' chunk is
    :data:`KERNEL_CHUNK`; the workspace of :func:`ssd_plan` comes from
    torch's allocator."""
    bsz, l, h, p, n = _operands(x, dt, a, b_mat, c_mat)
    dev = x.device
    plan = ssd_plan(bsz, l, h, p, n, x.element_size())
    if max(plan.state_blocks + plan.cb_blocks, plan.y_blocks) >= 2 ** 31:
        raise ValueError(f"B {bsz} x L {l} x H {h} x P {p} needs more "
                         f"blocks than one launch takes")
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    work = torch.empty((plan.workspace_bytes,), dtype=torch.uint8,
                       device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_launch(
            DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
            state.data_ptr(), work.data_ptr(), plan.workspace_bytes,
            plan.state_smem, plan.y_smem, bsz, l, h, p, n,
            *_strides(x, dt, b_mat, c_mat), stream)
    _raise_on(rc, "ssd_scan")
    with _LAUNCH_LOCK:
        LAUNCHES["ssd_scan"] += 1
    return y, state


def _ssd_scan_serial_cuda(x, dt, a, b_mat, c_mat):
    """The first version of the kernel (one block per (batch, head, 64
    columns of P) walking the chunks in series), same operands and
    results as :func:`ssd_scan_cuda`. Not on any path and not counted: the
    card's smoke run times it in turns with the new kernels."""
    bsz, l, h, p, n = _operands(x, dt, a, b_mat, c_mat)
    dev = x.device
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_serial_launch(
            DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
            state.data_ptr(), bsz, l, h, p, n,
            *_strides(x, dt, b_mat, c_mat), stream)
    _raise_on(rc, "ssd_scan (serial)")
    return y, state
