"""Mamba-2 SSD (state-space duality) chunked scan on the card: one
hand-written CUDA kernel and its plain torch version.

For each (batch, head), with B and C shared across heads and a zero
initial (N, P) state S, chunk by chunk over the sequence:

    cum   = cumsum(a * dt)                                   (within the chunk)
    y[t] += sum_{u <= t} (C_t . B_u) exp(cum_t - cum_u) dt_u x_u   (intra)
    y[t] += exp(cum_t) C_t S                                         (inter)
    S     = exp(cum_last) S + sum_u dt_u exp(cum_last - cum_u) B_u x_u^T

which equals the sequential recurrence S_t = exp(a dt_t) S_{t-1} +
dt_t B_t x_t^T, y_t = C_t S_t (``ref.ssd_reference``) up to float32
rounding. The kernel ``ssd_scan_kernel`` in ``csrc/ssd_scan.cu`` replaces
the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan`` (body
``_ssd_kernel``), whose grid walks the chunks of one (batch * head) in
order and keeps the state in VMEM between them. What bounds it on an H100
is operations: per (batch, head, chunk) 2 Q N P for the inter term, 2 Q N P
for the state update and 2 Q^2 P for the intra term, plus 2 Q^2 N per
(batch, chunk) for C B^T — at the serving shapes about 80x more
operations than bytes at the float32 rate. This first version does them as
float32 FMAs from shared memory (no tensor cores): one block per
(batch, head, 64-column tile of P) walks the chunks in a loop, with the
state in shared memory for the whole sequence, so x, dt, B and C are read
once per block and y and the state written once. Its chunk is 64
positions, not the TPU's 128, so that the block's tiles (x, the state,
C B^T and one 32-wide slice of B and C) fit twice into an SM; the chunk
length changes only the rounding, not the function. ``wgmma`` tiles and
sharing C B^T across heads are later work.

The plain version is also the model's eager SSD (``models/mamba2.py``,
the JAX package's ``_ssd_xla``): it takes an initial state, which the
kernel does not.

Beside the kernel: a launch counter (:data:`LAUNCHES`), bumped once per
launch and nowhere else. :mod:`repro_torch.kernels.ops` dispatches between
the two by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from . import build
from .decode_attention import DTYPES

_SOURCE = "ssd_scan.cu"
DEFAULT_CHUNK = 128
KERNEL_CHUNK = 64          # the CUDA kernel's chunk (csrc/ssd_scan.cu kChunk)
MAX_STATE = 256            # the largest N the kernel's shared state holds

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


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library (built on first use), with its C signatures."""
    lib = build.load(_SOURCE)
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = (
        [ci] + [vp] * 7 + [ci] * 5 + [ll] * 10 + [vp])
    lib.ssd_scan_launch.restype = ci
    lib.ssd_scan_error_string.argtypes = [ci]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, device, shape):
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


def ssd_scan_cuda(x, dt, a, b_mat, c_mat):
    """Launch ``ssd_scan_kernel`` on the current stream (no sync): x
    [B, L, H, P] and b_mat/c_mat [B, L, N] (float32 or bfloat16, one dtype,
    last dimension contiguous, any other strides: the slices of a fused
    projection go in without a copy), dt [B, L, H] and a [H] float32, N up
    to 256 -> (y contiguous [B, L, H, P] in x's dtype, final state
    contiguous [B, H, N, P] float32). The kernel's chunk is
    :data:`KERNEL_CHUNK`."""
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
    y = torch.empty((bsz, l, h, p), dtype=x.dtype, device=dev)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ssd_scan_launch(
            DTYPES[x.dtype], x.data_ptr(), dt.data_ptr(), a.data_ptr(),
            b_mat.data_ptr(), c_mat.data_ptr(), y.data_ptr(),
            state.data_ptr(), bsz, l, h, p, n, *x.stride()[:3],
            *dt.stride()[:3], b_mat.stride(0), b_mat.stride(1),
            c_mat.stride(0), c_mat.stride(1), stream)
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc} ({msg})")
    with _LAUNCH_LOCK:
        LAUNCHES["ssd_scan"] += 1
    return y, state
