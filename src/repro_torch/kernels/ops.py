"""Device dispatch for the hand-written kernels, and the dispatch counters.

A wrapper here routes by the device of the tensors it is given: a CUDA
tensor goes to the hand kernel (which raises on anything it does not take),
a CPU tensor goes to the kernel's plain torch version, and any other device
raises. There is no fallback from one to the other. Every call is counted
under the path that actually ran (``"<kernel>:cuda"`` or
``"<kernel>:plain"``) in :func:`dispatch_stats`; the timing backends count
their own non-kernel paths (``dense``, ``oracle``) in the same registry.
"""
from __future__ import annotations

import threading

import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import mapping_eval as _me
from . import ssd_scan as _ss

_DISPATCH: dict[str, int] = {}
_DISPATCH_LOCK = threading.Lock()


def record_dispatch(path: str, n: int = 1) -> None:
    with _DISPATCH_LOCK:
        _DISPATCH[path] = _DISPATCH.get(path, 0) + n


def dispatch_stats() -> dict[str, int]:
    with _DISPATCH_LOCK:
        return dict(_DISPATCH)


def clear_dispatch_stats() -> None:
    with _DISPATCH_LOCK:
        _DISPATCH.clear()


def route(x) -> str:  # repro-lint: hot
    """``"cuda"`` for a CUDA tensor, ``"plain"`` for a CPU tensor."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel path for device {x.device}")


def launch_counts() -> dict[str, int]:
    """CUDA launches per hand-written kernel since the last reset."""
    return {**_me.launch_counts(), **_da.launch_counts(),
            **_fa.launch_counts(), **_ss.launch_counts()}


def reset_launch_counts() -> None:
    for mod in (_me, _da, _fa, _ss):
        mod.reset_launch_counts()


def mapping_eval(t_proc, chip, ppos, n_chips: int,  # repro-lint: hot
                 grid_order: str = "batch_major"):
    """Pass B: t_proc (B, P, T), chip (P, T), ppos (P, T, W) ->
    (end (B, P, T), free (B, P, C))."""
    path = route(t_proc)
    if path == "cuda":
        out = _me.mapping_eval_cuda(t_proc, chip, ppos, n_chips, grid_order)
    else:
        _me.check_grid_order(grid_order)
        out = _me.mapping_eval_plain(t_proc, chip, ppos, n_chips)
    record_dispatch(f"mapping_eval:{path}")
    return out


def mapping_eval_fused(t_proc, sched_idx, chip, ppos, n_chips: int,
                       grid_order: str | None = None):  # repro-lint: hot
    """Pass A + B: ``t_proc`` is the UN-gathered (B, P, L) cost rows,
    gathered per step via ``sched_idx`` (P, T). ``grid_order=None`` asks
    the autotune probe on the card (:func:`default_grid_order` on CPU)."""
    path = route(t_proc)
    if grid_order is None:
        grid_order = _me.autotune_grid_order(t_proc, sched_idx, chip, ppos,
                                             n_chips)
    if path == "cuda":
        out = _me.mapping_eval_fused_cuda(t_proc, sched_idx, chip, ppos,
                                          n_chips, grid_order)
    else:
        _me.check_grid_order(grid_order)
        out = _me.mapping_eval_fused_plain(t_proc, sched_idx, chip, ppos,
                                           n_chips)
    record_dispatch(f"mapping_eval_fused:{path}")
    return out


# repro-lint: hot
def decode_attention(q, k_cache, v_cache, lengths, scale=None):
    """One-token GQA decode: q [B, Hq, D], caches [B, S, Hkv, D], lengths
    [B] int32 -> [B, Hq, D] in q's dtype. q and the caches are float32 or
    bfloat16 on both routes (an int8 cache is refused, as the kernel
    refuses it: the model dequantizes one and attends eagerly)."""
    path = route(q)
    if path == "cuda":
        out = _da.decode_attention_cuda(q, k_cache, v_cache, lengths, scale)
    else:
        types = (q.dtype, k_cache.dtype, v_cache.dtype)
        if any(t not in _da.DTYPES for t in types):
            raise TypeError(f"decode_attention takes float32 or bfloat16 q "
                            f"and caches; got q {q.dtype}, caches "
                            f"{k_cache.dtype} / {v_cache.dtype}")
        out = _da.decode_attention_plain(q, k_cache, v_cache, lengths, scale)
    record_dispatch(f"decode_attention:{path}")
    return out


# repro-lint: hot
def flash_attention(q, k, v, causal: bool = True, scale=None):
    """Blocked GQA attention: q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D] ->
    [B, Hq, Lq, D] in q's dtype; causal with offset Lk - Lq. q, k and v
    share one head dim D on every route, as in the TPU kernel."""
    path = route(q)
    dims = tuple(x.shape[-1] for x in (q, k, v))
    if len(set(dims)) != 1:
        raise ValueError(f"flash_attention takes one head dim for q, k and "
                         f"v; got {dims}")
    if path == "cuda":
        out = _fa.flash_attention_cuda(q, k, v, causal, scale)
    else:
        out = _fa.flash_attention_plain(q, k, v, causal, scale)
    record_dispatch(f"flash_attention:{path}")
    return out


# repro-lint: hot
def ssd_scan(x, dt, a, b_mat, c_mat, chunk: int = _ss.DEFAULT_CHUNK):
    """Mamba-2 SSD chunked scan from a zero state: x [B, L, H, P], dt
    [B, L, H] float32, a [H] float32, b_mat/c_mat [B, L, N] -> (y
    [B, L, H, P] in x's dtype, final state [B, H, N, P] float32).
    ``chunk`` is the plain version's chunk; the CUDA kernel's is its own
    (:data:`repro_torch.kernels.ssd_scan.KERNEL_CHUNK`), and the chunk
    length changes only the rounding."""
    path = route(x)
    if path == "cuda":
        out = _ss.ssd_scan_cuda(x, dt, a, b_mat, c_mat)
    else:
        out = _ss.ssd_scan_plain(x, dt, a, b_mat, c_mat, chunk)
    record_dispatch(f"ssd_scan:{path}")
    return out
