"""Mamba-2 mixer (SSD — state-space duality form): train, prefill, extend
and decode paths.

Projections and gating are plain torch; the sequence mixing runs through
one of, chosen by ``impl``:

* ``"eager"`` — the chunked SSD in torch ops (the JAX package's
  ``impl="xla"`` path, ``_ssd_xla``): :func:`repro_torch.kernels.ssd_scan.
  ssd_chunked`, which takes an initial state;
* ``"kernel"`` — ``ops.ssd_scan`` (the hand-written kernel on a CUDA
  tensor, its plain version on a CPU tensor), from a zero state.

As in the JAX package, only the full-sequence paths (``mamba_train``,
``mamba_prefill``) reach the kernel: ``mamba_extend`` continues an existing
state, which the kernel does not take, so it runs the eager chunked SSD
under both impls, and ``mamba_decode`` is the one-step recurrence in torch
ops. There is no short causal convolution (the JAX package replaces it by
an identity; the SSD mixing itself is faithful).

Caches are ``{"state": [B, H, N, P] float32, "len": [B] int32}``. Unlike
the attention cache, whose K/V rows are written in place, every path
returns a NEW state tensor and leaves the one it was given as it was; the
caller keeps the returned cache (the serving engine writes a slot's row
back, :mod:`repro_torch.serving.engine`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ops
from ..kernels.ssd_scan import ssd_chunked
from .layers import Dense, RMSNorm, _param, dense, rmsnorm


class Mamba(nn.Module):
    """``in_proj`` (d, 2 d_inner + 2 N + H), the fused projection to
    [z (gate), x, B, C, dt]; ``out_proj`` (d_inner, d); ``a_log`` and
    ``dt_bias`` (H,) float32, zero as the JAX package initialises them
    (A = -exp(a_log) = -1); ``norm`` (d_inner,)."""

    def __init__(self, cfg, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.mamba_heads
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.in_proj = Dense(d, 2 * di + 2 * n + h, False, **kw)
        self.out_proj = Dense(di, d, False, **kw)
        self.a_log = _param((h,), torch.float32, device, 0.0)
        self.dt_bias = _param((h,), torch.float32, device, 0.0)
        self.norm = RMSNorm(di, dtype=dtype, device=device)


def _split_proj(p, x, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = dense(p.in_proj, x)
    z = zxbcdt[..., :di]
    xs = zxbcdt[..., di:2 * di]
    b_mat = zxbcdt[..., 2 * di:2 * di + n]
    c_mat = zxbcdt[..., 2 * di + n:2 * di + 2 * n]
    dt = F.softplus(zxbcdt[..., 2 * di + 2 * n:].float() + p.dt_bias)
    return z, xs, b_mat, c_mat, dt


def _heads(cfg):
    h = cfg.mamba_heads
    return h, cfg.d_inner // h


def _gate_out(p, y, z, x, cfg):
    """Gate by silu(z), normalise, project out. y: [B, L, H, P]."""
    bsz, l = y.shape[:2]
    y = y.reshape(bsz, l, cfg.d_inner).to(x.dtype)
    y = rmsnorm(p.norm, y * F.silu(z))
    return dense(p.out_proj, y)


def _mix(p, x, cfg, impl):
    """Full-sequence SSD mixing from a zero state -> (y, final state)."""
    bsz, l, _ = x.shape
    h, pdim = _heads(cfg)
    z, xs, b_mat, c_mat, dt = _split_proj(p, x, cfg)
    xh = xs.reshape(bsz, l, h, pdim)
    a = -torch.exp(p.a_log)
    if impl == "kernel":
        y, state = ops.ssd_scan(xh, dt, a, b_mat, c_mat)
    else:
        init = torch.zeros((bsz, h, cfg.ssm_state, pdim), dtype=torch.float32,
                           device=x.device)
        y, state = ssd_chunked(xh, dt, a, b_mat, c_mat, init)
    return _gate_out(p, y, z, x, cfg), state


def mamba_train(p, x, cfg, impl="eager"):
    """Full-sequence SSD mixing. x: [B, L, d] -> [B, L, d]."""
    return _mix(p, x, cfg, impl)[0]


def mamba_prefill(p, x, cfg, cache, impl="kernel"):
    """Prefill: mix the prompt and return its final recurrent state."""
    bsz, l, _ = x.shape
    out, state = _mix(p, x, cfg, impl)
    return out, {"state": state,
                 "len": torch.full((bsz,), l, dtype=torch.int32,
                                   device=x.device)}


def mamba_extend(p, x, cfg, cache, impl="kernel", length=None):
    """Multi-token extension from an existing recurrent state (the eager
    chunked SSD under both impls). ``length`` ([B], optional): true chunk
    length when x is right-padded. Pad positions get dt = 0, which makes
    them exact identities on the recurrent state (decay exp(a * 0) = 1,
    update weight dt = 0)."""
    bsz, l, _ = x.shape
    h, pdim = _heads(cfg)
    z, xs, b_mat, c_mat, dt = _split_proj(p, x, cfg)
    if length is not None:
        valid = torch.arange(l, device=x.device)[None, :] < length[:, None]
        dt = dt * valid[..., None]
    xh = xs.reshape(bsz, l, h, pdim)
    a = -torch.exp(p.a_log)
    y, state = ssd_chunked(xh, dt, a, b_mat, c_mat, cache["state"].float())
    adv = l if length is None else length
    return _gate_out(p, y, z, x, cfg), {
        "state": state, "len": (cache["len"] + adv).to(torch.int32)}


def mamba_decode(p, x, cfg, cache, impl="kernel"):
    """One-token recurrence in torch ops under both impls. x: [B, 1, d]."""
    bsz = x.shape[0]
    h, pdim = _heads(cfg)
    z, xs, b_mat, c_mat, dt = _split_proj(p, x, cfg)
    xh = xs.reshape(bsz, h, pdim).float()
    a = -torch.exp(p.a_log)
    dt1 = dt[:, 0, :]                                     # [B, H]
    decay = torch.exp(a[None, :] * dt1)
    upd = torch.einsum("bn,bhp->bhnp", b_mat[:, 0].float(),
                       xh * dt1[..., None])
    state = cache["state"] * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", c_mat[:, 0].float(), state)
    return _gate_out(p, y[:, None], z, x, cfg), {
        "state": state, "len": cache["len"] + 1}


def init_mamba_cache(cfg, batch: int, device=None):
    """Zero ``{"state": [B, H, N, P] float32, "len": [B] int32}`` on
    ``device`` (resolved by the caller): the state is float32 whatever the
    attention cache's type."""
    h, pdim = _heads(cfg)
    return {"state": torch.zeros((batch, h, cfg.ssm_state, pdim),
                                 dtype=torch.float32, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
