"""Primitive layers: dense, norms, RoPE, embeddings.

Each parametrised layer is a small :class:`torch.nn.Module` whose
parameters carry the JAX package's pytree names (``w``/``b`` of a dense
layer, ``g``/``b`` of a norm, ``e`` of an embedding), and the apply
functions take the module the way the JAX package's take the parameter
dict. Dense weights keep the JAX layout ``(d_in, d_out)`` with
``y = x @ w``, so carrying weights across is a copy. Parameters are made
with ``requires_grad=False``, so serving builds no autograd graph; the
train loop turns it on (:func:`repro_torch.training.train_loop.
init_train_state`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _param(shape, dtype, device, fill: float | None = None) -> nn.Parameter:
    t = (torch.empty(shape, dtype=dtype, device=device) if fill is None
         else torch.full(shape, fill, dtype=dtype, device=device))
    return nn.Parameter(t, requires_grad=False)


def _normal(shape, generator, dtype, device, std: float) -> nn.Parameter:
    """Standard normal draws from ``generator`` (on ``device``) times
    ``std``, cast to ``dtype``."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return nn.Parameter((x * std).to(dtype), requires_grad=False)


class Dense(nn.Module):
    """``w`` (d_in, d_out) and, with ``bias``, ``b`` (d_out,). With a
    generator, ``w`` is drawn N(0, 1/d_in) (or N(0, scale^2)) and ``b`` is
    zero; without one the tensors are left uninitialised for a copy."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 dtype=torch.float32, device=None, generator=None,
                 scale: float | None = None):
        super().__init__()
        std = 1.0 / np.sqrt(d_in) if scale is None else scale
        self.w = (_normal((d_in, d_out), generator, dtype, device, float(std))
                  if generator is not None
                  else _param((d_in, d_out), dtype, device))
        self.b = _param((d_out,), dtype, device, 0.0) if bias else None


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.g = _param((d,), dtype, device, 1.0)


class LayerNorm(nn.Module):
    def __init__(self, d: int, dtype=torch.float32, device=None):
        super().__init__()
        self.g = _param((d,), dtype, device, 1.0)
        self.b = _param((d,), dtype, device, 0.0)


class Embedding(nn.Module):
    """``e`` (vocab, d), drawn N(0, 0.02^2) with a generator."""

    def __init__(self, vocab: int, d: int, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        self.e = (_normal((vocab, d), generator, dtype, device, 0.02)
                  if generator is not None
                  else _param((vocab, d), dtype, device))


def dense(p: Dense, x):
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


def rmsnorm(p: RMSNorm, x, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.g).to(x.dtype)


def layernorm(p: LayerNorm, x, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p.g + p.b).to(x.dtype)


def embed(p: Embedding, tokens):
    return p.e[tokens]


@functools.lru_cache(maxsize=16)
def rope_freqs(head_dim: int, max_pos: int, theta: float = 10000.0,
               device=torch.device("cpu")):
    """RoPE cos/sin tables [max_pos, head_dim // 2] on ``device``: computed
    in numpy float64 and cast to float32, so they equal the JAX package's
    bit for bit. Cached per (head_dim, max_pos, theta, device): a long
    context's tables are tens of MB and every decode step asks for them."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    ang = np.outer(np.arange(max_pos), inv)
    return (torch.as_tensor(np.cos(ang).astype(np.float32), device=device),
            torch.as_tensor(np.sin(ang).astype(np.float32), device=device))


def apply_rope(x, positions, cos, sin):
    """x: [..., L, D]; positions: [..., L] integer. Tables wider than D/2
    are sliced. A position past the tables (only ever a padding row) reads
    the last row instead of faulting."""
    half = x.shape[-1] // 2
    positions = positions.clamp(0, cos.shape[0] - 1)
    c = cos[positions][..., :half]
    s = sin[positions][..., :half]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    # interleaved-pair convention folded to half-split (equivalent rotation)
    y1 = x1 * c - x2 * s
    y2 = x2 * c + x1 * s
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def swiglu(gate, up):
    return F.silu(gate) * up


def gelu(x):
    return F.gelu(x, approximate="tanh")
