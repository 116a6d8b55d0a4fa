"""Mixture-of-Experts FFN (DeepSeek-style: shared + fine-grained routed
experts), a copy of the JAX package's ``models/moe.py`` in torch.

Routing is token-choice top-k with a capacity limit, run as expert-choice
gathers so every shape follows from the token count alone:

1. router logits -> float32 softmax -> each token's top-k gates, the rest
   zeroed, renormalised;
2. each expert takes its top ``C = max(1, min(T, int(T * k / E * cf) + 1))``
   tokens by those gates (a token that did not choose it has gate 0);
3. the gathered tokens run through the experts' gated FFN as two batched
   products over the expert dimension;
4. the results, weighted by the gates, are added back to their tokens,
   then the shared experts' FFN of every token.

A token over an expert's capacity gets nothing from that expert (the
shared experts and the residual still carry it), so a token's output
depends on the other tokens of its call: the batch's lanes and length
decide T. Each expert's choice breaks ties as ``jax.lax.top_k`` does, the
lower token index first, so identical tokens (a padded chunk's) are taken
in the reference's order; where an expert takes more tokens than chose
it, the extra ones have gate 0 and add exactly 0.

The expert products are large matrix products, outside any kernel of the
JAX package, so they are plain batched torch products here. The capacity
factor ``cf``, where a caller passes none, is
:func:`repro_torch.tuning.moe_capacity_factor` (``REPRO_MOE_CAP``, 1.25
by default), read at each call as the reference reads it.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import spans, tuning
from .layers import Dense, _normal, _param, dense, swiglu


class MoE(nn.Module):
    """``router`` (d, E), no bias; ``wi`` [E, d, 2 de] and ``wo``
    [E, de, d], bare parameters drawn N(0, 1) x d^-0.5 and x de^-0.5; and,
    with shared experts, ``shared_wi`` (d, 2 de n_shared) and
    ``shared_wo`` (de n_shared, d) without bias."""

    def __init__(self, cfg, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        d, moe = cfg.d_model, cfg.moe
        e, de = moe.n_routed, moe.d_expert
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.router = Dense(d, e, False, **kw)
        if generator is not None:
            self.wi = _normal((e, d, 2 * de), generator, dtype, device,
                              float(d ** -0.5))
            self.wo = _normal((e, de, d), generator, dtype, device,
                              float(de ** -0.5))
        else:
            self.wi = _param((e, d, 2 * de), dtype, device)
            self.wo = _param((e, de, d), dtype, device)
        if moe.n_shared > 0:
            ds = de * moe.n_shared
            self.shared_wi = Dense(d, 2 * ds, False, **kw)
            self.shared_wo = Dense(ds, d, False, **kw)


def expert_capacity(t: int, top_k: int, n_routed: int,
                    capacity_factor: float | None = None) -> int:
    """Tokens each expert takes out of ``t`` (``capacity_factor=None``:
    ``tuning.moe_capacity_factor()``)."""
    if capacity_factor is None:
        capacity_factor = tuning.moe_capacity_factor()
    return max(1, min(t, int(t * top_k / n_routed * capacity_factor) + 1))


def route(p: MoE, xt, cfg, capacity_factor: float | None = None):
    """The routing of tokens xt [T, d]: (the router's float32 softmax
    [T, E]; the same with each token's top-k renormalised and the rest 0;
    per expert its chosen gates [E, C] and token indices [E, C]).
    ``capacity_factor=None`` reads ``tuning.moe_capacity_factor()``."""
    e, k = cfg.moe.n_routed, cfg.moe.top_k
    gates = torch.softmax(dense(p.router, xt).float(), dim=-1)
    thresh = torch.topk(gates, k, dim=-1).values[:, -1:]
    masked = torch.where(gates >= thresh, gates, 0.0)
    denom = masked.sum(dim=-1, keepdim=True)
    masked = masked / torch.where(denom == 0, 1.0, denom)
    cap = expert_capacity(xt.shape[0], k, e, capacity_factor)
    # lax.top_k's order: by gate, the lower token index first among equal
    # gates (identical tokens, such as a padded chunk's, tie exactly)
    g_e, idx_e = torch.sort(masked.T, dim=-1, descending=True, stable=True)
    return gates, masked, g_e[:, :cap], idx_e[:, :cap]


def apply_moe(p: MoE, x, cfg, capacity_factor: float | None = None):
    """x: [B, L, d] -> [B, L, d]. ``capacity_factor=None`` reads
    ``tuning.moe_capacity_factor()``."""
    b, l, d = x.shape
    e = cfg.moe.n_routed
    with spans.span("model.moe"):
        xt = x.reshape(b * l, d)
        _, _, g_e, idx_e = route(p, xt, cfg, capacity_factor)
        cap = idx_e.shape[1]
        # rows through the experts' products against rows the tokens chose
        spans.add(expert_rows=e * cap, routed_rows=b * l * cfg.moe.top_k)
        flat = idx_e.reshape(-1)
        xe = xt[flat].reshape(e, cap, d)
        h = torch.bmm(xe, p.wi)                              # [E, C, 2 de]
        gate_h, up_h = torch.chunk(h, 2, dim=-1)
        ye = torch.bmm(swiglu(gate_h, up_h), p.wo)           # [E, C, d]
        ye = ye * g_e[..., None].to(ye.dtype)
        y = torch.zeros_like(xt).index_add_(
            0, flat, ye.reshape(e * cap, d).to(xt.dtype))
        if cfg.moe.n_shared > 0:
            sg, su = torch.chunk(dense(p.shared_wi, xt), 2, dim=-1)
            y = y + dense(p.shared_wo, swiglu(sg, su))
        return y.reshape(b, l, d)
