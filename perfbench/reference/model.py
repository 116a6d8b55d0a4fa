"""Plain PyTorch forward of the served decoder stacks, in the precision
it is given (float32 by default, TF32 off): token embedding; per layer an
RMSNorm, grouped-query attention (with QKV biases where the weights
have them) with rotary positions (half-split
rotation over the whole head, theta from the configuration), causal
softmax in float32, an output projection, an RMSNorm and either a gated
SiLU feed-forward or a mixture of experts (softmax router, the top-k
experts per token, their gates renormalised where the configuration says
so, plus the shared experts); a final RMSNorm and an untied head.

No kernel, cache, batching or capacity: every token's chosen experts run
on it. It reads the weights by plain names and nothing of the program.

Near-tied routes. Where a token's k-th and (k+1)-th gates lie within
``ROUTE_TIE`` of each other, float32 rounding alone decides which expert
a program picks (the port's rounding differs from this forward's at
margins of 0 to 4e-7, PERF.md). Such a choice is ambiguous, not wrong:
``served_gaps`` takes, at each position, the smallest gap over this
forward and every forward with one such choice swapped."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

ROUTE_TIE = 1e-5        # gate margin (probability) under which a route is ambiguous
MAX_SWAPS = 32          # most near-tied routes tried, nearest first


def rope_tables(head_dim: int, n: int, theta: float, device):
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    ang = np.outer(np.arange(n), inv)
    return (torch.as_tensor(np.cos(ang), dtype=torch.float32, device=device),
            torch.as_tensor(np.sin(ang), dtype=torch.float32, device=device))


def _rms(x, g, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def _rotate(x, cos, sin):
    """x [H, L, D] rotated by position: pairs (i, i + D/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def _attention(x, w, p, m, cos, sin):
    n = x.shape[0]
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q, k, v = (x @ w[p + "wq"], x @ w[p + "wk"], x @ w[p + "wv"])
    if p + "bq" in w:
        q, k, v = q + w[p + "bq"], k + w[p + "bk"], v + w[p + "bv"]
    q = q.view(n, hq, hd).transpose(0, 1)
    k = k.view(n, hkv, hd).transpose(0, 1)
    v = v.view(n, hkv, hd).transpose(0, 1)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    rep = hq // hkv
    k = k.repeat_interleave(rep, 0)
    v = v.repeat_interleave(rep, 0)
    s = (q @ k.transpose(1, 2)).float() / float(np.sqrt(hd))
    mask = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    a = torch.softmax(s, -1).to(v.dtype)
    o = (a @ v).transpose(0, 1).reshape(n, hq * hd)
    return o @ w[p + "wo"]


def _gated(x, wi, wo):
    g, u = (x @ wi).chunk(2, dim=-1)
    return (F.silu(g) * u) @ wo


def _moe(x, w, p, moe, layer=None, ties=None, swap=None):
    e, k = moe["n_routed"], moe["top_k"]
    gates = torch.softmax((x @ w[p + "router"]).float(), -1)
    top = torch.topk(gates, k + 1, dim=-1)
    thresh = top.values[:, k - 1:k]
    chosen = gates >= thresh
    if ties is not None:
        margin = top.values[:, k - 1] - top.values[:, k]
        for t in torch.nonzero(margin < ROUTE_TIE).flatten().tolist():
            ties.append((float(margin[t]), layer, t, int(top.indices[t, k - 1]),
                         int(top.indices[t, k])))
    if swap is not None and swap[1] == layer:
        t, out_e, in_e = swap[2:]
        chosen[t, out_e], chosen[t, in_e] = False, True
    g = torch.where(chosen, gates, torch.zeros_like(gates))
    if moe.get("norm_topk_prob", False):
        g = g / g.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for j in range(e):
        rows = torch.nonzero(chosen[:, j]).flatten()
        if rows.numel() == 0:
            continue
        h = _gated(x[rows], w[p + "experts_wi"][j], w[p + "experts_wo"][j])
        y.index_add_(0, rows, h * g[rows, j, None].to(h.dtype))
    if moe.get("n_shared", 0) > 0:
        y = y + _gated(x, w[p + "shared_wi"], w[p + "shared_wo"])
    return y


class _Cast:
    """The weights read in another type, one at a time (a whole second copy
    of a large model does not fit beside the first)."""

    def __init__(self, w, dtype):
        self.w, self.dtype = w, dtype

    def __contains__(self, k):
        return k in self.w

    def __getitem__(self, k):
        return _CastTensor(self.w[k], self.dtype) if k.endswith("experts_wi") \
            or k.endswith("experts_wo") else self.w[k].to(self.dtype)


class _CastTensor:
    """An expert stack cast one expert at a time."""

    def __init__(self, t, dtype):
        self.t, self.dtype = t, dtype

    def __getitem__(self, j):
        return self.t[j].to(self.dtype)


def forward_logits(w: dict, m: dict, tokens, positions, dtype=torch.float32,
                   ties=None, swap=None):
    """Logits [len(positions), vocab] of the sequence ``tokens`` (a 1-D
    long tensor on the weights' device) at the given positions, float32.
    ``dtype`` is the type the weights and activations are computed in.
    ``ties``, a list, collects the near-tied routes (margin, layer, token,
    k-th expert, (k+1)-th expert); ``swap``, one of them, is taken the
    other way."""
    n = tokens.shape[0]
    dev = tokens.device
    ww = w if dtype == torch.float32 else _Cast(w, dtype)
    eps = m.get("rms_norm_eps", 1e-6)
    cos, sin = rope_tables(m["head_dim"], n, m.get("rope_theta", 10000.0), dev)
    moe = m.get("moe")
    every = m.get("moe_every", 1)
    x = ww["embed"][tokens]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        x = x + _attention(_rms(x, ww[p + "norm1"], eps), ww, p, m, cos, sin)
        h = _rms(x, ww[p + "norm2"], eps)
        if moe is not None and i % every == every - 1:
            x = x + _moe(h, ww, p, moe, i, ties, swap)
        else:
            x = x + _gated(h, ww[p + "ffn_wi"], ww[p + "ffn_wo"])
    x = _rms(x, ww["final_norm"], eps)
    head = ww["lm_head"] if "lm_head" in ww else ww["embed"].T
    return (x[positions] @ head).float()


def _gaps(ref, tok):
    return ref.max(-1).values - ref.gather(1, tok[:, None])[:, 0]


def served_gaps(w: dict, m: dict, prompt: list, served: list, device,
                dtype=torch.float32, control=None) -> np.ndarray:
    """For each served token, how far its logit lies below the best logit
    at its position: the reference run over the prompt and the served
    tokens, teacher-forced (token j is chosen at position len(prompt)-1+j),
    the smallest over the near-tied routes taken either way. With
    ``control`` (a lower type), the gap of the token that the forward in
    that type puts first instead of the served one."""
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), dtype=torch.long,
                          device=device)
    pos = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(served), device=device)
    with torch.no_grad():
        ties = []
        ref = forward_logits(w, m, seq, pos, dtype, ties=ties)
        if control is None:
            tok = torch.as_tensor(served, dtype=torch.long, device=device)
        else:
            tok = forward_logits(w, m, seq, pos, control).argmax(-1)
        gap = _gaps(ref, tok)
        for tie in sorted(ties)[:MAX_SWAPS]:
            after = pos >= tie[2]
            if not bool((gap[after] > 0).any()):
                continue
            alt = _gaps(forward_logits(w, m, seq, pos, dtype, swap=tie), tok)
            gap = torch.where(after, torch.minimum(gap, alt), gap)
    return gap.cpu().numpy().astype(np.float64)


def control_gaps(w: dict, m: dict, prompt: list, served: list, device,
                 dtype=torch.bfloat16) -> np.ndarray:
    """The control: at each of the same positions, the token that the
    forward in ``dtype`` puts first, and how far the float32 reference's
    logit for it lies below the float32 best (near-tied routes taken
    either way, as for the served tokens)."""
    return served_gaps(w, m, prompt, served, device, control=dtype)
