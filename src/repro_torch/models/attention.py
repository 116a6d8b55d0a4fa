"""Attention mixers (MHA / GQA / MLA): train, prefill, decode and extend
paths.

Two implementations of each path, chosen by ``impl``:

* ``"eager"`` — plain torch (the JAX package's ``impl="xla"``: dense
  softmax, or an online-softmax loop over key chunks for long sequences);
* ``"kernel"`` — the hand-written kernels through
  :mod:`repro_torch.kernels.ops` (``flash_attention`` for the full-sequence
  paths, ``decode_attention`` for one-token decode). A CUDA tensor runs the
  CUDA kernel, a CPU tensor its plain torch version.

Extending a cache by a chunk (chunked prefill) is plain torch under both
impls, as in the JAX package.

MLA (DeepSeek-V2) caches the shared compressed latent, kv_rank + rope_dim
wide per token, and decodes in the absorbed form: each query head is
projected into the latent space, so decode attends over one latent "kv
head" that is both K and V (``decode_attention`` at Hq 128, Hkv 1, D 576
for deepseek-v2-236b). As in the JAX package, the full-sequence paths
(``attention_train``, ``attention_prefill``) expand the latent to per-head
K (head_dim + rope_dim) and V (head_dim) and scale scores by
1/sqrt(head_dim + rope_dim), while ``attention_decode`` and
``attention_extend`` attend in the latent space and scale by
1/sqrt(kv_rank + rope_dim); the two agree only where kv_rank equals
head_dim. The flash kernel, like the TPU kernel, takes one head dim for q,
k and v, so MLA's full-sequence paths run only under ``impl="eager"``;
``impl="kernel"`` raises ``ValueError`` there (the JAX package's Pallas
path fails on the same shapes). The serving paths never need them: they
prefill through ``attention_extend``.

Caches are ``{"k": [B, S, Hkv, D], "v": [B, S, Hkv, D], "len": [B] int32}``,
or ``{"kv": [B, S, 1, kv_rank + rope_dim], "len"}`` for MLA.
Unlike the JAX package, the port writes new K/V rows into the cache
tensors IN PLACE (by index: one row per sequence at decode, a span at
extend) and returns a new dict holding the same K/V tensors and a new
``len``; the result equals the JAX package's functional update bit for
bit wherever the cache holds finite values. Caches are allocated with
zeros (never ``torch.empty``): stale rows beyond ``len`` are read by the
eager paths and multiplied by a zero weight, and ``0 * NaN`` is NaN.

The int8 cache (``dtype=torch.int8``, or ``REPRO_CACHE_QUANT=1``, see
:mod:`repro_torch.tuning`) adds float32 scales, one per (token, head):
``k_scale`` / ``v_scale`` [B, S, Hkv], or MLA's ``kv_scale`` [B, S, 1].
Each row is stored as ``round(x / s)`` clipped to +-127, with ``s`` the
row's largest |x| (at least 1e-6) over 127 (:func:`_quantize_kv`, the
reference's quantizer). ``attention_prefill`` quantizes the prompt's K/V
(or latent) into the cache and attends on the unquantized q/k/v, through
the flash kernel under ``impl="kernel"``. ``attention_decode`` quantizes
the new row in place, dequantizes the whole cache to float32 and attends
eagerly under both impls: the reference routes an int8 cache around the
decode kernel, and so does this module (``ops.decode_attention`` itself
refuses an int8 cache). ``attention_extend`` refuses an int8 cache: the
reference's ``extend`` drops the scales, and its next ``decode_step``
raises ``KeyError`` (ROADMAP R3 c), so the serving loops, which prefill
through ``extend``, refuse it too (:func:`refuse_int8_serving`).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import tuning
from ..kernels import ops
from .layers import Dense, apply_rope, dense

IMPLS = ("kernel", "eager")
NEG_INF = -1e30
INT8_EXTEND = ("the int8 KV cache does not survive extend: the reference's "
               "extend drops its scales and its next decode_step raises "
               "KeyError (ROADMAP R3 c)")


def check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; choose from "
                         f"{IMPLS}")
    return impl


def _check_attn_kind(cfg) -> None:
    if cfg.attn_kind not in ("mha", "gqa", "mla"):
        raise NotImplementedError(f"attention kind {cfg.attn_kind!r} is not "
                                  "ported")


def check_full_sequence_impl(cfg, impl: str) -> str:
    """``impl`` for a full-sequence path (train, prefill): MLA's q and k
    are head_dim + rope_dim wide and its v head_dim, which the flash
    kernel does not take, so MLA there needs ``impl="eager"``."""
    if check_impl(impl) == "kernel" and cfg.attn_kind == "mla":
        raise ValueError(
            f"{cfg.name}: MLA's full-sequence attention has q/k head dim "
            f"{cfg.head_dim + cfg.mla_rope_dim} (head_dim + rope_dim) and v "
            f"head dim {cfg.head_dim}; the flash kernel, like the TPU "
            f"kernel, takes one head dim for q, k and v, so run it with "
            f"impl='eager' (the serving paths prefill through extend)")
    return impl


def _is_int8(cache) -> bool:
    return cache["kv" if "kv" in cache else "k"].dtype == torch.int8


def cache_dtype(dtype):
    """The dtype of an attention cache asked for as ``dtype``: int8 under
    ``REPRO_CACHE_QUANT=1`` whatever ``dtype`` is, as in the reference."""
    return torch.int8 if tuning.cache_quant() else dtype


def refuse_int8_serving(what: str, dtype=None) -> None:
    """Raise ``NotImplementedError`` where ``what`` (a serving loop that
    prefills through ``extend``) would hold an int8 cache: ``dtype`` int8,
    or ``REPRO_CACHE_QUANT=1``."""
    if cache_dtype(dtype) == torch.int8:
        raise NotImplementedError(f"{what} prefills through extend, and "
                                  f"{INT8_EXTEND}")


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


class Attention(nn.Module):
    """``wq`` (d, Hq*D), ``wk``/``wv`` (d, Hkv*D), with bias when
    ``cfg.qkv_bias``; ``wo`` (Hq*D, d) without. MLA: ``wq`` (d,
    Hq*(D+rd)) and ``w_dkv`` (d, r+rd), with bias when ``cfg.qkv_bias``;
    ``w_uk``/``w_uv`` (r, Hq*D) and ``wo`` without (r = kv_rank, rd =
    rope_dim)."""

    def __init__(self, cfg, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        _check_attn_kind(cfg)
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(dtype=dtype, device=device, generator=generator)
        if cfg.attn_kind == "mla":
            r, rd = cfg.mla_kv_rank, cfg.mla_rope_dim
            self.wq = Dense(d, hq * (hd + rd), cfg.qkv_bias, **kw)
            self.w_dkv = Dense(d, r + rd, cfg.qkv_bias, **kw)
            self.w_uk = Dense(r, hq * hd, False, **kw)
            self.w_uv = Dense(r, hq * hd, False, **kw)
            self.wo = Dense(hq * hd, d, False, **kw)
            return
        self.wq = Dense(d, hq * hd, cfg.qkv_bias, **kw)
        self.wk = Dense(d, hkv * hd, cfg.qkv_bias, **kw)
        self.wv = Dense(d, hkv * hd, cfg.qkv_bias, **kw)
        self.wo = Dense(hq * hd, d, False, **kw)


# --------------------------------------------------------------------------
# scaled-dot-product attention backends
# --------------------------------------------------------------------------


def _plain_attention(q, k, v, causal: bool, offset: int):
    """q: [B,H,Lq,D], k/v: [B,H,Lk,D] (heads already repeated)."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / float(np.sqrt(d))
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None] + offset
        ki = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(ki <= qi, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def _chunked_attention(q, k, v, causal: bool, offset: int, chunk: int = 512):
    """Online softmax over key chunks, so the [Lq, Lk] score matrix never
    materialises (long prefill)."""
    b, h, lq, d = q.shape
    dv, lk = v.shape[-1], k.shape[2]
    scale = 1.0 / float(np.sqrt(d))
    qi = torch.arange(lq, device=q.device)[:, None] + offset
    m = torch.full((b, h, lq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, lq, dv), dtype=torch.float32, device=q.device)
    for c0 in range(0, lk, chunk):
        kb, vb = k[:, :, c0:c0 + chunk], v[:, :, c0:c0 + chunk]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kb).float() * scale
        kpos = c0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        mask = kpos < lk
        if causal:
            mask = mask & (kpos <= qi)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)


def _sdpa(q, k, v, causal, offset, impl, chunk_threshold: int = 2048):
    """q [B, Hq, Lq, D], k/v [B, Hkv, Lk, D]. ``impl="kernel"`` takes the
    causal offset as Lk - Lq (the kernel's convention)."""
    rep = q.shape[1] // k.shape[1]
    if check_impl(impl) == "kernel":
        return ops.flash_attention(q, k, v, causal=causal)
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    if max(q.shape[2], k.shape[2]) > chunk_threshold:
        return _chunked_attention(q, k, v, causal, offset)
    return _plain_attention(q, k, v, causal, offset)


# --------------------------------------------------------------------------
# projections
# --------------------------------------------------------------------------


def _rope_heads(x, positions, cos, sin):
    """x: [B, L, H, D] -> rotated, same layout. positions: [B, L]."""
    xt = x.transpose(1, 2)                          # [B, H, L, D]
    xt = apply_rope(xt, positions[:, None, :], cos, sin)
    return xt.transpose(1, 2)


def _project_qkv(p, x, cfg, positions, rope):
    """Returns q/k/v as [B, H, L, D] views, and the MLA latent
    [B, L, r+rd] for the cache (``None`` for MHA / GQA)."""
    b, l, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cos, sin = rope
    if cfg.attn_kind == "mla":
        r, rd = cfg.mla_kv_rank, cfg.mla_rope_dim
        qf = dense(p.wq, x).reshape(b, l, hq, hd + rd)
        q_nope, q_rope = qf[..., :hd], qf[..., hd:]
        q_rope = _rope_heads(q_rope, positions, cos, sin)
        ckv = dense(p.w_dkv, x)                      # [B, L, r+rd]
        c, k_rope = ckv[..., :r], ckv[..., r:]
        k_rope = _rope_heads(k_rope[:, :, None, :], positions, cos, sin)
        k_nope = (c @ p.w_uk.w).reshape(b, l, hq, hd)
        v = (c @ p.w_uv.w).reshape(b, l, hq, hd)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope.expand(b, l, hq, rd)], -1)
        latent = torch.cat([c, k_rope[:, :, 0, :]], -1)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), \
            latent
    q = dense(p.wq, x).reshape(b, l, hq, hd)
    k = dense(p.wk, x).reshape(b, l, hkv, hd)
    v = dense(p.wv, x).reshape(b, l, hkv, hd)
    q = _rope_heads(q, positions, cos, sin)
    k = _rope_heads(k, positions, cos, sin)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), None


# --------------------------------------------------------------------------
# forward paths
# --------------------------------------------------------------------------


def attention_train(p, x, cfg, positions, rope, causal=True, impl="eager"):
    """Full-sequence attention. x: [B, L, d]."""
    b, l, _ = x.shape
    q, k, v, _ = _project_qkv(p, x, cfg, positions, rope)
    y = _sdpa(q, k, v, causal, offset=0, impl=impl)
    y = y.transpose(1, 2).reshape(b, l, -1)
    return dense(p.wo, y)


def attention_prefill(p, x, cfg, positions, rope, cache, impl="kernel"):
    """Prefill: full-sequence attention + fill the first L cache rows (an
    int8 cache with the rows quantized and their scales)."""
    b, l, _ = x.shape
    rows = cache["kv" if cfg.attn_kind == "mla" else "k"].shape[1]
    if l > rows:
        raise ValueError(f"a {l}-token prompt does not fit a cache of "
                         f"{rows} positions")
    q, k, v, latent = _project_qkv(p, x, cfg, positions, rope)
    y = _sdpa(q, k, v, causal=True, offset=0, impl=impl)
    y = y.transpose(1, 2).reshape(b, l, -1)
    ln = torch.full((b,), l, dtype=torch.int32, device=x.device)
    rows = {"kv": latent[:, :, None, :]} if cfg.attn_kind == "mla" else \
        {"k": k.transpose(1, 2), "v": v.transpose(1, 2)}
    int8 = _is_int8(cache)
    for key, new in rows.items():
        if int8:
            new, scale = _quantize_kv(new)
            cache[key + "_scale"][:, :l] = scale
        cache[key][:, :l] = new.to(cache[key].dtype)
    return dense(p.wo, y), _with_len(cache, ln)


def _scatter_cache(cache, new, pos):
    """cache: [B, S, H, D] (or a scale cache [B, S, H]); new: [B, H, D]
    (or [B, H]); pos: [B]. Writes row ``pos[b]`` of each sequence in
    place; a position at or past S writes nothing (the reference's one-hot
    blend has no such row either)."""
    s = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos.clamp(0, s - 1)
    keep = cache[rows, at]
    inside = (pos < s).reshape((-1,) + (1,) * (keep.dim() - 1))
    cache[rows, at] = torch.where(inside, new.to(cache.dtype), keep)
    return cache


# repro-lint: hot
def _decode_write(cache, key, new, pos):
    """Write one decode row ``new`` [B, H, D] of cache ``key`` at ``pos``
    in place, quantized with its scale row into an int8 cache, and return
    the cache's rows to attend over: the cache itself, or the whole int8
    cache dequantized to float32."""
    if cache[key].dtype != torch.int8:
        return _scatter_cache(cache[key], new, pos)
    qv, sc = _quantize_kv(new[:, None])
    _scatter_cache(cache[key], qv[:, 0], pos)
    _scatter_cache(cache[key + "_scale"], sc[:, 0], pos)
    return _dequantize_kv(cache, key)


def _with_len(cache, lengths):
    """The cache a step returns: the same row tensors (written in place)
    and the new lengths."""
    return {**{key: t for key, t in cache.items() if key != "len"},
            "len": lengths}


# repro-lint: hot
def attention_decode(p, x, cfg, rope, cache, impl="kernel"):
    """One-token decode with KV cache. x: [B, 1, d] -> [B, 1, d]. Over an
    int8 cache the attention is eager under both impls, as in the
    reference."""
    if cfg.attn_kind == "mla":
        return _mla_decode(p, x, cfg, rope, cache, check_impl(impl))
    b = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cos, sin = rope
    pos = cache["len"]                              # [B]
    x1 = x[:, 0, :]
    q = dense(p.wq, x1).reshape(b, hq, hd)
    k = dense(p.wk, x1).reshape(b, hkv, hd)
    v = dense(p.wv, x1).reshape(b, hkv, hd)
    q = apply_rope(q, pos[:, None], cos, sin)
    k = apply_rope(k, pos[:, None], cos, sin)
    kc = _decode_write(cache, "k", k, pos)
    vc = _decode_write(cache, "v", v, pos)
    lengths = pos + 1
    if check_impl(impl) == "kernel" and not _is_int8(cache):
        o = ops.decode_attention(q, kc, vc, lengths)   # q unrounded
    else:
        o = _xla_decode(q, kc, vc, lengths)
    o = o.to(x.dtype)
    y = dense(p.wo, o.reshape(b, -1))[:, None, :]
    return y, _with_len(cache, lengths)


# repro-lint: hot
def _mla_decode(p, x, cfg, rope, cache, impl):
    """MLA decode in the absorbed form: q_nope projected into the latent
    space beside the rotated q_rope, the new latent row written in place,
    one attention over the latent as both K and V (Hkv 1, D r+rd), and
    the latent output taken up by ``w_uv``."""
    b = x.shape[0]
    hq, hd = cfg.n_heads, cfg.head_dim
    r, rd = cfg.mla_kv_rank, cfg.mla_rope_dim
    cos, sin = rope
    pos = cache["len"]
    x1 = x[:, 0, :]
    qf = dense(p.wq, x1).reshape(b, hq, hd + rd)
    q_nope, q_rope = qf[..., :hd], qf[..., hd:]
    q_rope = apply_rope(q_rope, pos[:, None], cos, sin)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope, p.w_uk.w.reshape(r, hq, hd))
    q_eff = torch.cat([q_lat, q_rope], -1)           # [B, Hq, r+rd]
    ckv = dense(p.w_dkv, x1)
    c_new, kr_new = ckv[..., :r], ckv[..., r:]
    kr_new = apply_rope(kr_new[:, None, :], pos[:, None], cos, sin)[:, 0]
    lat_new = torch.cat([c_new, kr_new], -1)[:, None, :]   # [B, 1, r+rd]
    kv = _decode_write(cache, "kv", lat_new, pos)
    lengths = pos + 1
    if impl == "kernel" and not _is_int8(cache):
        o = ops.decode_attention(q_eff, kv, kv, lengths)   # q unrounded
    else:
        o = _xla_decode(q_eff, kv, kv, lengths)
    o = o.to(x.dtype)
    y = torch.einsum("bhr,rhd->bhd", o[..., :r],
                     p.w_uv.w.reshape(r, hq, hd))
    return dense(p.wo, y.reshape(b, -1))[:, None, :], \
        _with_len(cache, lengths)


# repro-lint: hot
def _promoted(q, cache):
    """q and the cache in the type ``jnp.einsum`` computes their product
    in: the wider of the two (a float32 q over a bfloat16 cache upcasts the
    cache, a bfloat16 q over a float32 cache upcasts q; neither is ever
    rounded down)."""
    t = torch.promote_types(q.dtype, cache.dtype)
    return q.to(t), cache.to(t)


# repro-lint: hot
def _xla_decode(q, k_cache, v_cache, lengths):
    """q: [B, Hq, D]; caches: [B, S, Hkv, D]. Grouped-head einsums — the KV
    cache is never repeated per query head."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg, kc = _promoted(q.reshape(b, hkv, hq // hkv, d), k_cache)
    logits = torch.einsum("bgrd,bsgd->bgrs", qg, kc).float() \
        / float(np.sqrt(d))
    mask = torch.arange(s, device=q.device)[None, None, None, :] \
        < lengths[:, None, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, hq, d)


def attention_extend(p, x, cfg, rope, cache, impl="kernel", length=None):
    """Multi-token cache extension (chunked prefill): the chunk's queries
    attend over the existing cache plus themselves. x: [B, L, d]. Plain
    torch under both impls (the reference has no kernel here either).

    ``length`` ([B] int32, optional): true chunk length when x is
    right-padded — only the cache ``len`` advance uses it (pad K/V rows
    land beyond the advanced length, are never read by the causal mask,
    and are overwritten by the next chunk; rows past S are dropped). An
    int8 cache is refused before any work (see :data:`INT8_EXTEND`)."""
    if _is_int8(cache):
        raise NotImplementedError(INT8_EXTEND)
    check_impl(impl)
    b, l, _ = x.shape
    adv = l if length is None else length
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cos, sin = rope
    off = cache["len"]                                   # [B]
    positions = off[:, None] + torch.arange(l, device=x.device)[None, :]
    new_len = (off + adv).to(torch.int32)
    if cfg.attn_kind == "mla":
        r, rd = cfg.mla_kv_rank, cfg.mla_rope_dim
        qf = dense(p.wq, x).reshape(b, l, hq, hd + rd)
        q_nope, q_rope = qf[..., :hd], qf[..., hd:]
        q_rope = _rope_heads(q_rope, positions, cos, sin)
        q_lat = torch.einsum("blhd,rhd->blhr", q_nope,
                             p.w_uk.w.reshape(r, hq, hd))
        q_eff = torch.cat([q_lat, q_rope], -1)           # [B, L, Hq, r+rd]
        ckv = dense(p.w_dkv, x)
        c, k_rope = ckv[..., :r], ckv[..., r:]
        k_rope = _rope_heads(k_rope[:, :, None, :], positions, cos, sin)
        lat = torch.cat([c, k_rope[:, :, 0, :]], -1)
        kv = _scatter_span(cache["kv"], lat[:, :, None, :], off)
        o = _xla_extend(q_eff.transpose(1, 2), kv, kv, off, l)
        y = torch.einsum("bhlr,rhd->bhld", o[..., :r].to(x.dtype),
                         p.w_uv.w.reshape(r, hq, hd))
        y = y.transpose(1, 2).reshape(b, l, -1)
        return dense(p.wo, y), {"kv": kv, "len": new_len}
    q = dense(p.wq, x).reshape(b, l, hq, hd)
    k = dense(p.wk, x).reshape(b, l, hkv, hd)
    v = dense(p.wv, x).reshape(b, l, hkv, hd)
    q = _rope_heads(q, positions, cos, sin).transpose(1, 2)
    k = _rope_heads(k, positions, cos, sin)
    kc = _scatter_span(cache["k"], k, off)
    vc = _scatter_span(cache["v"], v, off)
    o = _xla_extend(q, kc, vc, off, l)                   # [B, Hq, L, hd]
    y = o.to(x.dtype).transpose(1, 2).reshape(b, l, -1)
    return dense(p.wo, y), {"k": kc, "v": vc, "len": new_len}


def _scatter_span(cache, new, off):
    """cache: [B, S, H, D]; new: [B, L, H, D]; off: [B] write offsets.
    Writes rows off..off+L-1 of each sequence in place and drops those at
    or past S, as the reference's ``.at[].set`` does. Without a host sync:
    a dropped row is redirected to a row the same write already sets to
    the same value (row ``off`` with ``new[:, 0]``, or row S-1 with its own
    contents when ``off >= S``), so duplicate indices carry equal values."""
    b, l = new.shape[0], new.shape[1]
    s = cache.shape[1]
    rows = torch.arange(b, device=cache.device)
    idx = off[:, None] + torch.arange(l, device=cache.device)[None, :]
    ok = idx < s
    first = off.clamp(0, s - 1)
    new = new.to(cache.dtype)
    fill = torch.where((off < s)[:, None, None], new[:, 0],
                       cache[rows, first])               # [B, H, D]
    val = torch.where(ok[:, :, None, None], new, fill[:, None])
    cache[rows[:, None], torch.where(ok, idx, first[:, None])] = val
    return cache


def _xla_extend(q, k_cache, v_cache, off, l):
    """q: [B, Hq, L, D]; caches [B, S, Hkv, D]; causal over off+self.
    Grouped-head einsums (no KV repeat)."""
    b, hq, _, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg, kc = _promoted(q.reshape(b, hkv, hq // hkv, l, d), k_cache)
    logits = torch.einsum("bgrld,bsgd->bgrls", qg, kc).float() \
        / float(np.sqrt(d))
    qpos = off[:, None, None, None, None] \
        + torch.arange(l, device=q.device)[None, None, None, :, None]
    kpos = torch.arange(s, device=q.device)[None, None, None, None, :]
    logits = torch.where(kpos <= qpos, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bgrls,bsgd->bgrld", p.to(v_cache.dtype), v_cache)
    return o.reshape(b, hq, l, d)


def _quantize_kv(x):
    """x: [B, L, H, D] -> (int8 values, float32 scales [B, L, H]): the
    reference's quantizer, float32 throughout, ``torch.round`` rounding
    half to even as ``jnp.round`` does. The divisor 127 is a tensor on
    x's device: CUDA torch divides by a Python number as a product with
    its rounded reciprocal, which may differ from the quotient in the last
    bit; by a tensor it divides, on every device alike."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1).clamp(min=1e-6) \
        / torch.full((), 127.0, device=x.device)
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(cache, key):
    c = cache[key]
    if c.dtype != torch.int8:
        return c
    return c.float() * cache[key + "_scale"][..., None]


def init_attn_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                    device=None):
    """Zero-filled ``{"k", "v", "len"}`` (MLA: ``{"kv", "len"}``) on
    ``device`` (resolved by the caller). Under ``REPRO_CACHE_QUANT=1``
    the rows are int8 whatever ``dtype`` asks, as in the reference; an
    int8 cache adds zero-filled float32 ``k_scale`` / ``v_scale``
    [B, S, Hkv] (MLA: ``kv_scale`` [B, S, 1])."""
    _check_attn_kind(cfg)
    dtype = cache_dtype(dtype)
    if cfg.attn_kind == "mla":
        width = cfg.mla_kv_rank + cfg.mla_rope_dim
        keys, shape = ("kv",), (batch, max_len, 1, width)
    else:
        keys = ("k", "v")
        shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    out = {key: torch.zeros(shape, dtype=dtype, device=device)
           for key in keys}
    if dtype == torch.int8:
        out.update({key + "_scale": torch.zeros(shape[:3],
                                                dtype=torch.float32,
                                                device=device)
                    for key in keys})
    out["len"] = torch.zeros((batch,), dtype=torch.int32, device=device)
    return out
