"""LMs from one config: dense MHA / GQA / MLA, Mamba-2 and hybrid
attention + Mamba-2 stacks (RMSNorm or LayerNorm, gated or ungated FFN,
MoE FFN or none, tied or untied head, optional QKV bias), and
encoder-decoder models (whisper: an encoder stack, decoder blocks with
cross-attention).

The model is a tree of :class:`torch.nn.Module` whose parameter names
follow the JAX package's pytree paths (``blocks.3.attn.wq.w``), with dense
weights in the JAX layout, so :func:`repro_torch.core.interop.params_from_jax`
carries a JAX parameter tree across by copying. The apply functions keep
the JAX package's signatures (``params`` first, then ``cfg``).

Paths:
* ``forward``      — full-sequence logits, differentiable (``impl="eager"``
  by default: the training path; ``remat`` recomputes each block in the
  backward pass). The kernels have no backward, so ``impl="kernel"``
  raises ``ValueError`` where a weight or input requires grad and grad
  is enabled;
* ``prefill``      — fill caches with whole prompts, return last logits;
* ``extend``       — continue caches by a (padded) chunk;
* ``decode_step``  — one token with caches (the serving inner loop);
* ``encode``       — the encoder stack (bidirectional) over frame
  embeddings [B, Le, d_model] (the audio frontend is a stub upstream).

Encoder-decoder: ``forward``, ``prefill``, ``extend`` and ``decode_step``
take ``enc_out`` [B, Le, d_model]; a decoder block with ``cross`` then
attends from its residual stream to ``enc_out`` (no RoPE, not causal; its
k / v are projected from ``enc_out`` anew at every call, with no cache, as
in the reference). Without ``enc_out`` the serving paths skip
cross-attention and ``forward`` encodes zero frames first, as the
reference does.

Scan over layers (parameters and caches in the stacked layout of
:mod:`.stacked`): ``forward_scanned``, ``prefill_scanned``,
``decode_step_scanned`` and ``encode_scanned`` call ``forward``,
``prefill``, ``decode_step`` and ``encode`` on the stacked tensors read in
layer order (views, no copy), so they equal them bit for bit by
construction.

``forward``, ``prefill`` and their scanned twins take ``inputs_embeds``
[B, L, d_model] in place of tokens (a vision or audio frontend's output,
as phi-3-vision's stub passes it); ``extend``, ``decode_step`` and the
serving loops take tokens.

Every path takes ``device`` (``None`` = CUDA, raising where there is none,
as the search's entry points do) and refuses tensors that lie elsewhere,
so nothing runs on the CPU unless the caller asks. Attention caches are
updated in place (see :mod:`.attention`); a Mamba layer returns a new
state (see :mod:`.mamba2`). Layer ``i`` mixes with attention or Mamba-2 as
``cfg.mixer_kind(i)`` says, and its FFN is dense, MoE (:mod:`.moe`) or
none as ``cfg.ffn_kind(i)`` says. MLA's ``forward`` and ``prefill`` run
only under ``impl="eager"`` (see :mod:`.attention`); its serving paths
(``extend``, ``decode_step``) take either impl.

``init_cache`` makes int8 attention caches (with their scales) for
``dtype=torch.int8`` or under ``REPRO_CACHE_QUANT=1``, and float32 Mamba
states either way; ``prefill`` and ``decode_step`` take them, ``extend``
refuses them (see :mod:`.attention`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import spans
from ..core.timing import resolve_device
from .attention import (
    Attention,
    _sdpa,
    attention_decode,
    attention_extend,
    attention_prefill,
    attention_train,
    check_full_sequence_impl,
    check_impl,
    init_attn_cache,
)
from .layers import (
    Dense,
    Embedding,
    LayerNorm,
    RMSNorm,
    dense,
    embed,
    gelu,
    layernorm,
    rmsnorm,
    rope_freqs,
    swiglu,
)
from .mamba2 import (
    Mamba,
    init_mamba_cache,
    mamba_decode,
    mamba_extend,
    mamba_prefill,
    mamba_train,
)
from .moe import MoE, apply_moe
from .stacked import StackedParams, unstack_cache


@dataclass(frozen=True)
class MoECfg:
    n_routed: int
    n_shared: int
    top_k: int
    d_expert: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    ffn_gated: bool = True
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    attn_kind: str = "gqa"           # mha | gqa | mla | none
    qkv_bias: bool = False
    mla_kv_rank: int = 0
    mla_rope_dim: int = 64
    moe: MoECfg | None = None
    moe_every: int = 1
    mixer: str = "attn"              # attn | mamba | hybrid
    attn_every: int = 8
    d_inner: int = 0
    ssm_state: int = 0
    mamba_heads: int = 8
    cross_attention: bool = False    # decoder blocks get cross-attn (whisper)
    encoder_layers: int = 0          # >0: encoder-decoder
    encoder_len: int = 1500
    rope_theta: float = 10000.0
    max_seq: int = 8192
    tie_embeddings: bool = True
    scan_layers: bool = False    # scan-over-layers (stacked params layout)

    def mixer_kind(self, i: int) -> str:
        if self.mixer == "attn":
            return "attn"
        if self.mixer == "mamba":
            return "mamba"
        return "attn" if i % self.attn_every == self.attn_every // 2 else "mamba"

    def ffn_kind(self, i: int) -> str:
        if self.moe is not None and i % self.moe_every == self.moe_every - 1:
            return "moe"
        return "dense" if self.d_ff > 0 else "none"


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port does not
    run yet."""
    if cfg.mixer not in ("attn", "mamba", "hybrid"):
        raise NotImplementedError(f"mixer {cfg.mixer!r} is not ported")
    if _has_attention(cfg) and cfg.attn_kind not in ("mha", "gqa", "mla"):
        raise NotImplementedError(f"attention kind {cfg.attn_kind!r} is not "
                                  "ported")


def _has_attention(cfg: ModelConfig) -> bool:
    return any(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))


def _rope(cfg: ModelConfig, max_pos: int, device):
    """RoPE tables, or ``None`` for a model without attention layers
    (mamba2-2.7b's max_seq of 2^20 would make 1M-row tables for nothing)."""
    if not _has_attention(cfg):
        return None
    return rope_freqs(cfg.head_dim, max_pos, cfg.rope_theta, device)


def _norm_module(cfg, device):
    """A block's, the final or the encoder's norm: its gain and bias are
    float32 whatever the weights' type, as the reference's ``_norm_init``
    makes them (Mamba's inner norm keeps the weights' type)."""
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.d_model, dtype=torch.float32, device=device)


def _norm(cfg, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


class FFN(nn.Module):
    """``wi`` (d, 2*d_ff gated | d_ff) and ``wo`` (d_ff, d)."""

    def __init__(self, cfg, dtype, device, generator):
        super().__init__()
        mult = 2 if cfg.ffn_gated else 1
        kw = dict(dtype=dtype, device=device, generator=generator)
        self.wi = Dense(cfg.d_model, mult * cfg.d_ff, False, **kw)
        self.wo = Dense(cfg.d_ff, cfg.d_model, False, **kw)


class Block(nn.Module):
    """``norm1`` and ``attn`` or ``mamba`` (as ``cfg.mixer_kind(i)``
    says), with ``cross=True`` also ``norm_x`` and ``cross`` (an
    :class:`Attention` over the encoder's output), then ``norm2`` and
    ``moe`` or ``ffn``, or neither (as ``cfg.ffn_kind(i)`` says)."""

    def __init__(self, cfg, i, dtype, device, generator, cross=False):
        super().__init__()
        self.norm1 = _norm_module(cfg, device)
        if cfg.mixer_kind(i) == "attn":
            self.attn = Attention(cfg, dtype, device, generator)
        else:
            self.mamba = Mamba(cfg, dtype, device, generator)
        if cross:
            self.norm_x = _norm_module(cfg, device)
            self.cross = Attention(cfg, dtype, device, generator)
        kind = cfg.ffn_kind(i)
        if kind != "none":
            self.norm2 = _norm_module(cfg, device)
        if kind == "moe":
            self.moe = MoE(cfg, dtype, device, generator)
        elif kind == "dense":
            self.ffn = FFN(cfg, dtype, device, generator)


class Transformer(nn.Module):
    """``embed``, ``blocks`` (a list of :class:`Block`, with
    cross-attention where ``cfg.cross_attention``), ``final_norm``,
    untied, ``lm_head`` and, for an encoder-decoder model, ``enc_blocks``
    (without cross-attention) and ``enc_norm``. With a generator every
    weight is drawn as the JAX package's ``init_model`` draws it (other
    random numbers); without one the weights are left uninitialised, to be
    copied in."""

    def __init__(self, cfg: ModelConfig, dtype=torch.float32, device=None,
                 generator=None):
        super().__init__()
        check_supported(cfg)
        self.embed = Embedding(cfg.vocab, cfg.d_model, dtype, device,
                               generator)
        self.final_norm = _norm_module(cfg, device)
        self.blocks = nn.ModuleList(
            Block(cfg, i, dtype, device, generator, cfg.cross_attention)
            for i in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab, False, dtype,
                                 device, generator)
        if cfg.encoder_layers > 0:
            self.enc_blocks = nn.ModuleList(
                Block(cfg, i, dtype, device, generator)
                for i in range(cfg.encoder_layers))
            self.enc_norm = _norm_module(cfg, device)


def init_model(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
               device=None) -> Transformer:
    """Random weights from ``seed`` on ``device`` (``None`` = CUDA): dense
    ``w`` ~ N(0, 1/d_in), embeddings ~ N(0, 0.02^2), biases 0, norm gains 1
    — the JAX package's initialisation, not its random numbers."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        return Transformer(cfg, dtype, dev, gen)


def param_count(params: nn.Module) -> int:
    return int(sum(p.numel() for p in params.parameters()))


def _check_device(device, params, *tensors) -> torch.device:
    """The resolved device, after checking that the weights and every
    tensor given lie on it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    for name, t in (("params", params.embed.e),) + tensors:
        if t.device != dev:
            raise ValueError(f"{name} lie on {t.device}, not on {dev}; pass "
                             f"device= to say where to run")
    return dev


def _cache_tensors(cache):
    return tuple((f"cache[{i}][{k}]", t) for i, layer in enumerate(cache)
                 for k, t in layer.items())


def _enc_out(cfg: ModelConfig, enc_out):
    """``enc_out`` checked for device (none where it is ``None``), after
    checking that it is [B, Le, d_model] of an encoder-decoder model."""
    if enc_out is None:
        return ()
    if not cfg.cross_attention:
        raise ValueError(f"{cfg.name} has no cross-attention to take "
                         f"enc_out")
    if enc_out.dim() != 3 or enc_out.shape[-1] != cfg.d_model:
        raise ValueError(f"enc_out of shape {tuple(enc_out.shape)}, not "
                         f"[B, Le, {cfg.d_model}]")
    return (("enc_out", enc_out),)


def _records_grad(params, impl: str, *tensors) -> bool:
    """Whether autograd records this call: grad is enabled and a weight or
    one of ``tensors`` requires grad. ``impl="kernel"`` is then refused:
    the hand kernels are not ``autograd.Function``s, so their outputs
    would carry no gradient and the projections before them would get
    wrong ones."""
    grad = torch.is_grad_enabled() and (
        any(t.requires_grad for t in params.parameters())
        or any(t is not None and t.requires_grad for t in tensors))
    if grad and impl == "kernel":
        raise ValueError("impl='kernel' runs forward-only kernels with no "
                         "backward; compute gradients with impl='eager'")
    return grad


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------


def _ffn_apply(p, cfg, x):
    if cfg.ffn_gated:
        g, u = torch.chunk(dense(p.wi, x), 2, dim=-1)
        return dense(p.wo, swiglu(g, u))
    return dense(p.wo, gelu(dense(p.wi, x)))


def _ffn_residual(blk, cfg, x):
    if not hasattr(blk, "norm2"):
        return x
    h = _norm(cfg, blk.norm2, x)
    if hasattr(blk, "moe"):
        return x + apply_moe(blk.moe, h, cfg)
    return x + _ffn_apply(blk.ffn, cfg, h)


def _cross_attention(p, x, enc_out, cfg, impl):
    """Decoder -> encoder attention: q from x [B, L, d], k / v from
    ``enc_out`` [B, Le, d], no RoPE, not causal (Lq = L, Lk = Le: the
    flash kernel under ``impl="kernel"``, with Lq 1 at decode)."""
    b, l, _ = x.shape
    le = enc_out.shape[1]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(p.wq, x).reshape(b, l, hq, hd).transpose(1, 2)
    k = dense(p.wk, enc_out).reshape(b, le, hkv, hd).transpose(1, 2)
    v = dense(p.wv, enc_out).reshape(b, le, hkv, hd).transpose(1, 2)
    y = _sdpa(q, k, v, causal=False, offset=0, impl=impl)
    return dense(p.wo, y.transpose(1, 2).reshape(b, l, -1))


def _cross_residual(blk, cfg, x, enc_out, impl):
    """x plus the cross-attention of a block that has one, where
    ``enc_out`` is given (the reference's positions for it are unused:
    cross-attention takes no RoPE)."""
    if enc_out is None or not hasattr(blk, "cross"):
        return x
    h = _norm(cfg, blk.norm_x, x)
    return x + _cross_attention(blk.cross, h, enc_out, cfg, impl)


def _block_train(blk, cfg, i, x, positions, rope, causal, impl,
                 enc_out=None):
    """One block over the full sequence (``forward``, ``encode``)."""
    h = _norm(cfg, blk.norm1, x)
    if cfg.mixer_kind(i) == "attn":
        h = attention_train(blk.attn, h, cfg, positions, rope,
                            causal=causal, impl=impl)
    else:
        h = mamba_train(blk.mamba, h, cfg, impl=impl)
    x = _cross_residual(blk, cfg, x + h, enc_out, impl)
    return _ffn_residual(blk, cfg, x)


def _logits(params, cfg, x):
    if cfg.tie_embeddings:
        return x @ params.embed.e.T
    return dense(params.lm_head, x)


def _inputs(cfg: ModelConfig, tokens, inputs_embeds):
    """The inputs checked for device: ``tokens``, or ``inputs_embeds``
    [B, L, d_model] in their place (a modality frontend's output)."""
    if inputs_embeds is None:
        if tokens is None:
            raise ValueError("pass tokens or inputs_embeds")
        return (("tokens", tokens),)
    if inputs_embeds.dim() != 3 or inputs_embeds.shape[-1] != cfg.d_model:
        raise ValueError(f"inputs_embeds of shape {tuple(inputs_embeds.shape)}"
                         f", not [B, L, {cfg.d_model}]")
    return (("inputs_embeds", inputs_embeds),)


def _embed_inputs(params, tokens, inputs_embeds):
    return embed(params.embed, tokens) if inputs_embeds is None \
        else inputs_embeds


def encode(params, cfg: ModelConfig, inputs_embeds, impl="eager",
           device=None):
    """The encoder stack (bidirectional self-attention) over frame
    embeddings ``inputs_embeds`` [B, Le, d_model] -> [B, Le, d_model]
    (``enc_out``). Differentiable, as ``forward`` is."""
    if cfg.encoder_layers <= 0:
        raise ValueError(f"{cfg.name} has no encoder")
    check_full_sequence_impl(cfg, impl)
    dev = _check_device(device, params,
                        *_inputs(cfg, None, inputs_embeds))
    _records_grad(params, impl, inputs_embeds)
    return _encode(params, cfg, inputs_embeds, impl, dev)


def _encode(params, cfg, x, impl, dev):
    b, le, _ = x.shape
    rope = rope_freqs(cfg.head_dim, max(cfg.max_seq, le), cfg.rope_theta,
                      dev)
    positions = torch.arange(le, device=dev).expand(b, le)
    for i, blk in enumerate(params.enc_blocks):
        x = _block_train(blk, cfg, i, x, positions, rope, causal=False,
                         impl=impl)
    return _norm(cfg, params.enc_norm, x)


def forward(params, cfg: ModelConfig, tokens=None, impl="eager", device=None,
            inputs_embeds=None, enc_out=None, remat: bool = False):
    """Full-sequence forward -> logits [B, L, vocab], differentiable where
    grad is enabled (the weights are made with ``requires_grad=False``,
    so inference builds no graph). ``inputs_embeds`` [B, L, d_model], where
    given, takes the place of the embedded ``tokens``. An encoder-decoder
    model attends to ``enc_out`` [B, Le, d_model], or, without it, to the
    encoding of zero frames [B, encoder_len, d_model], as the reference
    does. ``remat`` recomputes each decoder block in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations.
    ``impl="kernel"`` under grad raises ``ValueError``."""
    check_full_sequence_impl(cfg, impl)
    dev = _check_device(device, params,
                        *_inputs(cfg, tokens, inputs_embeds),
                        *_enc_out(cfg, enc_out))
    grad = _records_grad(params, impl, inputs_embeds, enc_out)
    x = _embed_inputs(params, tokens, inputs_embeds)
    b, l, _ = x.shape
    rope = _rope(cfg, max(cfg.max_seq, l), dev)
    positions = torch.arange(l, device=dev).expand(b, l)
    if cfg.encoder_layers > 0 and enc_out is None:
        # the encoder input stub: callers normally pass real frame
        # embeddings
        enc_out = _encode(params, cfg, torch.zeros(
            (b, cfg.encoder_len, cfg.d_model), dtype=x.dtype, device=dev),
            impl, dev)
    for i, blk in enumerate(params.blocks):
        if remat and grad:
            x = checkpoint(_block_train, blk, cfg, i, x, positions, rope,
                           True, impl, enc_out, use_reentrant=False)
        else:
            x = _block_train(blk, cfg, i, x, positions, rope, True, impl,
                             enc_out)
    x = _norm(cfg, params.final_norm, x)
    return _logits(params, cfg, x)


# --------------------------------------------------------------------------
# serving paths
# --------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """One zero-filled cache per layer on ``device`` (``None`` = CUDA): an
    attention cache of ``dtype`` (int8 with its scales under
    ``REPRO_CACHE_QUANT=1``) or a float32 Mamba state, as
    ``cfg.mixer_kind(i)`` says."""
    check_supported(cfg)
    dev = resolve_device(device)
    return [init_attn_cache(cfg, batch, max_len, dtype, dev)
            if cfg.mixer_kind(i) == "attn"
            else init_mamba_cache(cfg, batch, dev)
            for i in range(cfg.n_layers)]


def prefill(params, cfg: ModelConfig, tokens, cache, impl="kernel",
            device=None, inputs_embeds=None, enc_out=None):
    """Fill caches with the prompt; returns (last logits [B, vocab],
    cache). ``inputs_embeds`` [B, L, d_model], where given, takes the place
    of the embedded ``tokens`` (pass ``tokens=None``); ``enc_out``
    [B, Le, d_model], where given, is what the cross-attention attends
    to."""
    check_full_sequence_impl(cfg, impl)
    dev = _check_device(device, params,
                        *_inputs(cfg, tokens, inputs_embeds),
                        *_enc_out(cfg, enc_out), *_cache_tensors(cache))
    with torch.no_grad():
        x = _embed_inputs(params, tokens, inputs_embeds)
        b, l, _ = x.shape
        rope = _rope(cfg, max(cfg.max_seq, l), dev)
        positions = torch.arange(l, device=dev).expand(b, l)
        new_cache = []
        for i, (blk, c) in enumerate(zip(params.blocks, cache)):
            h = _norm(cfg, blk.norm1, x)
            if cfg.mixer_kind(i) == "attn":
                h, c = attention_prefill(blk.attn, h, cfg, positions, rope, c,
                                         impl=impl)
            else:
                h, c = mamba_prefill(blk.mamba, h, cfg, c, impl=impl)
            new_cache.append(c)
            x = _cross_residual(blk, cfg, x + h, enc_out, impl)
            x = _ffn_residual(blk, cfg, x)
        x = _norm(cfg, params.final_norm, x)
        return _logits(params, cfg, x[:, -1]), new_cache


def extend(params, cfg: ModelConfig, tokens, cache, impl="kernel",
           length=None, device=None, enc_out=None):
    """Chunked-prefill continuation: process a multi-token chunk against the
    existing caches. tokens: [B, L] -> (last logits [B, vocab], cache).

    ``length`` (int or [B], optional) marks the true chunk length when
    ``tokens`` is right-padded to a bucket size: pad positions neither
    advance the caches nor pick the output logit. ``enc_out``
    [B, Le, d_model], where given, is what the cross-attention attends
    to (every position of the chunk, pads included)."""
    check_impl(impl)
    dev = _check_device(device, params, ("tokens", tokens),
                        *_enc_out(cfg, enc_out), *_cache_tensors(cache))
    with torch.no_grad():
        x = embed(params.embed, tokens)
        b, l, _ = x.shape
        adv = None if length is None else \
            torch.as_tensor(length, dtype=torch.int32, device=dev).expand(b)
        rope = _rope(cfg, cfg.max_seq, dev)
        new_cache = []
        for i, (blk, c) in enumerate(zip(params.blocks, cache)):
            h = _norm(cfg, blk.norm1, x)
            if cfg.mixer_kind(i) == "attn":
                with spans.span("model.attention"):
                    h, c = attention_extend(blk.attn, h, cfg, rope, c,
                                            impl=impl, length=adv)
            else:
                h, c = mamba_extend(blk.mamba, h, cfg, c, impl=impl,
                                    length=adv)
            new_cache.append(c)
            x = _cross_residual(blk, cfg, x + h, enc_out, impl)
            x = _ffn_residual(blk, cfg, x)
        x = _norm(cfg, params.final_norm, x)
        if adv is None:
            last = x[:, -1]
        else:
            last = x[torch.arange(b, device=dev), adv.long() - 1]
        return _logits(params, cfg, last), new_cache


def _row_keys(layer) -> tuple[str, ...]:
    """The keys of an attention layer's cache rows: ``k`` and ``v``, or
    MLA's ``kv``, and an int8 cache's scale rows."""
    return tuple(key for key in layer if key != "len")


def _save_slots(layer):
    """What a decode step may overwrite in one layer's cache: each slot's
    ``len`` and its cache rows (K/V, or MLA's latent, and their scales) at
    the write position (clamped into the cache). A Mamba layer's decode
    returns a new state, so its old state is kept as it is."""
    if "state" in layer:
        return dict(layer)
    keys = _row_keys(layer)
    at = layer["len"].clamp(0, layer[keys[0]].shape[1] - 1)
    rows = torch.arange(at.shape[0], device=at.device)
    return {"at": at, "len": layer["len"],
            **{key: layer[key][rows, at] for key in keys}}


def _mask_cache(old, new, active):
    """Freeze the cache rows of inactive slots (requests still prefilling
    in other iterations must not be disturbed by the batched decode): put
    back, by index, the cache rows the step wrote for them and their
    ``len``; of a Mamba layer, keep their old state rows and ``len``."""
    if active is None:
        return new
    if "state" in new:
        keep = active[:, None, None, None]
        return {"state": torch.where(keep, new["state"], old["state"]),
                "len": torch.where(active, new["len"], old["len"])}
    rows = torch.arange(active.shape[0], device=active.device)
    keys = _row_keys(new)
    for key in keys:
        c = new[key]
        keep = active.reshape((-1,) + (1,) * (old[key].dim() - 1))
        c[rows, old["at"]] = torch.where(keep, c[rows, old["at"]], old[key])
    return {**{key: new[key] for key in keys},
            "len": torch.where(active, new["len"], old["len"])}


# repro-lint: hot
def decode_step(params, cfg: ModelConfig, token, cache, impl="kernel",
                active=None, device=None, enc_out=None):
    """One decode step. token: [B] -> (logits [B, vocab], cache).
    ``active``: optional [B] bool — inactive slots' caches are left
    untouched (continuous batching with partially-filled slots).
    ``enc_out`` [B, Le, d_model], where given, is what the cross-attention
    attends to, one row per slot."""
    check_impl(impl)
    extra = () if active is None else (("active", active),)
    dev = _check_device(device, params, ("token", token), *extra,
                        *_enc_out(cfg, enc_out), *_cache_tensors(cache))
    with torch.no_grad():
        x = embed(params.embed, token)[:, None, :]
        rope = _rope(cfg, cfg.max_seq, dev)
        new_cache = []
        for i, (blk, c) in enumerate(zip(params.blocks, cache)):
            old = None if active is None else _save_slots(c)
            h = _norm(cfg, blk.norm1, x)
            if cfg.mixer_kind(i) == "attn":
                with spans.span("model.attention"):
                    h, c = attention_decode(blk.attn, h, cfg, rope, c,
                                            impl=impl)
            else:
                h, c = mamba_decode(blk.mamba, h, cfg, c, impl=impl)
            new_cache.append(_mask_cache(old, c, active))
            x = _cross_residual(blk, cfg, x + h, enc_out, impl)
            x = _ffn_residual(blk, cfg, x)
        x = _norm(cfg, params.final_norm, x)
        return _logits(params, cfg, x[:, 0]), new_cache


# --------------------------------------------------------------------------
# scan-over-layers paths (stacked params and caches, see .stacked)
# --------------------------------------------------------------------------


def _layers(params, cfg: ModelConfig):
    """Stacked params read in layer order (:meth:`.stacked.StackedParams.
    layers`), after checking that they are stacked params of ``cfg``."""
    if not isinstance(params, StackedParams):
        raise TypeError("the scanned entry points take stack_params(params, "
                        f"cfg), not {type(params).__name__}")
    if params.period * params.n_steps != cfg.n_layers:
        raise ValueError(f"stacked params of {params.n_steps} steps of "
                         f"period {params.period} for {cfg.n_layers} layers")
    return params.layers()


def _write_back(views, new_cache) -> None:
    """Copy into the stacked slots what a layer returned anew (``len``, a
    Mamba state); its attention rows were written in place through the
    views."""
    for view, layer in zip(views, new_cache):
        for key, t in layer.items():
            if t is not view[key]:
                view[key].copy_(t)


def forward_scanned(params, cfg: ModelConfig, tokens=None, impl="eager",
                    device=None, inputs_embeds=None, enc_out=None,
                    remat: bool = True):
    """``forward`` over stacked params (:func:`.stacked.stack_params`),
    with ``remat`` on by default as in the reference."""
    return forward(_layers(params, cfg), cfg, tokens, impl, device,
                   inputs_embeds, enc_out, remat)


def encode_scanned(params, cfg: ModelConfig, inputs_embeds, impl="eager",
                   device=None):
    """``encode`` over stacked params (the encoder blocks stacked at
    period 1)."""
    return encode(_layers(params, cfg), cfg, inputs_embeds, impl, device)


def prefill_scanned(params, cfg: ModelConfig, tokens, cache_slots,
                    impl="kernel", device=None, inputs_embeds=None,
                    enc_out=None):
    """``prefill`` over stacked params and caches (:func:`.stacked.
    stack_cache`): (last logits [B, vocab], ``cache_slots``, written in
    place)."""
    layers = _layers(params, cfg)
    views = unstack_cache(cache_slots, cfg)
    logits, new_cache = prefill(layers, cfg, tokens, views, impl, device,
                                inputs_embeds, enc_out)
    _write_back(views, new_cache)
    return logits, cache_slots


def decode_step_scanned(params, cfg: ModelConfig, token, cache_slots,
                        impl="kernel", device=None, enc_out=None):
    """``decode_step`` over stacked params and caches: (logits [B, vocab],
    ``cache_slots``, written in place). Every slot is active, as in the
    reference's scanned decode."""
    layers = _layers(params, cfg)
    views = unstack_cache(cache_slots, cfg)
    logits, new_cache = decode_step(layers, cfg, token, views, impl,
                                    device=device, enc_out=enc_out)
    _write_back(views, new_cache)
    return logits, cache_slots
