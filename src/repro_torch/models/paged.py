"""Block-table-indexed serving paths over a paged KV block pool.

The dense serving cache is one ``[max_batch, max_len, ...]`` tensor per
layer; a request owns a whole row whether it uses 3 tokens of it or all of
them. The paged layout replaces the row with a *block pool*
``[num_blocks, block_len, ...]`` plus a per-request *block table* — the
vLLM/SHARK residency model — so the memory a request pins is proportional
to its context, and "can we admit one more warm decode" becomes a
free-list question instead of an assumption.

Index conventions (shared with ``repro_torch.serving.paged_cache``):

* block 0 is the reserved **null block**: block tables are padded with it,
  and any write that falls outside a request's allocated span is routed to
  it. Its contents are garbage by design — every attention path masks by
  ``len``, so garbage past the live context is never read (same invariant
  that lets the dense engine skip zero-on-admit). Padding lanes all write
  there (and to the scratch slot below), so their writes collide on
  purpose: which of them lands is never read.
* mamba / conv recurrent state has no sequence axis, so it stays
  slot-indexed: tensors carry ``max_batch + 1`` rows and the extra last row
  is the **scratch slot** used by batch-padding lanes.

The compute paths below *gather* a request batch's blocks into the dense
layout (advanced indexing copies, so the model functions may write into
the gathered cache freely), run the unmodified ``decode_step`` /
``extend`` model functions, and scatter the touched positions back into
the pools in place through the block table — so paged execution is
bit-identical in its unmasked reads to the dense engine at the same batch
width, which is the parity the serving tests pin down.
"""
from __future__ import annotations

import torch

from .. import spans
from ..core.timing import resolve_device
from .attention import init_attn_cache
from .mamba2 import init_mamba_cache
from .transformer import ModelConfig, check_supported, decode_step, extend

NULL_BLOCK = 0


def is_slot_layer(layer: dict) -> bool:
    """Recurrent (mamba) layers keep per-slot state; attention layers page."""
    return "state" in layer


def init_paged_pools(cfg: ModelConfig, max_batch: int, num_blocks: int,
                     block_len: int, dtype=torch.float32, device=None):
    """Per-layer pools on ``device`` (``None`` = CUDA): attention layers
    get ``[num_blocks, block_len, ...]`` KV pools of ``dtype`` (reusing the
    dense cache constructor with the pool shape); recurrent layers get
    float32 slot state with one extra scratch row."""
    check_supported(cfg)
    dev = resolve_device(device)
    pools = []
    for i in range(cfg.n_layers):
        if cfg.mixer_kind(i) == "attn":
            c = init_attn_cache(cfg, num_blocks, block_len, dtype, dev)
        else:
            c = init_mamba_cache(cfg, max_batch + 1, dev)
        c.pop("len")            # lengths live host-side, per slot
        pools.append(c)
    return pools


def gather_paged_cache(pools, tables, lens, slots):
    """Assemble the dense per-request cache view a model function expects.

    ``tables``: [N, T] integer block ids; ``lens``: [N] int32 live context
    lengths; ``slots``: [N] slot ids for the recurrent state rows (all on
    the pools' device). Returns a cache list in the dense engine layout
    ([N, T*block_len, ...] per attention layer), every tensor a copy —
    positions past ``lens`` hold whatever the referenced blocks hold (the
    null block included) and rely on length masking downstream.
    """
    n, t = tables.shape
    cache = []
    with spans.span("paged.gather"):
        for layer in pools:
            if is_slot_layer(layer):
                d = {k: v[slots] for k, v in layer.items()}
            else:
                d = {}
                for k, pool in layer.items():
                    g = pool[tables]                   # [N, T, bl, ...]
                    d[k] = g.reshape((n, t * pool.shape[1]) + pool.shape[2:])
            d["len"] = lens
            cache.append(d)
        if spans.active():
            spans.add(bytes=sum(v.nbytes for d in cache for k, v in d.items()
                                if k != "len"))
    return cache


def paged_decode(params, cfg: ModelConfig, tokens, pools, tables, lens,
                 slots, block_len: int, impl: str = "kernel", device=None):
    """One decode step for a batch of paged requests.

    Gathers each request's blocks into the dense layout, runs the stock
    ``decode_step``, then writes exactly one KV position per request back
    into its block (position ``lens[j]`` lands in block
    ``tables[j, lens[j] // block_len]``; a position past the table goes to
    the null block) and each lane's new recurrent state into its slot, in
    place. Padding lanes must use the null block table and the scratch
    slot so their writes are sunk. Returns ``(argmax tokens [N], pools)``.
    """
    cache = gather_paged_cache(pools, tables, lens, slots)
    logits, new_cache = decode_step(params, cfg, tokens, cache, impl=impl,
                                    device=device)
    with spans.span("paged.write_back"):
        _scatter_decode(pools, new_cache, tables, lens, slots, block_len)
    return torch.argmax(logits, -1), pools


def _scatter_decode(pools, new_cache, tables, lens, slots, block_len: int):
    """:func:`paged_decode`'s write-back: the KV row at ``lens[j]`` of each
    lane's dense cache into its block, and each lane's state into its
    slot, in place."""
    n, t = tables.shape
    rows = torch.arange(n, device=tables.device)
    blk = (lens // block_len).long()
    bidx = torch.where(blk < t, tables[rows, blk.clamp(max=t - 1)],
                       NULL_BLOCK)                     # [N] target blocks
    off = (lens % block_len).long()
    for layer, new in zip(pools, new_cache):
        if is_slot_layer(layer):
            for k, pool in layer.items():
                pool[slots] = new[k]
            continue
        for k, pool in layer.items():
            arr = new[k]                               # dense [N, S, ...]
            at = lens.long().clamp(max=arr.shape[1] - 1)
            pool[bidx, off] = arr[rows, at].to(pool.dtype)


def paged_extend(params, cfg: ModelConfig, tokens, pools, table, off: int,
                 slot: int, length: int, block_len: int,
                 impl: str = "kernel", device=None):
    """One (possibly chunked/padded) prefill chunk for a single request.

    ``tokens``: [C] right-padded chunk; ``table``: [T] the request's block
    table (on the pools' device); ``off``: current context length (write
    offset); ``slot``: its state row; ``length``: true chunk length — the
    last three host integers. Runs the stock ``extend`` over the gathered
    dense row, then writes back in place the whole-block window of
    ``ceil(C / block_len) + 1`` blocks from the one holding ``off`` — the
    blocks are request-owned so rewriting untouched leading/trailing
    positions in the window is a no-op, and window blocks past the table
    (or past the allocated span) are routed to the null block.
    Returns ``(argmax token, pools)``.
    """
    c = tokens.shape[0]
    t = table.shape[0]
    dev = table.device
    w = (c + block_len - 1) // block_len + 1           # window, static
    lens1 = torch.full((1,), off, dtype=torch.int32, device=dev)
    slots1 = torch.full((1,), slot, dtype=torch.long, device=dev)
    cache = gather_paged_cache(pools, table[None], lens1, slots1)
    logits, new_cache = extend(params, cfg, tokens[None], cache, impl=impl,
                               length=length, device=device)
    w0 = off // block_len
    widx = w0 + torch.arange(w, device=dev)
    safe = torch.where(widx < t, table[widx.clamp(max=t - 1)], NULL_BLOCK)
    for layer, new in zip(pools, new_cache):
        if is_slot_layer(layer):
            for k, pool in layer.items():
                pool[slot] = new[k][0]
            continue
        for k, pool in layer.items():
            row = new[k][0]                            # [S, ...]
            pad = row.new_zeros((w * block_len,) + row.shape[1:])
            row = torch.cat([row, pad])
            win = row[w0 * block_len:(w0 + w) * block_len]
            win = win.reshape((w, block_len) + row.shape[1:])
            pool[safe] = win.to(pool.dtype)
    return torch.argmax(logits, -1)[0], pools
