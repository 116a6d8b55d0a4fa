"""The operations and bytes each measured piece of work needs, from its
shapes: the yardstick of the roofline shares and of the model's share of
the card's peak. Each input is counted read once and each output written
once."""
from __future__ import annotations


def mapping_eval_traffic(n_batch: int, pop: int, n_flat: int, t_len: int,
                         width: int, n_chips: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one fused pass A + B call: the
    un-gathered cost rows (B, P, L), the schedule index, chip and
    predecessor positions (P, T, 2 + W) in, the ends and chip-free times
    (B, P, T + C) out; per (b, p, t) W + 1 maxes and one add (the counts
    of PERF.md's kernel table)."""
    in_bytes = 4 * n_batch * pop * n_flat + 4 * pop * t_len * (2 + width)
    out_bytes = 4 * n_batch * pop * (t_len + n_chips)
    return in_bytes + out_bytes, n_batch * pop * t_len * (width + 2)


def decode_attention_traffic(m: dict, lengths: list[int], lanes: int) -> tuple[int, int]:
    """(bytes, operations) of one layer's decode-attention call over
    ``lanes`` lanes (the batch bucket), of which the first len(lengths) are
    live with those context lengths after the step's write; padding lanes
    attend one row. Only the live K and V rows are read."""
    hq, hkv, d = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    live = sum(lengths) + (lanes - len(lengths))
    nbytes = 4 * (live * hkv * d * 2 + 2 * lanes * hq * d) + 4 * lanes
    return nbytes, 4 * hq * d * live


def params_per_token(m: dict) -> tuple[int, int]:
    """(weights every layer stack applies to one token, weights of the
    head): attention projections, the dense FFN or the router, the top-k
    routed experts and the shared experts; the embedding is a lookup."""
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = d * hq * hd * 2 + d * hkv * hd * 2
    moe = m.get("moe")
    every = m.get("moe_every", 1)
    total = 0
    for i in range(m["n_layers"]):
        total += attn
        if moe is not None and i % every == every - 1:
            de = moe["d_expert"]
            total += d * moe["n_routed"]
            total += (moe["top_k"] + moe["n_shared"]) * 3 * d * de
        else:
            total += 3 * d * m["d_ff"]
    return total, d * m["vocab"]


def model_flops(m: dict, contexts: list[int], heads: int) -> float:
    """FLOPs the model needs for tokens at the given context lengths (each
    token's own position included) with ``heads`` applications of the
    output head: 2 per weight a token uses, and 4 * Hq * D per attended
    position in every layer."""
    per_tok, head = params_per_token(m)
    attn = 4 * m["n_heads"] * m["head_dim"] * m["n_layers"] * sum(contexts)
    return 2.0 * per_tok * len(contexts) + 2.0 * head * heads + attn
