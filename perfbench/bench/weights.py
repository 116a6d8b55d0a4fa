"""Seeded float32 weights made on the card: one flat buffer drawn N(0, 1)
by one generator on the device in one call, each weight a view of it
scaled in place to the init's deviation (dense ``w`` N(0, 1/d_in),
embeddings and QKV biases N(0, 0.02^2), expert matrices N(0, 1/d_in)),
norm gains 1.

The same tensors go to both sides: by plain names to the reference, and
as the parameters of the port's ``Transformer`` (built on the meta device
and given the views, so nothing is allocated twice)."""
from __future__ import annotations

import math

ALIGN = 64          # elements: every view starts on a 256-byte boundary


def layout(m: dict) -> list[tuple[str, tuple, float | None]]:
    """(name, shape, std) of every weight of the configuration ``m`` (the
    ``model`` group of a configuration file); std ``None`` is a norm gain
    of ones."""
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    out = [("embed", (m["vocab"], d), 0.02)]
    moe = m.get("moe")
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm1", (d,), None),
                (p + "wq", (d, hq * hd), d ** -0.5),
                (p + "wk", (d, hkv * hd), d ** -0.5),
                (p + "wv", (d, hkv * hd), d ** -0.5),
                (p + "wo", (hq * hd, d), (hq * hd) ** -0.5),
                (p + "norm2", (d,), None)]
        if m.get("qkv_bias"):
            out += [(p + "bq", (hq * hd,), 0.02), (p + "bk", (hkv * hd,), 0.02),
                    (p + "bv", (hkv * hd,), 0.02)]
        if moe is not None and i % m.get("moe_every", 1) == m.get("moe_every", 1) - 1:
            e, de, ns = moe["n_routed"], moe["d_expert"], moe["n_shared"]
            out += [(p + "router", (d, e), d ** -0.5),
                    (p + "experts_wi", (e, d, 2 * de), d ** -0.5),
                    (p + "experts_wo", (e, de, d), de ** -0.5)]
            if ns > 0:
                out += [(p + "shared_wi", (d, 2 * de * ns), d ** -0.5),
                        (p + "shared_wo", (de * ns, d), (de * ns) ** -0.5)]
        else:
            f = m["d_ff"]
            out += [(p + "ffn_wi", (d, 2 * f), d ** -0.5),
                    (p + "ffn_wo", (f, d), f ** -0.5)]
    out += [("final_norm", (d,), None)]
    if not m.get("tie_embeddings", True):
        out += [("lm_head", (d, m["vocab"]), d ** -0.5)]
    return out


def make_weights(m: dict, seed: int, device) -> dict:
    """{name: tensor} of float32 weights on ``device`` from ``seed``."""
    import torch

    lay = layout(m)
    offs, total = [], 0
    for _, shape, _ in lay:
        offs.append(total)
        total += -(-math.prod(shape) // ALIGN) * ALIGN
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    flat.normal_(generator=gen)
    w = {}
    with torch.no_grad():
        for (name, shape, std), off in zip(lay, offs):
            v = flat[off: off + math.prod(shape)].view(shape)
            if std is None:
                v.fill_(1.0)
            else:
                v.mul_(std)
            w[name] = v
    return w


def port_model(cfg, w: dict):
    """The port's ``Transformer`` for the port's ``ModelConfig`` ``cfg``
    whose parameters are the tensors of ``w``."""
    import torch
    from torch import nn

    from repro_torch.models.transformer import Transformer

    t = Transformer(cfg, torch.float32, torch.device("meta"), None)

    def put(mod, attr, tensor):
        mod._parameters[attr] = nn.Parameter(tensor, requires_grad=False)

    put(t.embed, "e", w["embed"])
    put(t.final_norm, "g", w["final_norm"])
    if "lm_head" in w:
        put(t.lm_head, "w", w["lm_head"])
    for i, blk in enumerate(t.blocks):
        p = f"layers.{i}."
        put(blk.norm1, "g", w[p + "norm1"])
        put(blk.norm2, "g", w[p + "norm2"])
        for k in ("wq", "wk", "wv", "wo"):
            put(getattr(blk.attn, k), "w", w[p + k])
            if p + "b" + k[1] in w and k != "wo":
                put(getattr(blk.attn, k), "b", w[p + "b" + k[1]])
        if hasattr(blk, "moe"):
            put(blk.moe.router, "w", w[p + "router"])
            put(blk.moe, "wi", w[p + "experts_wi"])
            put(blk.moe, "wo", w[p + "experts_wo"])
            if p + "shared_wi" in w:
                put(blk.moe.shared_wi, "w", w[p + "shared_wi"])
                put(blk.moe.shared_wo, "w", w[p + "shared_wo"])
        else:
            put(blk.ffn.wi, "w", w[p + "ffn_wi"])
            put(blk.ffn.wo, "w", w[p + "ffn_wo"])
    left = [n for n, p in t.named_parameters() if p.device.type == "meta"]
    if left:
        raise ValueError(f"weights not given for {left}")
    return t
