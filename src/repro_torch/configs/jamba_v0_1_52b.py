"""Jamba v0.1 52B [arXiv:2403.19887; hf] — hybrid Mamba+attention 1:7
interleave, MoE 16 experts top-2 on every other layer."""
from ..models.transformer import ModelConfig, MoECfg
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
    sub_quadratic=True,
    model=ModelConfig(
        name="jamba-v0.1-52b",
        vocab=65_536,
        d_model=4_096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14_336,
        ffn_gated=True,
        attn_kind="gqa",
        moe=MoECfg(n_routed=16, n_shared=0, top_k=2, d_expert=14_336),
        moe_every=2,
        mixer="hybrid",
        attn_every=8,              # 1 attention : 7 mamba
        d_inner=8_192,
        ssm_state=16,
        mamba_heads=64,
        max_seq=262_144,
        tie_embeddings=False,
    ),
))
