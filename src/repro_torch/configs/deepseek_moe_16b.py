"""DeepSeekMoE 16B [arXiv:2401.06066; hf] — fine-grained MoE,
2 shared + 64 routed top-6 (d_expert=1408)."""
from ..models.transformer import ModelConfig, MoECfg
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    source="arXiv:2401.06066; hf:deepseek-ai/deepseek-moe-16b-base",
    model=ModelConfig(
        name="deepseek-moe-16b",
        vocab=102_400,
        d_model=2_048,
        n_layers=28,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10_944,            # dense-path FFN (layer 0 in the real model)
        ffn_gated=True,
        attn_kind="gqa",
        moe=MoECfg(n_routed=64, n_shared=2, top_k=6, d_expert=1_408),
        moe_every=1,
        max_seq=16_384,
        tie_embeddings=False,
    ),
))
