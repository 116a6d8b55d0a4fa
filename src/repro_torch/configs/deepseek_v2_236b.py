"""DeepSeek-V2 236B [arXiv:2405.04434; hf] — MLA (kv_lora=512) + MoE
(2 shared + 160 routed, top-6, fine-grained d_expert=1536)."""
from ..models.transformer import ModelConfig, MoECfg
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2",
    model=ModelConfig(
        name="deepseek-v2-236b",
        vocab=102_400,
        d_model=5_120,
        n_layers=60,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12_288,            # dense-path FFN (first layer in the real model)
        ffn_gated=True,
        attn_kind="mla",
        mla_kv_rank=512,
        mla_rope_dim=64,
        moe=MoECfg(n_routed=160, n_shared=2, top_k=6, d_expert=1_536),
        moe_every=1,
        max_seq=131_072,
        tie_embeddings=False,
    ),
))
