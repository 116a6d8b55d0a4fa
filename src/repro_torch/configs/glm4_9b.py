"""GLM-4 9B [hf:THUDM/glm-4-9b; hf] — dense, RoPE, GQA kv=2."""
from ..models.transformer import ModelConfig
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="glm4-9b",
    family="dense",
    source="hf:THUDM/glm-4-9b",
    model=ModelConfig(
        name="glm4-9b",
        vocab=151_552,
        d_model=4_096,
        n_layers=40,
        n_heads=32,
        n_kv_heads=2,
        head_dim=128,
        d_ff=13_696,
        ffn_gated=True,
        attn_kind="gqa",
        max_seq=131_072,
        tie_embeddings=False,
    ),
))
