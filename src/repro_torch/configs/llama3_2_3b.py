"""Llama 3.2 3B [hf:meta-llama/Llama-3.2-3B; unverified] — dense GQA kv=8."""
from ..models.transformer import ModelConfig
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="llama3.2-3b",
    family="dense",
    source="hf:meta-llama/Llama-3.2-3B; unverified",
    model=ModelConfig(
        name="llama3.2-3b",
        vocab=128_256,
        d_model=3_072,
        n_layers=28,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8_192,
        ffn_gated=True,
        attn_kind="gqa",
        rope_theta=500_000.0,
        max_seq=131_072,
    ),
))
