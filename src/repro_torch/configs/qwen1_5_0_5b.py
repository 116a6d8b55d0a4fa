"""Qwen1.5 0.5B [hf:Qwen/Qwen1.5-0.5B; hf] — dense MHA with QKV bias."""
from ..models.transformer import ModelConfig
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    model=ModelConfig(
        name="qwen1.5-0.5b",
        vocab=151_936,
        d_model=1_024,
        n_layers=24,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=2_816,
        ffn_gated=True,
        attn_kind="gqa",
        qkv_bias=True,
        max_seq=32_768,
    ),
))
