"""Qwen2 1.5B [arXiv:2407.10671; hf] — GQA kv=2, QKV bias."""
from ..models.transformer import ModelConfig
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="qwen2-1.5b",
    family="dense",
    source="arXiv:2407.10671; hf:Qwen/Qwen2-1.5B",
    model=ModelConfig(
        name="qwen2-1.5b",
        vocab=151_936,
        d_model=1_536,
        n_layers=28,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8_960,
        ffn_gated=True,
        attn_kind="gqa",
        qkv_bias=True,
        max_seq=131_072,
    ),
))
