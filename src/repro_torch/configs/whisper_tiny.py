"""Whisper tiny [arXiv:2212.04356; unverified] — encoder-decoder; the conv
audio frontend is a stub: callers pass precomputed frame embeddings to
``encode``. LayerNorm + GELU FFN; RoPE stands in for the learned /
sinusoidal positions of the published model, as in the JAX package, and
cross-attention applies none."""
from ..models.transformer import ModelConfig
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356; unverified",
    modality_stub="audio",
    model=ModelConfig(
        name="whisper-tiny",
        vocab=51_865,
        d_model=384,
        n_layers=4,               # decoder blocks
        encoder_layers=4,
        encoder_len=1_500,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1_536,
        ffn_gated=False,
        norm="layernorm",
        attn_kind="gqa",
        cross_attention=True,
        max_seq=4_096,
    ),
))
