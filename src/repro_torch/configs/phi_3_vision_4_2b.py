"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf] —
phi3-mini backbone; the CLIP vision frontend is a stub: callers pass
precomputed patch embeddings as ``inputs_embeds`` to ``forward`` and
``prefill``. Published phi-3 scales RoPE (LongRoPE); as in the JAX package,
the config keeps plain RoPE at ``rope_theta`` 10,000."""
from ..models.transformer import ModelConfig
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    modality_stub="vision",
    model=ModelConfig(
        name="phi-3-vision-4.2b",
        vocab=32_064,
        d_model=3_072,
        n_layers=32,
        n_heads=32,
        n_kv_heads=32,
        head_dim=96,
        d_ff=8_192,
        ffn_gated=True,
        attn_kind="gqa",
        max_seq=131_072,
    ),
))
