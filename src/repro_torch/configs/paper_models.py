"""The paper's own evaluation models (§VI-A): GPT3-7B / GPT3-13B
[NeurIPS 2020 GPT-3] and LLaMA3-70B [arXiv:2407.21783] — used by the
benchmark suite, selectable like any other arch."""
from ..models.transformer import ModelConfig
from .base import ArchConfig, register

GPT3_7B = register(ArchConfig(
    arch_id="gpt3-7b",
    family="dense",
    source="NeurIPS 2020 (GPT-3, 6.7B row)",
    model=ModelConfig(
        name="gpt3-7b", vocab=50_257, d_model=4_096, n_layers=32,
        n_heads=32, n_kv_heads=32, head_dim=128, d_ff=16_384,
        ffn_gated=False, norm="layernorm", attn_kind="gqa", max_seq=32_768,
    ),
))

GPT3_13B = register(ArchConfig(
    arch_id="gpt3-13b",
    family="dense",
    source="NeurIPS 2020 (GPT-3, 13B row)",
    model=ModelConfig(
        name="gpt3-13b", vocab=50_257, d_model=5_120, n_layers=40,
        n_heads=40, n_kv_heads=40, head_dim=128, d_ff=20_480,
        ffn_gated=False, norm="layernorm", attn_kind="gqa", max_seq=32_768,
    ),
))

LLAMA3_70B = register(ArchConfig(
    arch_id="llama3-70b",
    family="dense",
    source="arXiv:2407.21783",
    model=ModelConfig(
        name="llama3-70b", vocab=128_256, d_model=8_192, n_layers=80,
        n_heads=64, n_kv_heads=8, head_dim=128, d_ff=28_672,
        ffn_gated=True, attn_kind="gqa", max_seq=131_072,
        tie_embeddings=False,
    ),
))
