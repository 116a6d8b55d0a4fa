"""Workload specs of the models the port's mapping search is run on.

The DSE engine needs only an :class:`~repro_torch.core.workload.LLMSpec`
per model, so this is a table of specs at their published widths (the
same numbers the JAX package's model configs map onto their specs):
``llama3.2-3b`` (the canonical search scenario) and the paper's own
evaluation models ``gpt3-7b``, ``gpt3-13b`` [NeurIPS 2020, GPT-3 table
rows] and ``llama3-70b`` [arXiv:2407.21783].
"""
from __future__ import annotations

from .core.workload import LLMSpec

SPECS: dict[str, LLMSpec] = {
    "llama3.2-3b": LLMSpec(
        name="llama3.2-3b", d_model=3_072, n_heads=24, n_kv_heads=8,
        head_dim=128, d_ff=8_192, vocab=128_256, n_layers=28,
        ffn_gated=True, attn_kind="gqa"),
    "gpt3-7b": LLMSpec(
        name="gpt3-7b", d_model=4_096, n_heads=32, n_kv_heads=32,
        head_dim=128, d_ff=16_384, vocab=50_257, n_layers=32,
        ffn_gated=False, attn_kind="gqa"),
    "gpt3-13b": LLMSpec(
        name="gpt3-13b", d_model=5_120, n_heads=40, n_kv_heads=40,
        head_dim=128, d_ff=20_480, vocab=50_257, n_layers=40,
        ffn_gated=False, attn_kind="gqa"),
    "llama3-70b": LLMSpec(
        name="llama3-70b", d_model=8_192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=28_672, vocab=128_256, n_layers=80,
        ffn_gated=True, attn_kind="gqa"),
}


def llm_spec(arch_id: str) -> LLMSpec:
    """The DSE workload spec of ``arch_id``."""
    try:
        return SPECS[arch_id]
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; choose from "
                         f"{sorted(SPECS)}") from None
