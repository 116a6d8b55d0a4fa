"""Mamba-2 2.7B [arXiv:2405.21060; unverified] — attention-free SSD
(state-space duality), mixer-only blocks (no FFN)."""
from ..models.transformer import ModelConfig
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    sub_quadratic=True,
    model=ModelConfig(
        name="mamba2-2.7b",
        vocab=50_280,
        d_model=2_560,
        n_layers=64,
        n_heads=0,
        n_kv_heads=0,
        head_dim=64,
        d_ff=0,                    # mixer-only blocks
        attn_kind="none",
        mixer="mamba",
        d_inner=5_120,
        ssm_state=128,
        mamba_heads=80,
        max_seq=1_048_576,
    ),
))
