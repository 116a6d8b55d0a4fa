"""Architecture registry of the port: the dense, MLA and MoE attention,
Mamba-2, hybrid and encoder-decoder configs (and the paper's own
evaluation models), each paired with its input shapes, a reduced
smoke-test config, and the DSE engine's
:class:`~repro_torch.core.workload.LLMSpec`. A copy of the JAX package's
``configs/base.py`` with the imports rewritten."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..core.workload import LLMSpec, MoESpec
from ..models.transformer import ModelConfig, MoECfg

TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, TRAIN),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, PREFILL),
    "decode_32k": Shape("decode_32k", 32_768, 128, DECODE),
    "long_500k": Shape("long_500k", 524_288, 1, DECODE),
}


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                 # moe | dense | audio | hybrid | ssm | vlm
    model: ModelConfig
    source: str
    sub_quadratic: bool = False
    modality_stub: str | None = None  # audio | vision

    def shapes(self) -> list[Shape]:
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.sub_quadratic:
            out.append(SHAPES["long_500k"])
        return out

    def skipped_shapes(self) -> list[tuple[Shape, str]]:
        if self.sub_quadratic:
            return []
        return [(SHAPES["long_500k"],
                 "pure full-attention arch — long_500k requires sub-quadratic "
                 "attention")]

    def reduced(self) -> ModelConfig:
        """Family-representative small config for CPU smoke tests."""
        m = self.model
        period = 1
        if m.mixer == "hybrid":
            period = 4
        if m.moe is not None:
            period = max(period, m.moe_every)
        n_layers = max(2, period)
        moe = None
        if m.moe is not None:
            moe = MoECfg(n_routed=8, n_shared=min(m.moe.n_shared, 1),
                         top_k=min(m.moe.top_k, 2), d_expert=64)
        return dataclasses.replace(
            m,
            name=m.name + "-reduced",
            vocab=512,
            d_model=128,
            n_layers=n_layers,
            n_heads=4,
            n_kv_heads=max(1, min(m.n_kv_heads, 2)) if m.n_kv_heads < m.n_heads else 4,
            head_dim=32,
            d_ff=256 if m.d_ff > 0 else 0,
            mla_kv_rank=32 if m.attn_kind == "mla" else 0,
            mla_rope_dim=16 if m.attn_kind == "mla" else 64,
            moe=moe,
            attn_every=4 if m.mixer == "hybrid" else m.attn_every,
            d_inner=256 if m.d_inner else 0,
            ssm_state=16 if m.ssm_state else 0,
            mamba_heads=4 if m.d_inner else 8,
            encoder_layers=2 if m.encoder_layers else 0,
            encoder_len=16 if m.encoder_layers else m.encoder_len,
            max_seq=256,
        )

    def llm_spec(self) -> LLMSpec:
        """Map the model config onto the DSE engine's workload spec."""
        m = self.model
        moe = None
        if m.moe is not None:
            moe = MoESpec(m.moe.n_routed, m.moe.n_shared, m.moe.top_k,
                          m.moe.d_expert)
        return LLMSpec(
            name=self.arch_id,
            d_model=m.d_model,
            n_heads=m.n_heads,
            n_kv_heads=m.n_kv_heads,
            head_dim=m.head_dim,
            d_ff=m.d_ff,
            vocab=m.vocab,
            n_layers=m.n_layers,
            ffn_gated=m.ffn_gated,
            attn_kind=m.attn_kind,
            mla_kv_rank=m.mla_kv_rank,
            mla_rope_dim=m.mla_rope_dim,
            moe=moe,
            moe_every=m.moe_every,
            mixer=m.mixer,
            attn_every=m.attn_every,
            d_inner=m.d_inner,
            ssm_state=m.ssm_state,
            cross_attention=m.cross_attention,
            cross_len=m.encoder_len,
        )


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get(arch_id: str) -> ArchConfig:
    from . import _load_all
    _load_all()
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise ValueError(f"unknown arch {arch_id!r}; choose from "
                         f"{sorted(_REGISTRY)}") from None


def all_archs() -> dict[str, ArchConfig]:
    from . import _load_all
    _load_all()
    return dict(_REGISTRY)


def llm_spec(arch_id: str) -> LLMSpec:
    """The DSE workload spec of ``arch_id``."""
    return get(arch_id).llm_spec()
