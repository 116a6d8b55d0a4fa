"""The port's model stack (MHA / GQA / MLA attention, dense or MoE FFNs,
Mamba-2 and hybrid decoder LMs) in torch."""
from .transformer import (  # noqa: F401
    ModelConfig,
    MoECfg,
    Transformer,
    decode_step,
    extend,
    forward,
    init_cache,
    init_model,
    param_count,
    prefill,
)
