"""The port's model stack (MHA / GQA / MLA attention, dense or MoE FFNs,
Mamba-2 and hybrid decoder LMs, encoder-decoder models) in torch,
unscanned and over stacked layers."""
from .stacked import (  # noqa: F401
    layer_period,
    stack_cache,
    stack_params,
    unstack_cache,
)
from .transformer import (  # noqa: F401
    ModelConfig,
    MoECfg,
    Transformer,
    decode_step,
    decode_step_scanned,
    encode,
    encode_scanned,
    extend,
    forward,
    forward_scanned,
    init_cache,
    init_model,
    param_count,
    prefill,
    prefill_scanned,
)
