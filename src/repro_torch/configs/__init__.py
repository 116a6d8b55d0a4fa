"""Architecture configs of the port — ``--arch <id>`` registry."""
from .base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    Shape,
    all_archs,
    get,
    llm_spec,
    register,
)

_LOADED = False

# the architectures the dry run and the roofline cover (the JAX package's
# ``configs.ASSIGNED_ARCHS``)
ASSIGNED_ARCHS = (
    "deepseek-v2-236b", "deepseek-moe-16b", "llama3.2-3b", "qwen1.5-0.5b",
    "qwen2-1.5b", "glm4-9b", "whisper-tiny", "jamba-v0.1-52b",
    "mamba2-2.7b", "phi-3-vision-4.2b",
)


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        deepseek_moe_16b,
        deepseek_v2_236b,
        glm4_9b,
        jamba_v0_1_52b,
        llama3_2_3b,
        mamba2_2_7b,
        paper_models,
        phi_3_vision_4_2b,
        qwen1_5_0_5b,
        qwen2_1_5b,
        whisper_tiny,
    )
