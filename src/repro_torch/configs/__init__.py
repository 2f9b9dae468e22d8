from repro_torch.configs.base import (  # noqa: F401
    ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_arch,
    get_shape,
    list_archs,
    register_arch,
    shape_applicable,
)
# Importing the per-arch modules registers them.  mixtral-8x7b and
# deepseek-v2-236b come with their modules (ROADMAP Queue 1, items 6-7).
from repro_torch.configs import (  # noqa: F401
    gemma_2b,
    internlm2_20b,
    nemotron_4_15b,
    gemma3_12b,
    whisper_large_v3,
    paligemma_3b,
    mamba2_2p7b,
    recurrentgemma_9b,
)
