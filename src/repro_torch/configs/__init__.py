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
# Importing the per-arch modules registers them.  The other eight archs of
# the reference come with their families (ROADMAP Queue 1).
from repro_torch.configs import gemma_2b  # noqa: F401
from repro_torch.configs import mamba2_2p7b  # noqa: F401
from repro_torch.configs import recurrentgemma_9b  # noqa: F401
