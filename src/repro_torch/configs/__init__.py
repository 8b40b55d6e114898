"""Architecture registry (port of ``repro.configs``) — importing this
package registers every assigned arch."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeSpec, SHAPES, get_config, list_archs, register,
    shape_applicable,
)

# one module per assigned architecture (registration happens at import)
from repro_torch.configs import (  # noqa: F401
    gemma_7b,
    qwen3_14b,
    phi3_mini_3_8b,
    stablelm_1_6b,
    llava_next_mistral_7b,
    musicgen_large,
    zamba2_2_7b,
    kimi_k2_1t_a32b,
    deepseek_v3_671b,
    mamba2_370m,
)

ARCHS = list_archs()
