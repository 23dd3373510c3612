"""Model configurations of the port (``repro/configs`` at the same path)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    GLOBAL_ATTN,
    LOCAL_ATTN,
    PORTED_ARCH_IDS,
    RGLRU,
    SSD,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
    canon,
    get_config,
    get_smoke_config,
)
