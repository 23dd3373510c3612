"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, pattern 1 local : 2
recurrent. 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427]."""
from repro_torch.configs.base import (
    LOCAL_ATTN,
    RGLRU,
    ModelConfig,
    RGLRUConfig,
)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    layer_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    window=2048,
    rope_theta=10000.0,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    supports_long_context=True,   # recurrent state + bounded window
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke",
        family="hybrid",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        head_dim=16,
        layer_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
        window=16,
        rglru=RGLRUConfig(lru_width=64, conv_width=4),
        supports_long_context=True,
    )
