"""yi-9b [dense] — llama-arch GQA. 48L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000 [arXiv:2403.04652]."""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN,),
    supports_long_context=False,  # pure full attention — long_500k skipped
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=8,
        layer_pattern=(GLOBAL_ATTN,),
    )
