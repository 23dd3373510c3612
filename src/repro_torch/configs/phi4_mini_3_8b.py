"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA. 32L d_model=3072 24H (GQA kv=8)
d_ff=8192 vocab=200064 [arXiv:2412.08905]."""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN,),
    tie_embeddings=True,
    supports_long_context=False,  # pure full attention — long_500k skipped
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi4-smoke",
        family="dense",
        n_layers=3,
        d_model=48,
        n_heads=6,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        head_dim=8,
        layer_pattern=(GLOBAL_ATTN,),
        tie_embeddings=True,
    )
