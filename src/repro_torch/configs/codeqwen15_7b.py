"""codeqwen1.5-7b [dense] — qwen1.5 architecture, MHA. 32L d_model=4096 32H
(kv=32) d_ff=13440 vocab=92416 [hf:Qwen/CodeQwen1.5-7B]."""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN,),
    rope_theta=1000000.0,
    supports_long_context=False,  # pure full attention — long_500k skipped
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen-smoke",
        family="dense",
        n_layers=3,
        d_model=48,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab=256,
        head_dim=12,
        layer_pattern=(GLOBAL_ATTN,),
    )
