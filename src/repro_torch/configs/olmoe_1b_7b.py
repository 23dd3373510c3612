"""olmoe-1b-7b [moe] — 64 experts, top-8 routing. 16L d_model=2048 16H (kv=16)
d_ff=1024 (per expert) vocab=50304 [arXiv:2409.02060]."""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN,),
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024, interleave=1),
    supports_long_context=False,  # full attention — long_500k skipped
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab=256,
        head_dim=16,
        layer_pattern=(GLOBAL_ATTN,),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, interleave=1),
    )
