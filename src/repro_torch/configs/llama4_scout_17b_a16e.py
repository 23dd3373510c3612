"""llama4-scout-17b-16e [moe] — 16 routed experts top-1 + shared expert,
early fusion. 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN,),
    rope_theta=500000.0,
    moe=MoEConfig(
        num_experts=16,
        top_k=1,
        d_ff_expert=8192,
        d_ff_shared=8192,     # llama4 always-on shared expert
        interleave=1,
    ),
    supports_long_context=False,  # full attention — long_500k skipped
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=8,
        layer_pattern=(GLOBAL_ATTN,),
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=128, d_ff_shared=128, interleave=1),
    )
