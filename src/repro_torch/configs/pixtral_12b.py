"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB) + mistral-nemo text
backbone. 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409].

The vision frontend is a stub, as in the JAX package: the caller passes
precomputed patch embeddings ``vision_embeds`` of shape (batch,
frontend_tokens, d_model), early-fused at the head of the sequence.
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN,),
    rope_theta=1000000.0,
    frontend="vision",
    frontend_tokens=256,
    supports_long_context=False,  # pure full attention — long_500k skipped
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke",
        family="vlm",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        layer_pattern=(GLOBAL_ATTN,),
        frontend="vision",
        frontend_tokens=8,
    )
