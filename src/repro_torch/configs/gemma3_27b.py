"""gemma3-27b [dense] — 5 local : 1 global attention, 128k context.
62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3-27b-pt family]."""
from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    layer_pattern=(LOCAL_ATTN,) * 5 + (GLOBAL_ATTN,),
    window=1024,
    # one base for local and global layers, as the JAX model applies it
    rope_theta=10000.0,
    max_seq=131072,
    # 5:1 local:global — decode cost is dominated by bounded-window local
    # layers; global layers decode with a seq-sharded KV cache at 500k.
    supports_long_context=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke",
        family="dense",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
        layer_pattern=(LOCAL_ATTN,) * 5 + (GLOBAL_ATTN,),
        window=16,
        supports_long_context=True,
    )
