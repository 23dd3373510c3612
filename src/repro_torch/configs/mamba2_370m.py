"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
48L d_model=1024 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060]."""
from repro_torch.configs.base import SSD, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=1,              # attention-free; SSD heads derive from ssm config
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    layer_pattern=(SSD,),
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, chunk_size=256, conv_width=4),
    tie_embeddings=True,
    supports_long_context=True,   # constant-size recurrent state
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=256,
        layer_pattern=(SSD,),
        ssm=SSMConfig(d_state=16, expand=2, headdim=32, chunk_size=16, conv_width=4),
        tie_embeddings=True,
        supports_long_context=True,
    )
