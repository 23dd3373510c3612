"""whisper-large-v3 [audio] — encoder-decoder, conv frontend (STUB).
32 encoder + 32 decoder layers, d_model=1280 20H (kv=20) d_ff=5120 vocab=51866
[arXiv:2212.04356].

The conv1d mel frontend is a stub, as in the JAX package: the caller passes
precomputed frame embeddings of shape (batch, 1500, d_model), which feed the
encoder directly.
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers
    n_encoder_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    layer_pattern=(GLOBAL_ATTN,),
    gated_mlp=False,        # whisper uses GELU MLP
    enc_dec=True,
    encoder_seq=1500,
    frontend="audio",
    max_seq=32768,
    supports_long_context=False,  # full attention — long_500k skipped
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        n_layers=2,
        n_encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        head_dim=16,
        layer_pattern=(GLOBAL_ATTN,),
        gated_mlp=False,
        enc_dec=True,
        encoder_seq=24,
        frontend="audio",
    )
