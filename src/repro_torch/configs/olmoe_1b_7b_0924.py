"""olmoe-1b-7b-0924 [moe] — OLMoE-1B-7B-0924 as published: 16L
d_model=2048 16H (kv=16) of 128, 64 SwiGLU experts of 1024, top-8 by a
float32 softmax over all 64 with the top-8 weights not renormalised
(``norm_topk_prob: false``), no shared expert, QK-norm over the whole
projected q and k widths, RMSNorm eps 1e-5, RoPE theta 10000, vocab 50304
untied, context 4096 [hf:allenai/OLMoE-1B-7B-0924, arXiv:2409.02060].

A configuration of the port alone (``configs.PORT_ONLY_IDS``): the JAX
package's ``olmoe-1b-7b`` (``olmoe_1b_7b.py``) has neither QK-norm nor
unrenormalised routing, and its eps is 1e-6.
"""
from repro_torch.configs.base import GLOBAL_ATTN, PortModelConfig, PortMoEConfig

CONFIG = PortModelConfig(
    name="olmoe-1b-7b-0924",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN,),
    rope_theta=10000.0,
    norm_eps=1e-5,
    moe=PortMoEConfig(num_experts=64, top_k=8, d_ff_expert=1024, interleave=1,
                      norm_topk_prob=False),
    max_seq=4096,
    supports_long_context=False,  # full attention — long_500k skipped
    qk_norm=True,
)


def smoke_config() -> PortModelConfig:
    return PortModelConfig(
        name="olmoe-0924-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab=256,
        head_dim=16,
        layer_pattern=(GLOBAL_ATTN,),
        norm_eps=1e-5,
        moe=PortMoEConfig(num_experts=8, top_k=2, d_ff_expert=32, interleave=1,
                          norm_topk_prob=False),
        max_seq=4096,
        qk_norm=True,
    )
