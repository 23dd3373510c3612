"""Frozen operation counts of a routed mixture-of-experts decoder (OLMoE's
form: attention with QK-norm, every layer's feed-forward a mixture of
gated experts, top-k routing, untied unembedding), from the shapes of a
configuration file alone, as ``work`` counts the dense model's.

The count is the work the model needs: each token through its top-k
experts only, whatever the program computes (one card's dense fallback
runs every expert on every token, E / k times the experts' work).
"""
from __future__ import annotations

from portbench.counts import work


def attention_params(cfg: dict) -> int:
    """Weights of one layer's attention products: q, k, v and o."""
    d, h, kh, hd = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                    cfg["head_dim"])
    return 2 * d * h * hd + 2 * d * kh * hd


def routed_expert_params(cfg: dict) -> int:
    """Weights one token meets in one layer's experts: top_k gated MLPs of
    width ``d_ff_expert``."""
    return cfg["top_k"] * 3 * cfg["d_model"] * cfg["d_ff_expert"]


def router_params(cfg: dict) -> int:
    return cfg["d_model"] * cfg["num_experts"]


def prefill_flops(cfg: dict, batch: int, seq: int) -> int:
    """FLOPs of one prefill: every layer's attention products, router and
    routed experts on every token, the causal attention of every layer,
    and the unembedding of the last position (1.873e13 for
    OLMoE-1B-7B-0924 at 4 x 2048)."""
    tokens = batch * seq
    per_token = attention_params(cfg) + routed_expert_params(cfg) \
        + router_params(cfg)
    return (2 * cfg["n_layers"] * per_token * tokens
            + cfg["n_layers"] * work.causal_attention_flops(
                batch, seq, cfg["n_heads"], cfg["head_dim"])
            + 2 * cfg["d_model"] * cfg["vocab"] * batch)
