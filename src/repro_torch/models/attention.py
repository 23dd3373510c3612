"""Attention: GQA projections and the global-attention execution paths
(``repro/models/attention.py`` at the same path).

- ``flash_attention``: blockwise online-softmax attention in plain torch
  (the JAX package's scan over KV blocks); never materializes the full
  [S, T] score matrix.
- ``flash_attention_gqa`` (``kernels/flash_attention.py``): the hand-written
  CUDA kernel that replaces the Pallas one, taken for causal self-attention
  when ``use_kernel`` is set, as ``use_pallas`` routes ``_pallas_flash``.
- ``decode_attention``: one new token against a KV cache, plain torch (the
  JAX package computes it outside any Pallas kernel too).

Sliding-window attention, sequence-sharded decode and cross-attention
(``kv_override``) are not ported yet (ROADMAP.md Queue 1 item 6).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 flash_attention_gqa,
                                                 flash_attention_plain)
from repro_torch.models import layers as L

_NOT_PORTED = "is not ported yet (see ROADMAP.md Queue 1 item 6)"


def attn_init(gen, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, *, dtype, device, lead: Tuple[int, ...] = ()
              ) -> Dict[str, torch.Tensor]:
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(n_heads * head_dim)
    return {
        "wq": L.normal(gen, lead + (d_model, n_heads, head_dim), s_in,
                       dtype, device),
        "wk": L.normal(gen, lead + (d_model, n_kv_heads, head_dim), s_in,
                       dtype, device),
        "wv": L.normal(gen, lead + (d_model, n_kv_heads, head_dim), s_in,
                       dtype, device),
        "wo": L.normal(gen, lead + (n_heads, head_dim, d_model), s_out,
                       dtype, device),
    }


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,H,D] -> [B,S,K,G,D]: query head h belongs to KV head h // G."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


# ---------------------------------------------------------------------------
# Full (causal or bidirectional) blockwise attention
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_block: int = 512,
                    kv_block: int = 512) -> torch.Tensor:
    """q: [B,S,K,G,D]; k, v: [B,T,K,D]. Returns [B,S,K,G,D]. Positions
    are ``arange(S)`` / ``arange(T)``, the only ones the JAX package's
    attention layer passes; its ``kv_valid`` mask serves only the
    cross-attention, which is not ported. The blocks must divide S and
    T, as the JAX package asserts."""
    qb, kb = min(q_block, q.shape[1]), min(kv_block, k.shape[1])
    if q.shape[1] % qb or k.shape[1] % kb:
        raise ValueError(f"flash_attention: S={q.shape[1]}, T={k.shape[1]} "
                         f"must be multiples of the blocks ({qb}, {kb})")
    return flash_attention_plain(q, k, v, causal=causal, q_block=q_block,
                                 kv_block=kv_block)


def window_attention(*args, **kwargs):
    raise NotImplementedError(f"window_attention {_NOT_PORTED}")


def seq_sharded_decode(*args, **kwargs):
    raise NotImplementedError(f"seq_sharded_decode {_NOT_PORTED}")


def decode_attention_partial(*args, **kwargs):
    raise NotImplementedError(f"decode_attention_partial {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *,
                     valid: torch.Tensor) -> torch.Tensor:
    """q: [B,K,G,D] (one step), cache: [B,T,K,D], valid: [B,T] bool."""
    d = q.shape[-1]
    sc = torch.einsum("bkgd,btkd->bkgt", q.float(),
                      k_cache.float()) * d ** -0.5
    sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention layer (projection + rope + path dispatch + cache handling)
# ---------------------------------------------------------------------------

def init_attn_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                    *, dtype, device, lead: Tuple[int, ...] = ()
                    ) -> Dict[str, torch.Tensor]:
    shape = lead + (batch, cache_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, *w.shape[1:])


def attention_layer(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                    kind: str, rope_theta: float, n_kv_heads: int, mode: str,
                    lengths: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    seq_shard_axis: Optional[str] = None,
                    kv_override=None,
                    use_kernel: bool = False, flash_block: int = 512,
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One causal self-attention layer with RoPE (the JAX layer's
    ``causal`` and ``use_rope`` serve only the encoder-decoder, which is not
    ported). mode: 'train' | 'prefill' | 'decode'.

    Prefill with a ``cache`` writes the layer's k and v into its slots
    ``[0, S)`` in place and returns it; without one it returns the k and v
    of length S, as the JAX package does. Decode (``lengths`` [B]: the new
    token goes to position ``lengths[b]``) writes slot ``lengths[b]`` of the
    capacity cache in place and returns it. ``use_kernel`` is the
    counterpart of ``use_pallas``."""
    if kind != "global_attn":
        raise NotImplementedError(f"attention kind {kind!r} {_NOT_PORTED}")
    if seq_shard_axis is not None:
        raise NotImplementedError(f"seq_shard_axis {_NOT_PORTED}")
    if kv_override is not None:
        raise NotImplementedError(f"kv_override {_NOT_PORTED}")
    b, s, _ = x.shape
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])

    if mode in ("train", "prefill"):
        positions = torch.arange(s, device=x.device)
        q = L.apply_rope(q, positions, rope_theta)
        k = L.apply_rope(k, positions, rope_theta)
        qg = _split_gqa(q, n_kv_heads)
        if use_kernel and s % 128 == 0:
            out = flash_attention_gqa(qg, k, v)
        else:
            out = flash_attention(qg, k, v, q_block=flash_block,
                                  kv_block=flash_block)
        new_cache = None
        if mode == "prefill":
            if cache is None:
                new_cache = {"k": k, "v": v}
            else:
                cache["k"][:, :s] = k
                cache["v"][:, :s] = v
                new_cache = cache
    elif mode == "decode":
        if lengths is None or cache is None:
            raise ValueError("decode needs lengths and a cache")
        pos = lengths.to(torch.int64)                                 # [B]
        q = L.apply_rope(q, pos[:, None], rope_theta)
        k = L.apply_rope(k, pos[:, None], rope_theta)
        qd = _split_gqa(q, n_kv_heads)[:, 0]                          # [B,K,G,D]
        t = cache["k"].shape[1]
        rows = torch.arange(b, device=x.device)
        cache["k"][rows, pos] = k[:, 0]
        cache["v"][rows, pos] = v[:, 0]
        valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
        out = decode_attention(qd, cache["k"], cache["v"],
                               valid=valid)[:, None]
        new_cache = cache
    else:
        raise ValueError(mode)

    wo = params["wo"]                                                 # [H,D,M]
    y = out.to(x.dtype).reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    return y, new_cache
