"""Decoder-only LM assembly (``repro/models/transformer.py`` at the same
path), for stacks whose every layer is global attention + MLP.

As in the JAX package, each layer parameter is stacked along a leading
``layers`` axis (its ``periods`` tree, whose period is one layer for these
stacks), and the KV cache likewise: ``{"k", "v"}: [L, B, T, KH, D]``. The
stack runs as a Python loop over layer views, where the JAX package scans.
The weights live in a ``ParamTree`` module; the apply functions are plain
functions over it, like their JAX counterparts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class Flags:
    """The lowering flags this path reads.

    ``use_flash_kernel`` is the counterpart of the JAX package's
    ``use_pallas_flash``: causal self-attention with S a multiple of 128
    goes through the hand-written CUDA kernel (its plain version on a CPU
    tensor). It is on in ``DEFAULT_FLAGS``, the serving path on the card.
    ``flash_block`` is the block of the plain blockwise path; the JAX
    package declares the same field and its attention uses 512, the
    default here."""
    param_dtype: Any = torch.bfloat16
    use_flash_kernel: bool = True
    flash_block: int = 512


DEFAULT_FLAGS = Flags()
SMOKE_FLAGS = Flags(param_dtype=torch.float32, use_flash_kernel=False)

_NOT_PORTED = "not ported yet (see ROADMAP.md Queue 1 item 6)"


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.enc_dec or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: encoder-decoder and "
                                  f"frontend models are {_NOT_PORTED}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are {_NOT_PORTED}")
    kinds = set(cfg.layer_pattern)
    if kinds != {GLOBAL_ATTN}:
        raise NotImplementedError(f"{cfg.name}: layer kinds "
                                  f"{sorted(kinds - {GLOBAL_ATTN})} are "
                                  f"{_NOT_PORTED}")


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters without gradients."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        """The nested dict of tensors."""
        out: Dict[str, Any] = {k: p.data for k, p in self._parameters.items()}
        for key, m in self._modules.items():
            out[key] = m.tree()
        return out


def _tree(params) -> Dict[str, Any]:
    """The weights as a nested dict, from a ``ParamTree`` or a dict."""
    return params.tree() if isinstance(params, ParamTree) else params


def _at(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Views of every leaf at position ``i`` of its leading axis."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Per-layer block = attention + MLP, pre-norm residual
# ---------------------------------------------------------------------------

def block_init(gen, cfg: ModelConfig, *, dtype, device,
               lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    return {
        "norm1": L.scale_init(cfg.d_model, device=device, lead=lead),
        "attn": A.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim, dtype=dtype,
                            device=device, lead=lead),
        "norm2": L.scale_init(cfg.d_model, device=device, lead=lead),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                          dtype=dtype, device=device, lead=lead),
    }


def block_apply(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
                mode: str, flags: Flags, cache: Optional[Dict] = None,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (x, new_cache)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    mix, new_cache = A.attention_layer(
        p["attn"], h, kind=GLOBAL_ATTN, rope_theta=cfg.rope_theta, n_kv_heads=cfg.n_kv_heads, mode=mode,
        lengths=lengths, cache=cache, use_kernel=flags.use_flash_kernel,
        flash_block=flags.flash_block)
    x = x + mix
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp_apply(p["mlp"], h, cfg.gated_mlp), new_cache


# ---------------------------------------------------------------------------
# Whole-model init / apply
# ---------------------------------------------------------------------------

def lm_init(gen: torch.Generator, cfg: ModelConfig,
            flags: Flags = DEFAULT_FLAGS, device="cuda") -> ParamTree:
    """Random weights from ``gen`` (a generator on ``device``):
    ``embed`` [V, D], ``final_norm`` [D], ``unembed`` [D, V] (absent when
    tied) and ``layers``, each leaf with a leading layer axis: ``norm1``,
    ``attn.{wq,wk,wv,wo}``, ``norm2``, ``mlp.{wi,wo[,wg]}``."""
    _check_supported(cfg)
    dtype = flags.param_dtype
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dtype=dtype,
                              device=device),
        "final_norm": L.scale_init(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, cfg.d_model, cfg.vocab,
                                         dtype=dtype, device=device)
    params["layers"] = block_init(gen, cfg, dtype=dtype, device=device,
                                  lead=(cfg.n_layers,))
    return ParamTree(params)


def lm_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  flags: Flags = DEFAULT_FLAGS, device="cuda"
                  ) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache at capacity: ``{"k", "v"}: [L, B, T, KH, D]``."""
    _check_supported(cfg)
    return A.init_attn_cache(batch, cache_len, cfg.n_kv_heads,
                             cfg.resolved_head_dim, dtype=flags.param_dtype,
                             device=device, lead=(cfg.n_layers,))


def lm_apply(params, batch: Dict[str, torch.Tensor], *,
             cfg: ModelConfig, mode: str, flags: Flags = DEFAULT_FLAGS,
             cache: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (final hidden [B,S,D], cache). The unembedding is applied by
    the caller. A prefill or decode with ``cache`` updates it in place and
    returns it; a prefill without one returns a new cache of length S.
    ``params`` is a ``ParamTree`` or its ``tree()``."""
    p = _tree(params)
    lengths = batch.get("lengths")
    x = p["embed"][batch["tokens"].long()]
    new_k, new_v = [], []
    for i in range(cfg.n_layers):
        c_in = None if cache is None else \
            {"k": cache["k"][i], "v": cache["v"][i]}
        x, c_out = block_apply(_at(p["layers"], i), x, cfg=cfg, mode=mode,
                               flags=flags, cache=c_in, lengths=lengths)
        if mode == "prefill" and cache is None:
            new_k.append(c_out["k"])
            new_v.append(c_out["v"])
    x = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    if mode == "train":
        return x, None
    if cache is None:
        cache = {"k": torch.stack(new_k), "v": torch.stack(new_v)}
    return x, cache


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits for a (small) x. [B,S,D] -> [B,S,V]."""
    p = _tree(params)
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["unembed"]
