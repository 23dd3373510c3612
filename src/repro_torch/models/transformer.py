"""Decoder-only LM assembly (``repro/models/transformer.py`` at the same
path), for stacks whose every layer is global attention + MLP, or whose
every layer is a Mamba-2 SSD block (no MLP, no ``norm2``).

As in the JAX package, each layer parameter is stacked along a leading
``layers`` axis (its ``periods`` tree, whose period is one layer for these
stacks), and the cache likewise: ``{"k", "v"}: [L, B, T, KH, D]`` for
attention, ``{"conv": [L, B, W-1, C], "state": [L, B, H, P, N]}`` for SSD.
The stack runs as a Python loop over layer views, where the JAX package
scans. The weights live in a ``ParamTree`` module; the apply functions are
plain functions over it, like their JAX counterparts.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import GLOBAL_ATTN, SSD, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S


@dataclasses.dataclass(frozen=True)
class Flags:
    """The lowering flags this path reads.

    ``use_flash_kernel`` is the counterpart of the JAX package's
    ``use_pallas_flash``: causal self-attention with S a multiple of 128
    goes through the hand-written CUDA kernel (its plain version on a CPU
    tensor). It is on in ``DEFAULT_FLAGS``, the serving path on the card.
    ``flash_block`` is the block of the plain blockwise path; the JAX
    package declares the same field and its attention uses 512, the
    default here. ``use_ssd_kernel`` takes the SSD block's intra-chunk
    form (one group) from the hand-written CUDA kernel (its plain version
    on a CPU tensor) instead of the einsum path; the JAX model never calls
    its Pallas kernel, whose function is the same."""
    param_dtype: Any = torch.bfloat16
    use_flash_kernel: bool = True
    flash_block: int = 512
    use_ssd_kernel: bool = True


DEFAULT_FLAGS = Flags()
SMOKE_FLAGS = Flags(param_dtype=torch.float32, use_flash_kernel=False,
                    use_ssd_kernel=False)

_NOT_PORTED = "not ported yet (see ROADMAP.md Queue 1 item 6)"


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.enc_dec or cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: encoder-decoder and "
                                  f"frontend models are {_NOT_PORTED}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are {_NOT_PORTED}")
    kinds = set(cfg.layer_pattern)
    if kinds not in ({GLOBAL_ATTN}, {SSD}):
        raise NotImplementedError(f"{cfg.name}: layer kinds {sorted(kinds)} "
                                  f"(only all-global-attention or all-SSD "
                                  f"stacks run) are {_NOT_PORTED}")


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
# Per-layer block = attention + MLP, or SSD alone; pre-norm residual
# ---------------------------------------------------------------------------

def _kind(cfg: ModelConfig) -> str:
    """The one layer kind of a supported stack."""
    return cfg.layer_pattern[0]


def block_init(gen, cfg: ModelConfig, *, dtype, device,
               lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    if _kind(cfg) == SSD:   # mamba2 blocks have no separate MLP
        return {"norm1": L.scale_init(cfg.d_model, device=device, lead=lead),
                "ssd": S.ssd_init(gen, cfg.d_model, cfg.ssm, dtype=dtype,
                                  device=device, lead=lead)}
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
    if _kind(cfg) == SSD:
        mix, new_cache = S.ssd_layer(p["ssd"], h, scfg=cfg.ssm, mode=mode,
                                     cache=cache,
                                     use_kernel=flags.use_ssd_kernel)
        return x + mix, new_cache
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
    ``attn.{wq,wk,wv,wo}``, ``norm2``, ``mlp.{wi,wo[,wg]}`` for attention,
    ``norm1``, ``ssd.{in_proj,conv_w,conv_b,A_log,D,dt_bias,norm,
    out_proj}`` for SSD."""
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
    """Zeroed cache: the KV cache at capacity ``{"k", "v"}: [L, B, T, KH,
    D]``, or the SSD cache ``{"conv": [L, B, W-1, C], "state": [L, B, H,
    P, N]}`` (float32 state), which does not depend on ``cache_len``."""
    _check_supported(cfg)
    if _kind(cfg) == SSD:
        return S.init_ssd_cache(batch, cfg.d_model, cfg.ssm,
                                dtype=flags.param_dtype, device=device,
                                lead=(cfg.n_layers,))
    return A.init_attn_cache(batch, cache_len, cfg.n_kv_heads,
                             cfg.resolved_head_dim, dtype=flags.param_dtype,
                             device=device, lead=(cfg.n_layers,))


def lm_apply(params, batch: Dict[str, torch.Tensor], *,
             cfg: ModelConfig, mode: str, flags: Flags = DEFAULT_FLAGS,
             cache: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (final hidden [B,S,D], cache). The unembedding is applied by
    the caller. A prefill or decode with ``cache`` writes the new entries
    into it in place (KV slots, or each layer's conv and state) and returns
    it; a prefill without one returns a new cache (KV of length S).
    ``params`` is a ``ParamTree`` or its ``tree()``."""
    p = _tree(params)
    lengths = batch.get("lengths")
    x = p["embed"][batch["tokens"].long()]
    new_layers = []
    for i in range(cfg.n_layers):
        c_in = None if cache is None else {k: v[i] for k, v in cache.items()}
        x, c_out = block_apply(_at(p["layers"], i), x, cfg=cfg, mode=mode,
                               flags=flags, cache=c_in, lengths=lengths)
        if mode == "train":
            continue
        if cache is None:
            new_layers.append(c_out)
        else:
            for k, v in c_out.items():
                if v.data_ptr() != c_in[k].data_ptr():
                    c_in[k].copy_(v)
    x = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    if mode == "train":
        return x, None
    if cache is None:
        cache = {k: torch.stack([c[k] for c in new_layers])
                 for k in new_layers[0]}
    return x, cache


def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits for a (small) x. [B,S,D] -> [B,S,V]."""
    p = _tree(params)
    if cfg.tie_embeddings:
        return x @ p["embed"].T
    return x @ p["unembed"]
