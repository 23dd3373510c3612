"""Whisper-style encoder-decoder backbone (``repro/models/encdec.py`` at the
same path); the audio frontend is a stub, as in the JAX package.

The caller passes precomputed frame embeddings ``frames`` [B, T, D] (the
conv1d mel frontend of the paper is out of scope there and here). Encoder:
bidirectional attention with sinusoidal positions. Decoder: causal
self-attention (cached) + cross-attention to the encoder output (cross K/V
cached at prefill), learned positional embeddings, GELU MLPs. Neither
rotates q or k.

Parameters: ``embed`` [V, D], ``pos_embed`` [max_seq, D], ``enc_final_norm``,
``final_norm``, an untied ``unembed`` [D, V], and the layer-stacked
``encoder`` (``norm1``, ``attn``, ``norm2``, ``mlp``) and ``decoder``
(``norm1``, ``self_attn``, ``norm_x``, ``cross_attn``, ``norm2``, ``mlp``)
trees, every leaf with a leading layer axis. The cache is ``{"decoder":
{"self": {"k", "v"}, "cross": {"k", "v"}}}``, each [L, B, slots, KH, D]:
the self cache at capacity, the cross cache at ``encoder_seq`` rounded up
to 128. As in the port's other models, the stack runs as a Python loop
over layer views, and a prefill or decode with a cache writes it in place.

``encdec_axes`` gives the weights' logical sharding axes, and
``Model.init(..., mesh=)`` draws ``encdec_params`` straight onto a mesh.
Inside a ``shard_map`` body (served or trained on a mesh) the same
functions run on each shard's blocks: every attention (the encoder's, the
decoder's self- and cross-attention, all through ``attention_layer``) on
the shard's heads, the MLPs column- then row-parallel, the cross cache the
shard's kv heads, and the token lookup, the logits and the loss
vocab-parallel where the weights split ``vocab``. Where the body splits
the sequence (``sharding.split_sequence``) the decoder's layers take the
shard's slice of the tokens' positions, and the encoder's its slice of
the frames where they divide the axis.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.sharding import (seq_axis_for, seq_gather,
                                         seq_slice, split_sequence)
from repro_torch.models.transformer import (DEFAULT_FLAGS, Flags, ParamTree,
                                            _at, _tree, remat_call)

# the encoder's frames are padded to a multiple of this (the blockwise
# attention's block), the padding masked in cross-attention
FRAME_BLOCK = 128


def _sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """[length, channels] float32: sin then cos of position x timescale."""
    lt = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-lt * torch.arange(channels // 2, dtype=torch.float32,
                                       device=device))
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1)


def encoder_slots(cfg: ModelConfig) -> int:
    """The cross cache's slots: ``encoder_seq`` rounded up to 128."""
    return cfg.encoder_seq + (-cfg.encoder_seq) % FRAME_BLOCK


def _enc_block_init(gen, cfg: ModelConfig, *, dtype, device, lead):
    return {
        "norm1": L.scale_init(cfg.d_model, device=device, lead=lead),
        "attn": A.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim, dtype=dtype,
                            device=device, lead=lead),
        "norm2": L.scale_init(cfg.d_model, device=device, lead=lead),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                          dtype=dtype, device=device, lead=lead),
    }


def _dec_block_init(gen, cfg: ModelConfig, *, dtype, device, lead):
    def attn():
        return A.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.resolved_head_dim, dtype=dtype, device=device,
                           lead=lead)
    return {
        "norm1": L.scale_init(cfg.d_model, device=device, lead=lead),
        "self_attn": attn(),
        "norm_x": L.scale_init(cfg.d_model, device=device, lead=lead),
        "cross_attn": attn(),
        "norm2": L.scale_init(cfg.d_model, device=device, lead=lead),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                          dtype=dtype, device=device, lead=lead),
    }


def encdec_init(gen: torch.Generator, cfg: ModelConfig,
                flags: Flags = DEFAULT_FLAGS, device="cuda") -> ParamTree:
    """``encdec_params`` held in a ``ParamTree``."""
    return ParamTree(encdec_params(gen, cfg, flags, device))


def encdec_params(gen: torch.Generator, cfg: ModelConfig,
                  flags: Flags = DEFAULT_FLAGS, device="cuda"
                  ) -> Dict[str, Any]:
    """Random weights from ``gen`` (a generator on ``device``); the tree in
    the module docstring, as a nested dict. Norm scales are float32, the
    rest ``flags.param_dtype``."""
    dtype = flags.param_dtype
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dtype=dtype,
                              device=device),
        "pos_embed": L.normal(gen, (cfg.max_seq, cfg.d_model), 0.01, dtype,
                              device),
        "enc_final_norm": L.scale_init(cfg.d_model, device=device),
        "final_norm": L.scale_init(cfg.d_model, device=device),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab, dtype=dtype,
                                device=device),
        "encoder": _enc_block_init(gen, cfg, dtype=dtype, device=device,
                                   lead=(cfg.n_encoder_layers,)),
        "decoder": _dec_block_init(gen, cfg, dtype=dtype, device=device,
                                   lead=(cfg.n_layers,)),
    }
    return params


def encdec_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """``encdec_init``'s logical axes (the stacks lead with ``layers``)."""
    lead = ("layers",)
    mlp = L.mlp_axes(cfg.gated_mlp, lead)
    return {"embed": L.EMBED_AXES, "pos_embed": (None, "embed"),
            "enc_final_norm": L.SCALE_AXES, "final_norm": L.SCALE_AXES,
            "unembed": ("embed", "vocab"),
            "encoder": {"norm1": lead + L.SCALE_AXES,
                        "attn": A.attn_axes(lead),
                        "norm2": lead + L.SCALE_AXES, "mlp": mlp},
            "decoder": {"norm1": lead + L.SCALE_AXES,
                        "self_attn": A.attn_axes(lead),
                        "norm_x": lead + L.SCALE_AXES,
                        "cross_attn": A.attn_axes(lead),
                        "norm2": lead + L.SCALE_AXES, "mlp": dict(mlp)}}


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           flags: Flags = DEFAULT_FLAGS, remat: str = "none") -> torch.Tensor:
    """frames: [B, T, D] (precomputed frame embeddings, cast to the weight
    dtype) -> encoder output [B, T, D]. Bidirectional, unmasked (the JAX
    package's encoder attends to the padding frames too). Each layer runs
    under ``remat`` (``transformer.remat_call``). Where the body splits
    the sequence and T divides its axis (``sharding.seq_axis_for``), the
    layers run on the shard's slice of the frames, and the output is
    gathered whole for the cross-attention's keys and values."""
    p = _tree(params)
    dtype = p["embed"].dtype
    x = frames.to(dtype) + _sinusoids(frames.shape[1], cfg.d_model,
                                      frames.device).to(dtype)
    axis = seq_axis_for(x.shape[1])

    def layer(lp, x):
        with split_sequence(axis):
            h = L.rms_norm(x, lp["norm1"], cfg.norm_eps)
            mix, _ = A.attention_layer(
                lp["attn"], h, kind="global_attn", rope_theta=0.0,
                n_kv_heads=cfg.n_kv_heads, mode="train", causal=False,
                use_rope=False, flash_block=flags.flash_block)
            x = x + mix
            h = L.rms_norm(x, lp["norm2"], cfg.norm_eps)
            return x + L.mlp_apply(lp["mlp"], h, cfg.gated_mlp)

    enc = p["encoder"]
    with split_sequence(axis):
        x = seq_slice(x)
        for i in range(cfg.n_encoder_layers):
            x = remat_call(remat, layer, _at(enc, i), x)
        return seq_gather(L.rms_norm(x, p["enc_final_norm"], cfg.norm_eps))


def _cross_kv(p, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's k and v [B, T, KH, D] of the encoder output."""
    return (A._project(enc_out, p["cross_attn"]["wk"]),
            A._project(enc_out, p["cross_attn"]["wv"]))


def _dec_block(p, x: torch.Tensor, *, cfg: ModelConfig, mode: str,
               flags: Flags, cache: Optional[Dict],
               lengths: Optional[torch.Tensor],
               enc_out: Optional[torch.Tensor],
               enc_valid: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One decoder layer. ``cache`` (prefill and decode) is the layer's
    ``{"self", "cross"}`` views: prefill writes the self cache's slots
    ``[0, S)`` and the whole cross cache in place; decode writes the self
    cache's slot ``lengths[b]`` and reads the cross cache under
    ``enc_valid``.
    Without a cache a prefill returns new ones (self of length S, cross
    of length T)."""
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    # the JAX package's decoder passes no use_pallas: the blockwise path in
    # prefill; decode's self-attention takes the decode kernel, which
    # replaces no Pallas kernel, as every self-attention cache does
    mix, new_self = A.attention_layer(
        p["self_attn"], h, kind="global_attn", rope_theta=0.0,
        n_kv_heads=cfg.n_kv_heads, mode=mode, lengths=lengths,
        cache=None if cache is None else cache["self"], use_rope=False,
        use_kernel=flags.use_flash_kernel and mode == "decode",
        flash_block=flags.flash_block)
    x = x + mix
    h = L.rms_norm(x, p["norm_x"], cfg.norm_eps)
    if mode == "decode":
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        mix, _ = A.attention_layer(
            p["cross_attn"], h, kind="global_attn", rope_theta=0.0,
            n_kv_heads=cfg.n_kv_heads, mode="decode", lengths=lengths,
            use_rope=False, kv_override=(ck, cv), kv_valid=enc_valid)
        new_cross = cache["cross"]
    else:
        ck, cv = _cross_kv(p, enc_out)
        mix, _ = A.attention_layer(
            p["cross_attn"], h, kind="global_attn", rope_theta=0.0,
            n_kv_heads=cfg.n_kv_heads, mode=mode, causal=False,
            use_rope=False, kv_override=(ck, cv), kv_valid=enc_valid,
            flash_block=flags.flash_block)
        new_cross = {"k": ck, "v": cv}
        if cache is not None:
            t, slots = ck.shape[1], A.cache_slots(cache["cross"]["k"])
            if t != slots:
                raise ValueError(
                    f"frames pad to {t} positions; the cross cache has "
                    f"{slots} slots (encoder_seq {cfg.encoder_seq} rounded "
                    f"up to {FRAME_BLOCK}), which decode reads in full")
            A.write_prefix(cache["cross"]["k"], ck)
            A.write_prefix(cache["cross"]["v"], cv)
            new_cross = cache["cross"]
    x = x + mix
    h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    x = x + L.mlp_apply(p["mlp"], h, cfg.gated_mlp)
    if mode == "train":
        return x, None
    return x, {"self": new_self, "cross": new_cross}


def encdec_apply(params, batch: Dict[str, torch.Tensor], *,
                 cfg: ModelConfig, mode: str, flags: Flags = DEFAULT_FLAGS,
                 cache: Optional[Dict[str, Any]] = None):
    """Returns (decoder hidden [B,S,D], cache) in prefill and decode, and
    (decoder hidden, None, aux_loss = 0) in train, as the JAX function
    returns in every mode. ``batch`` holds ``tokens``
    [B,S], ``frames`` [B,T,D] in train and prefill, ``lengths`` [B] in
    decode, which reads the cached cross K/V. The frames are padded to a
    multiple of 128 and the padding masked in cross-attention. A prefill
    or decode with ``cache`` writes into it in place and returns it; a
    prefill without one returns a new cache (self of length S, cross of
    the padded T). In train mode with ``flags.remat`` other than "none"
    every encoder and decoder layer is recomputed in the backward, as the
    JAX package's ``jax.checkpoint`` of both scans' bodies."""
    p = _tree(params)
    tokens = batch["tokens"]
    lengths = batch.get("lengths")
    b, s = tokens.shape
    train = mode == "train"
    remat = "full" if train and flags.remat != "none" else "none"
    enc_out = enc_valid = None
    if mode in ("train", "prefill"):
        frames = batch["frames"]
        t = frames.shape[1]
        tpad = (-t) % FRAME_BLOCK
        enc_valid = torch.arange(t + tpad, device=frames.device) < t
        enc_out = encode(p, F.pad(frames, (0, 0, 0, tpad)), cfg, flags,
                         remat)
    if mode == "decode":
        # the cross cache's slots past encoder_seq are masked, whatever
        # length the prefill's frames had; from constants only, so that a
        # CUDA graph can capture the step
        slots = A.cache_slots(cache["decoder"]["cross"]["k"])
        enc_valid = torch.arange(slots, device=tokens.device) \
            < cfg.encoder_seq
        pe = p["pos_embed"][lengths.long()][:, None]                # [B,1,D]
    else:
        pe = p["pos_embed"][None, :s]
    x = L.embed_lookup(p["embed"], tokens)
    x = x + seq_slice(pe).to(x.dtype)
    dec = p["decoder"]
    outs = []
    for i in range(cfg.n_layers):
        if train:
            x, _ = remat_call(
                remat, lambda lp, x_: _dec_block(
                    lp, x_, cfg=cfg, mode=mode, flags=flags, cache=None,
                    lengths=None, enc_out=enc_out, enc_valid=enc_valid),
                _at(dec, i), x)
            continue
        c_in = None
        if cache is not None:
            c_in = {kind: {k: v[i] for k, v in c.items()}
                    for kind, c in cache["decoder"].items()}
        x, c_out = _dec_block(_at(dec, i), x, cfg=cfg, mode=mode,
                              flags=flags, cache=c_in, lengths=lengths,
                              enc_out=enc_out, enc_valid=enc_valid)
        outs.append(c_out)
    x = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    if train:
        return x, None, torch.zeros((), dtype=torch.float32,
                                    device=x.device)
    if cache is not None:
        return x, cache
    return x, {"decoder": {kind: {k: torch.stack([c[kind][k] for c in outs])
                                  for k in ("k", "v")}
                           for kind in ("self", "cross")}}


def encdec_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      flags: Flags = DEFAULT_FLAGS, device="cuda"
                      ) -> Dict[str, Any]:
    """Zeroed cache: the self cache at capacity ``cache_len``, the cross
    cache at ``encoder_slots(cfg)`` slots, both stacked over the decoder's
    layers."""
    def attn_cache(slots):
        return A.init_attn_cache(batch, slots, cfg.n_kv_heads,
                                 cfg.resolved_head_dim,
                                 dtype=flags.param_dtype, device=device,
                                 lead=(cfg.n_layers,))
    return {"decoder": {"self": attn_cache(cache_len),
                        "cross": attn_cache(encoder_slots(cfg))}}
