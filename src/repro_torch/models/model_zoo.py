"""Model facade (``repro/models/model_zoo.py`` at the same path): the
decoder-only architectures (dense attention stacks, global or local and
global, with or without the vision embeddings, with MLP or MoE layers, the
Mamba-2 SSD stack, and RG-LRU with local attention) and the
encoder-decoder (``models.encdec``), dispatched on ``cfg.enc_dec``.

``Model`` exposes:
  init(gen, device[, mesh])       -> ParamTree (the weights, an nn.Module);
                                     with a mesh, drawn onto it (a nested
                                     dict of spmd.Sharded)
  axes()                          -> the weights' logical sharding axes,
                                     leaf for leaf
  apply(params, batch, mode, cache) -> (hidden, cache) in prefill and
                                     decode; (hidden, None, aux_loss) in
                                     train
  init_abstract()                 -> ``init``'s tree on the meta device
  input_specs(shape)              -> a step's inputs at a dry-run shape
                                     (``configs.ShapeConfig``), as meta
                                     tensors
  init_cache(batch, cache_len, device) -> the cache tree: {"k", "v"} at
                                     capacity (a local layer's ring at
                                     min(window, cache_len)), the SSD or
                                     RG-LRU cache {"conv", "state"}, whose
                                     size does not depend on cache_len, or
                                     the encoder-decoder's {"decoder":
                                     {"self", "cross"}}
  unembed(params, x)              -> logits
  loss(params, x, labels)         -> mean token cross-entropy (float32)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.sharding import seq_gather
from repro_torch.models.transformer import DEFAULT_FLAGS, SMOKE_FLAGS, Flags


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    flags: Flags = DEFAULT_FLAGS

    def __post_init__(self):
        T._check_supported(self.cfg)

    def init(self, gen: torch.Generator, device="cuda", mesh=None):
        if mesh is not None:
            params = ED.encdec_params if self.cfg.enc_dec else T.lm_params
            return T.init_placed(
                lambda g, d: params(g, self.cfg, self.flags, d),
                self.axes(), gen, mesh, device)
        if self.cfg.enc_dec:
            return ED.encdec_init(gen, self.cfg, self.flags, device)
        return T.lm_init(gen, self.cfg, self.flags, device)

    def init_abstract(self) -> T.ParamTree:
        """``init``'s tree on the meta device: every leaf's shape and
        dtype, no storage (the dry-run's)."""
        return self.init(None, "meta")

    def axes(self) -> Dict:
        """The logical axes of ``init``'s tree (``launch.mesh.
        param_specs`` resolves them over a mesh)."""
        if self.cfg.enc_dec:
            return ED.encdec_axes(self.cfg)
        return T.lm_axes(self.cfg)

    def apply(self, params: T.ParamTree, batch: Dict[str, torch.Tensor], *,
              mode: str, cache: Optional[Dict[str, torch.Tensor]] = None):
        if self.cfg.enc_dec:
            return ED.encdec_apply(params, batch, cfg=self.cfg, mode=mode,
                                   flags=self.flags, cache=cache)
        return T.lm_apply(params, batch, cfg=self.cfg, mode=mode,
                          flags=self.flags, cache=cache)

    def init_cache(self, batch: int, cache_len: int, device="cuda"):
        if self.cfg.enc_dec:
            return ED.encdec_init_cache(self.cfg, batch, cache_len,
                                        self.flags, device)
        return T.lm_init_cache(self.cfg, batch, cache_len, self.flags,
                               device)

    def unembed(self, params: T.ParamTree, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.enc_dec:
            return x @ T._tree(params)["unembed"]
        return T.unembed(params, x, self.cfg)

    def loss(self, params, x: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """Cross-entropy of the final hidden states x [B,S,D] against
        ``labels`` [B,S]: a decoder-only LM's through ``chunked_ce_loss``
        (its tied or untied unembedding), the encoder-decoder's through
        its untied ``unembed`` and ``softmax_cross_entropy`` over the
        whole [B,S,V], as the JAX package computes them. Where a
        ``shard_map`` body splits the sequence, ``x`` is the shard's slice
        (``Model.apply``'s), gathered first: the loss is the whole
        batch's."""
        if self.cfg.enc_dec:
            logits = (seq_gather(x) @ T._tree(params)["unembed"]).float()
            return L.softmax_cross_entropy(logits, labels)
        return T.chunked_ce_loss(params, x, labels, self.cfg, self.flags)

    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """The inputs of one step at ``shape``, as meta tensors (nothing
        allocated): int32 ``tokens`` and ``labels`` (train), ``tokens``
        (prefill) or ``tokens`` [B,1] and ``lengths`` [B] (decode), with
        bf16 ``vision_embeds`` or ``frames`` outside decode where the
        frontend takes them."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")
        if shape.kind == "train":
            specs = {"tokens": spec((b, s)), "labels": spec((b, s))}
        elif shape.kind == "prefill":
            specs = {"tokens": spec((b, s))}
        else:   # decode: one new token against a cache of length s
            specs = {"tokens": spec((b, 1)), "lengths": spec((b,))}
        if cfg.frontend == "vision" and shape.kind != "decode":
            specs["vision_embeds"] = spec(
                (b, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
        if cfg.enc_dec and shape.kind != "decode":
            specs["frames"] = spec((b, cfg.encoder_seq, cfg.d_model),
                                   torch.bfloat16)
        return specs


def build_model(cfg: ModelConfig, flags: Flags = DEFAULT_FLAGS) -> Model:
    return Model(cfg, flags)


def build_smoke(cfg: ModelConfig, **overrides) -> Model:
    return Model(cfg, dataclasses.replace(SMOKE_FLAGS, **overrides))
