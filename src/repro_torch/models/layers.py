"""Core neural-net building blocks as plain functions on tensors
(``repro/models/layers.py`` at the same path).

Initializers draw from an explicit ``torch.Generator`` on the device the
parameter lives on; ``lead`` prepends stacking axes (the ``layers`` axis of
``transformer.lm_init``). The JAX package's logical sharding axes have no
counterpart here: the port runs without a mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 and cast to ``dtype``. A stacked
    shape (three axes or more) is drawn one leading slice at a time, so the
    float32 temporary is one layer big."""
    out = torch.empty(shape, dtype=dtype, device=device)
    slices = [out] if out.dim() < 3 else list(out)
    for sl in slices:
        sl.copy_(torch.randn(sl.shape, generator=gen, dtype=torch.float32,
                             device=device).mul_(scale))
    return out


def dense_init(gen, in_dim: int, out_dim: int, *, dtype, device,
               scale: Optional[float] = None, lead: Tuple[int, ...] = ()
               ) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal(gen, lead + (in_dim, out_dim), scale, dtype, device)


def embed_init(gen, vocab: int, dim: int, *, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, dim), 0.02, dtype, device)


def scale_init(dim: int, *, device, lead: Tuple[int, ...] = (),
               value: float = 1.0) -> torch.Tensor:
    return torch.full(lead + (dim,), value, dtype=torch.float32,
                      device=device)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half convention)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    # theta filled on the device: no host-to-device copy, which a CUDA
    # graph capture of a decode step would refuse
    return 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                      device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to
    [..., seq]. The two halves of the head dim rotate as pairs."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)        # [hd/2]
    angles = positions[..., None].float() * freqs                 # [..., s, hd/2]
    sin = torch.sin(angles)[..., None, :]                          # heads axis
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen, d_model: int, d_ff: int, gated: bool, *, dtype, device,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    p = {"wi": dense_init(gen, d_model, d_ff, dtype=dtype, device=device,
                          lead=lead),
         "wo": dense_init(gen, d_ff, d_model, dtype=dtype, device=device,
                          lead=lead)}
    if gated:
        p["wg"] = dense_init(gen, d_model, d_ff, dtype=dtype, device=device,
                             lead=lead)
    return p


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              gated: bool) -> torch.Tensor:
    """``silu(x·wg) * (x·wi)`` then ``·wo``: ``wi`` is the multiplied
    branch, ``wg`` the gated one. Without gating, tanh-approximated GELU
    (``jax.nn.gelu``'s default)."""
    h = x @ p["wi"]
    if gated:
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"]
