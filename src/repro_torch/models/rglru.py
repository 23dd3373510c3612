"""RG-LRU recurrent block (RecurrentGemma / Griffin) (``repro/models/rglru.py``
at the same path).

Temporal mixing block: two input branches (GeLU gate branch; conv1d + RG-LRU
branch), merged multiplicatively, projected back. The RG-LRU recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t)

is a linear recurrence in h. Train and prefill evaluate it with a log-depth
scan (``linear_scan``: Hillis–Steele doubling, where the JAX package calls
``jax.lax.associative_scan``; ``linear_scan_autograd``, the same passes out
of place, where autograd records), decode with a single-step update written
into the cache in place. The recurrence and input gates use block-diagonal
projections (``n_blocks`` heads) as in the paper. The JAX package computes
all of it outside any Pallas kernel, and so it is plain torch here.

Inside a ``shard_map`` body whose weights split ``lru`` (a model served or
trained on a mesh) a shard holds W/tp channels: ``in_x`` and ``in_gate``
column-parallel, the conv, ``lam``, the biases, the cache and the scan
channel-local, ``out`` row-parallel and reduced by ``layers.tp_sum``. The
gates' weights keep the JAX package's spec, which splits every block's
rows, so the layer gathers them over the model axis and takes its own
blocks (``_local_gate_weights``). Where the body splits the sequence
(``sharding.split_sequence``) the layer gathers it first, runs the conv
and the scan over the whole sequence on the shard's channels, and
``out``'s partial sums come back reduce-scattered to the shard's slice.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RGLRUConfig
from repro_torch.distributed import spmd
from repro_torch.models import layers as L
from repro_torch.models.sharding import is_split, seq_gather

_C = 8.0


def rglru_init(gen, d_model: int, rcfg: RGLRUConfig, n_blocks: int, *,
               dtype, device, lead: Tuple[int, ...] = ()
               ) -> Dict[str, torch.Tensor]:
    """Random weights from ``gen``; ``lead`` prepends stacking axes. The
    biases and ``lam`` stay float32 whatever ``dtype``; ``lam`` is
    deterministic, so that ``a ** c`` spans [0.9, 0.999] over channels."""
    w = rcfg.lru_width or d_model
    bd = w // n_blocks
    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, w, dtype=torch.float32)) / _C))

    def zeros(dt):
        return torch.zeros(lead + (w,), dtype=dt, device=device)

    return {
        "in_x": L.dense_init(gen, d_model, w, dtype=dtype, device=device,
                             lead=lead),
        "in_gate": L.dense_init(gen, d_model, w, dtype=dtype, device=device,
                                lead=lead),
        "conv_w": L.normal(gen, lead + (rcfg.conv_width, w),
                           1.0 / math.sqrt(rcfg.conv_width), dtype, device),
        "conv_b": zeros(dtype),
        "w_r": L.normal(gen, lead + (n_blocks, bd, bd), 1.0 / math.sqrt(bd),
                        dtype, device),
        "b_r": zeros(torch.float32),
        "w_i": L.normal(gen, lead + (n_blocks, bd, bd), 1.0 / math.sqrt(bd),
                        dtype, device),
        "b_i": zeros(torch.float32),
        "lam": lam.to(device).expand(lead + (w,)).clone(),
        "out": L.dense_init(gen, w, d_model, dtype=dtype, device=device,
                            lead=lead),
    }


def rglru_axes(lead: L.Axes = ()) -> Dict[str, L.Axes]:
    """``rglru_init``'s logical axes."""
    return {"in_x": lead + ("embed", "lru"),
            "in_gate": lead + ("embed", "lru"),
            "conv_w": lead + ("conv", "lru"), "conv_b": lead + ("lru",),
            "w_r": lead + (None, "lru", None), "b_r": lead + ("lru",),
            "w_i": lead + (None, "lru", None), "b_i": lead + ("lru",),
            "lam": lead + ("lru",), "out": lead + ("lru", "embed")}


def _block_diag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [B,S,W]; w: [H, W/H, W/H] block-diagonal projection, in x's
    dtype."""
    b, s, width = x.shape
    h, bd, _ = w.shape
    xr = x.reshape(b, s, h, bd)
    return torch.einsum("bshi,hij->bshj", xr, w).reshape(b, s, width)


def _local_gate_weights(params, width: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``w_r`` and ``w_i`` for a shard's ``width`` channels. Outside a body
    that splits ``lru`` they are the weights as they stand. Inside one a
    shard holds rows [k·bd/tp, (k+1)·bd/tp) of every block (the JAX spec
    ``(None, "lru", None)``) and its channels are whole blocks [k·H/tp,
    (k+1)·H/tp): each weight is gathered over the model axis, its rows put
    back in order and the shard's blocks taken. The gather's adjoint (a
    ``psum`` and the shard's rows) gives each shard the gradient of the
    rows it holds."""
    w_r, w_i = params["w_r"], params["w_i"]
    if not is_split("lru"):
        return w_r, w_i
    tp, k = spmd.axis_size(L.TP_AXIS), spmd.axis_index(L.TP_AXIS)
    h, _, bd = w_r.shape
    if h % tp or width != (h // tp) * bd:
        raise NotImplementedError(
            f"RG-LRU gates of {h} blocks of {bd} over {tp} shards of "
            f"{width} channels: a shard's channels are not whole blocks, "
            f"not ported (see ROADMAP.md)")
    hl = h // tp

    def mine(w):
        full = spmd.all_gather(w, L.TP_AXIS)          # [tp, H, bd/tp, bd]
        full = full.permute(1, 0, 2, 3).reshape(h, bd, bd)
        return full[k * hl:(k + 1) * hl]
    return mine(w_r), mine(w_i)


def _gates(params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_a [B,S,W] fp32, gated_input [B,S,W] fp32)."""
    w_r, w_i = _local_gate_weights(params, x.shape[-1])
    r = torch.sigmoid(_block_diag(x, w_r).float() + params["b_r"])
    i = torch.sigmoid(_block_diag(x, w_i).float() + params["b_i"])
    log_a = -_C * F.softplus(params["lam"]) * r                # <= 0
    gated = i * x.float()
    return log_a, gated


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, in log depth:
    Hillis–Steele doubling, combining (a1, b1) then (a2, b2) into
    (a1 * a2, a2 * b1 + b2) at offsets 1, 2, 4, .... It multiplies the
    a's (each in (0, 1]) and never exponentiates a sum of logs, which over
    thousands of steps leaves float32's range. Each pass writes into a
    second buffer (the two swap), so no pass reads what it writes. May
    overwrite ``a`` and ``b``; returns h."""
    s = a.shape[1]
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    off = 1
    while off < s:
        b2[:, :off] = b[:, :off]
        torch.addcmul(b[:, off:], a[:, off:], b[:, :-off], out=b2[:, off:])
        b, b2 = b2, b
        if 2 * off < s:        # the last pass needs no products of a
            a2[:, :off] = a[:, :off]
            torch.mul(a[:, off:], a[:, :-off], out=a2[:, off:])
            a, a2 = a2, a
        off *= 2
    return b


def linear_scan_autograd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``linear_scan`` for autograd, which refuses ``out=``: the same
    passes, each combining into new tensors, so the same bits. Leaves
    ``a`` and ``b`` as they are; returns h."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off],
                       torch.addcmul(b[:, off:], a[:, off:], b[:, :-off])],
                      dim=1)
        if 2 * off < s:
            a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in x's dtype. x: [B,S,W]; w: [K,W]; state:
    the last K-1 inputs [B,K-1,W] or None (zeros). The sum of the shifted
    products in the JAX package's order, then the bias. Returns (y, new
    state)."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(width)) + b
    return y, xp[:, xp.shape[1] - (width - 1):]


def rglru_layer(params: Dict[str, torch.Tensor], u: torch.Tensor, *,
                rcfg: RGLRUConfig, mode: str,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """u: [B,S,D]. mode: train | prefill | decode. cache: {"conv":
    [B,K-1,W] in the weight dtype, "state": [B,W] fp32}. A prefill starts
    from the cache's conv inputs and state where it is given one, from
    zeros otherwise; a decode needs it. With a cache, prefill and decode
    write the new conv inputs and state into it in place (tensor ops only,
    so a CUDA graph can capture a decode step) and return it; a prefill
    without one returns new tensors; train returns None. Inside a body
    that splits ``lru`` the cache and every channel are the shard's
    (module docstring)."""
    u = seq_gather(u)
    gate = F.gelu(u @ params["in_gate"], approximate="tanh")
    x = u @ params["in_x"]
    x, new_conv = _causal_conv(x, params["conv_w"], params["conv_b"],
                               None if cache is None else cache["conv"])

    log_a, gated = _gates(params, x)
    a = torch.exp(log_a)
    b_term = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                        1e-12)) * gated
    if mode in ("train", "prefill"):
        if cache is not None:
            b_term[:, 0] += a[:, 0] * cache["state"].float()
        h = (linear_scan_autograd if L.records(a, b_term)
             else linear_scan)(a, b_term)
    elif mode == "decode":
        if cache is None:
            raise ValueError("rglru_layer: decode needs a cache")
        h = a * cache["state"].float()[:, None] + b_term         # [B,1,W]
    else:
        raise ValueError(mode)
    new_cache = None
    if mode != "train":
        if cache is None:
            new_cache = {"conv": new_conv, "state": h[:, -1]}
        else:
            cache["conv"].copy_(new_conv)
            cache["state"].copy_(h[:, -1])
            new_cache = cache

    y = h.to(u.dtype) * gate
    return L.tp_sum(y @ params["out"], "lru"), new_cache


def init_rglru_cache(batch: int, d_model: int, rcfg: RGLRUConfig, *, dtype,
                     device, lead: Tuple[int, ...] = ()
                     ) -> Dict[str, torch.Tensor]:
    """Zeroed cache: conv inputs in ``dtype``, the state in float32."""
    w = rcfg.lru_width or d_model
    return {
        "conv": torch.zeros(lead + (batch, rcfg.conv_width - 1, w),
                            dtype=dtype, device=device),
        "state": torch.zeros(lead + (batch, w), dtype=torch.float32,
                             device=device),
    }
