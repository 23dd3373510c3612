"""Cross-pod gradient compression (``repro/train/compression.py`` at the
same path).

At pod scale the inter-pod links are the slowest hop, and the gradient
all-reduce across pods is the traffic that rides them. That hop is
compressed: int8 block-quantized payloads are all-gathered over the
``pod`` axis and averaged after dequantization, with error-feedback
residuals so the quantization error re-enters the next step's gradients
(EF-style — preserves convergence). Inter-pod gradient bytes drop ≈8× vs
a float32 ring all-reduce (int8 payload + one float32 scale per 256-block
vs 2× float32).

``compressed_pmean`` runs inside ``spmd.shard_map`` over a mesh with the
axis (``train_step.make_train_step`` with
``TrainConfig(compress_pod_grads=True)``); ``compressed_mean_stacked`` is
the same reduction over a stacked leading axis, with the same numerics.
Rounding is half to even, as ``jnp.round``'s and ``torch.round``'s.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.train.optimizer import tree_flatten, tree_unflatten

BLOCK = 256


def quantize_int8(x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Symmetric int8 quantization, blocked along the LAST axis only.
    Returns (q int8 [..., n_blocks, BLOCK], scales float32 [..., n_blocks],
    pad)."""
    if x.dim() == 0:
        x = x[None]
    last = x.shape[-1]
    pad = (-last) % BLOCK
    xp = F.pad(x, (0, pad)).to(torch.float32)
    blocks = xp.reshape(tuple(x.shape[:-1]) + (-1, BLOCK))
    scale = blocks.abs().amax(dim=-1) / 127.0
    safe = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(blocks / safe[..., None]), -127,
                    127).to(torch.int8)
    return q, scale, pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    """The values ``q * scale`` cut back to ``shape``, in ``dtype``."""
    deq = q.to(torch.float32) * scale[..., None]
    lead = tuple(q.shape[:-2])
    flat_last = deq.reshape(lead + (-1,))
    shape = tuple(shape)
    last = shape[-1] if shape else 1
    out = flat_last[..., :last]
    return out.reshape(shape).to(dtype)


def compressed_pmean(x: torch.Tensor, axis_name: str,
                     residual: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized mean-reduce over a mesh axis with error feedback (inside
    ``spmd.shard_map``). Returns (mean over the axis of x, new local
    residual). The payload exchanged is the int8 blocks and their float32
    scales (``spmd.all_gather``); each shard reconstructs the mean
    locally."""
    orig_shape = tuple(x.shape)
    if x.dim() == 0:
        x = x[None]
    n = spmd.axis_size(axis_name)
    xin = x.to(torch.float32)
    if residual is not None:
        xin = xin + residual.reshape(x.shape)
    q, scale, _ = quantize_int8(xin)
    local_deq = dequantize_int8(q, scale, x.shape, torch.float32)
    new_residual = (xin - local_deq).reshape(orig_shape)
    qg = spmd.all_gather(q, axis_name)           # [n, ..., blocks, BLOCK]
    sg = spmd.all_gather(scale, axis_name)       # [n, ..., blocks]
    total = torch.sum(qg.to(torch.float32) * sg[..., None], dim=0)
    deq_total = total.reshape(tuple(q.shape[:-2]) + (-1,))[
        ..., :x.shape[-1]]
    mean = (deq_total.reshape(orig_shape) / n).to(x.dtype)
    return mean, new_residual


def compressed_mean_stacked(x: torch.Tensor, residual: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``compressed_pmean`` over a *stacked* leading axis instead of a
    mesh axis: ``x`` and ``residual`` are [n_pods, ...] and each pod's
    slice is quantized independently (blocked along the last axis, as the
    mesh form does per shard). Returns (mean over pods, new stacked
    residuals)."""
    scalar = x.dim() == 1                 # per-pod scalars: [n] → [n, 1]
    if scalar:
        x = x[:, None]
        residual = residual[:, None]
    n = x.shape[0]
    xin = x.to(torch.float32) + residual
    q, scale, _ = quantize_int8(xin)
    local_deq = dequantize_int8(q, scale, xin.shape, torch.float32)
    new_residual = xin - local_deq
    mean = (torch.sum(local_deq, dim=0) / n).to(x.dtype)
    if scalar:
        mean = mean[0]
        new_residual = new_residual[:, 0]
    return mean, new_residual


def compressed_mean_stacked_tree(grads, residuals):
    """Tree-wide ``compressed_mean_stacked``: ``grads`` and ``residuals``
    are trees of [n_pods, ...] leaves. Returns (mean grads, new
    residuals)."""
    flat = tree_flatten(grads)
    res = [r for _, r in tree_flatten(residuals)]
    outs, news = zip(*(compressed_mean_stacked(g, r)
                       for (_, g), r in zip(flat, res, strict=True)))
    paths = [p for p, _ in flat]
    return tree_unflatten(paths, outs), tree_unflatten(paths, news)


def compressed_pmean_tree(grads, axis_name: str, residuals=None):
    """Tree-wide ``compressed_pmean``. ``residuals``: matching tree of
    float32 (or None on step 0). Returns (mean grads, new residual
    tree)."""
    flat = tree_flatten(grads)
    res = [None] * len(flat) if residuals is None else \
        [r for _, r in tree_flatten(residuals)]
    outs, news = zip(*(compressed_pmean(g, axis_name, r)
                       for (_, g), r in zip(flat, res, strict=True)))
    paths = [p for p, _ in flat]
    return tree_unflatten(paths, outs), tree_unflatten(paths, news)
