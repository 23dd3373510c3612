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
``TrainConfig(compress_pod_grads=True)``), on a whole leaf or, in the
tensor-parallel step, on a shard's slice of one: the quantization blocks
are the whole leaf's either way, so that mean and residual are the whole
leaf's, sliced. ``compressed_mean_stacked`` is the same reduction over a
stacked leading axis, with the same numerics.
Rounding is half to even, as ``jnp.round``'s and ``torch.round``'s.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.train.optimizer import (tree_flatten, tree_leaves,
                                         tree_unflatten)

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


def _quantize_part(x: torch.Tensor, split: Tuple[str, ...]
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``quantize_int8`` of the whole leaf, of which this shard holds
    ``x`` (float32), a slice of the last axis where ``split`` (the mesh
    axes that split it, major first) names axes: the blocks are the whole
    axis's, each block's scale the ``pmax`` over those axes of its parts'
    maxima. Returns (q [..., k, BLOCK] and scales [..., k] of the k blocks
    this slice meets, padded with zeros to their bounds; the slice's
    offset in the first block)."""
    width = x.shape[-1]
    index, parts = spmd.axes_index(split)
    lo = index * width
    lead = lo % BLOCK
    blocks = F.pad(x, (lead, (-(lead + width)) % BLOCK)).reshape(
        tuple(x.shape[:-1]) + (-1, BLOCK))
    scale = blocks.abs().amax(dim=-1)
    if split:
        first, k = lo // BLOCK, blocks.shape[-2]
        whole = torch.zeros(tuple(x.shape[:-1])
                            + (-(-width * parts // BLOCK),),
                            dtype=torch.float32, device=x.device)
        whole[..., first:first + k] = scale
        for a in split:
            whole = spmd.pmax(whole, a)
        scale = whole[..., first:first + k]
    scale = scale / 127.0
    # in place on the padded copy: q as quantize_int8 makes it
    q = blocks.div_(scale.clamp_min(1e-12)[..., None]).round_().clamp_(
        -127, 127).to(torch.int8)
    return q, scale, lead


def compressed_pmean(x: torch.Tensor, axis_name: str,
                     residual: Optional[torch.Tensor] = None,
                     split: Tuple[str, ...] = ()
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized mean-reduce over a mesh axis with error feedback (inside
    ``spmd.shard_map``). Returns (mean over the axis of x, new local
    residual). The payload exchanged is the int8 blocks and their float32
    scales (``spmd.all_gather``); each shard reconstructs the mean
    locally. Where ``x`` is this shard's slice of a leaf split along its
    last axis over the mesh axes ``split``, the blocks are the whole
    leaf's (``_quantize_part``): mean and residual are this shard's
    slices of the whole leaf's. Only the new residual and the int8
    blocks are alive while the shard waits at the exchange."""
    orig_shape = tuple(x.shape)
    if x.dim() == 0:
        x = x[None]
    n = spmd.axis_size(axis_name)
    width = x.shape[-1]
    lead_shape = tuple(x.shape[:-1])
    xin = x.to(torch.float32, copy=True) if residual is None else \
        x.to(torch.float32) + residual.reshape(x.shape)
    q, scale, lead = _quantize_part(xin, split)
    # the new residual, xin less its dequantized blocks, in place
    xin.sub_(q.to(torch.float32).mul_(scale[..., None]).reshape(
        lead_shape + (-1,))[..., lead:lead + width])
    qg = spmd.all_gather(q, axis_name)           # [n, ..., blocks, BLOCK]
    sg = spmd.all_gather(scale, axis_name)       # [n, ..., blocks]
    del q
    total = None
    for i in range(n):                           # in coordinate order
        part = qg[i].to(torch.float32).mul_(sg[i][..., None])
        total = part if total is None else total.add_(part)
    del qg, part
    mean = total.reshape(lead_shape + (-1,))[..., lead:lead + width]
    mean = mean.div_(n).reshape(orig_shape).to(x.dtype)
    return mean, xin.reshape(orig_shape)


def payload_bytes(params) -> Tuple[int, int]:
    """Shard 0's bytes a step of ``compressed_pmean``'s all-gathers over
    the pod axis for placed parameters (a tree of ``spmd.Sharded``): the
    int8 blocks and the float32 scales of the 256-blocks its slice of
    each leaf's last axis meets."""
    q = 0
    for p in tree_leaves(params):
        block = tuple(p.shards[0].shape) or (1,)
        rows = 1
        for n in block[:-1]:
            rows *= n
        q += rows * -(-block[-1] // BLOCK) * BLOCK
    return q, q // BLOCK * 4


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
