"""Core neural-net building blocks as plain functions on tensors
(``repro/models/layers.py`` at the same path).

Initializers draw from an explicit ``torch.Generator`` on the device the
parameter lives on; ``lead`` prepends stacking axes (the ``layers`` axis of
``transformer.lm_init``). The logical sharding axes that the JAX package's
initializers box with each leaf come from the ``*_axes`` function beside
each ``*_init`` here (``Model.axes()`` assembles the tree, in the
parameters' layout); ``launch.mesh.param_specs`` resolves them over a mesh.
Inside a ``shard_map`` body a layer holds its shard's block of each weight
(``sharding.is_split`` says along which logical axes): ``mlp_apply`` is
then column- then row-parallel, followed by a ``psum``, and
``softmax_cross_entropy`` vocab-parallel. Where the body splits the
sequence (``sharding.split_sequence``), a layer receives and returns its
shard's slice of it: ``mlp_apply`` gathers the sequence first, and the
``psum`` after the row-parallel product becomes a reduce-scatter along
the sequence (``tp_reduce``). The collectives are
differentiable (their exact adjoints, ``distributed.spmd``), so the same
code trains on a mesh.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.models.sharding import (constrain, is_split, seq_axis,
                                         seq_gather, seq_slice)

Axes = Tuple[Optional[str], ...]

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


_DRAW = threading.local()


@contextlib.contextmanager
def drawing_into(sink):
    """While open, ``normal`` hands its draws to ``sink(gen, shape, scale,
    dtype, device)`` in this thread and returns what it returns
    (``transformer.init_placed`` draws a model straight onto a
    mesh)."""
    prev = getattr(_DRAW, "sink", None)
    _DRAW.sink = sink
    try:
        yield
    finally:
        _DRAW.sink = prev


def normal_slices(gen: torch.Generator, shape: Tuple[int, ...],
                  scale: float, device
                  ) -> Iterator[Tuple[Optional[int], torch.Tensor]]:
    """``normal``'s float32 values in its draw order: (None, all of it)
    for fewer than three axes, else (i, leading slice i) for each i."""
    if len(shape) < 3:
        yield None, torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=device).mul_(scale)
        return
    for i in range(shape[0]):
        yield i, torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                             device=device).mul_(scale)


def normal(gen: torch.Generator, shape: Tuple[int, ...], scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 and cast to ``dtype``. A stacked
    shape (three axes or more) is drawn one leading slice at a time, so the
    float32 temporary is one layer big. On the meta device nothing is
    drawn."""
    sink = getattr(_DRAW, "sink", None)
    if sink is not None:
        return sink(gen, tuple(shape), scale, dtype, device)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    for i, v in normal_slices(gen, tuple(shape), scale, device):
        (out if i is None else out[i]).copy_(v)
    return out


def dense_init(gen, in_dim: int, out_dim: int, *, dtype, device,
               scale: Optional[float] = None, lead: Tuple[int, ...] = ()
               ) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal(gen, lead + (in_dim, out_dim), scale, dtype, device)


def embed_init(gen, vocab: int, dim: int, *, dtype, device) -> torch.Tensor:
    return normal(gen, (vocab, dim), 0.02, dtype, device)


EMBED_AXES: Axes = ("vocab", "embed")
SCALE_AXES: Axes = ("embed",)


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


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


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


def mlp_axes(gated: bool, lead: Axes = ()) -> Dict[str, Axes]:
    """``mlp_init``'s logical axes (``lead`` prepends the stacking
    axes')."""
    p = {"wi": lead + ("embed", "mlp"), "wo": lead + ("mlp", "embed")}
    if gated:
        p["wg"] = lead + ("embed", "mlp")
    return p


def mlp_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              gated: bool) -> torch.Tensor:
    """``silu(x·wg) * (x·wi)`` then ``·wo``: ``wi`` is the multiplied
    branch, ``wg`` the gated one. Without gating, tanh-approximated GELU
    (``jax.nn.gelu``'s default). Inside a ``shard_map`` body whose weights
    split ``mlp`` (``wi`` column-parallel), the product with ``wo``'s
    matching rows is a partial sum (``mlp_partial``), which ``tp_sum``
    adds over the model axis. Where the body splits the sequence, ``x`` is
    the shard's slice: the whole sequence is gathered first, and
    ``tp_sum`` returns the shard's slice of the sum."""
    return tp_sum(mlp_partial(p, seq_gather(x), gated), "mlp")


def mlp_partial(p: Dict[str, torch.Tensor], x: torch.Tensor,
                gated: bool) -> torch.Tensor:
    """``mlp_apply``'s products on ``x`` as it is (the whole sequence),
    without the reduction: a partial sum where the weights split
    ``mlp``."""
    h = x @ p["wi"]
    if gated:
        h = F.silu(x @ p["wg"]) * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = constrain(h, "act_batch", "act_seq", "act_mlp")
    return h @ p["wo"]


TP_AXIS = "model"


def embed_lookup(emb: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows ``emb[ids]``; inside a ``shard_map`` body whose weights
    split ``vocab``, vocab-parallel: each shard looks up the ids it holds,
    zeros for the rest, and a ``psum`` adds them up. Where the body splits
    the sequence, ``ids`` are the whole sequence's and the result the
    shard's slice: the vocab-parallel sum is reduce-scattered, a whole
    table looks up the slice's ids."""
    ids = ids.long()
    if not is_split("vocab"):
        return emb[seq_slice(ids)]
    rows = emb.shape[0]
    ids = ids - spmd.axis_index(TP_AXIS) * rows
    mine = (ids >= 0) & (ids < rows)
    x = torch.where(mine[..., None], emb[ids.clamp(0, rows - 1)], 0)
    if seq_axis() is not None:
        return spmd.psum_scatter(x, TP_AXIS, 1)
    return spmd.psum(x, TP_AXIS)


def tp_sum(y: torch.Tensor, axis: str) -> torch.Tensor:
    """``y`` summed over the model axis where it is a partial sum: a
    product over logical ``axis`` that the body's weights split
    (``sharding.is_split``); ``tp_reduce``."""
    return tp_reduce(y, is_split(axis))


def tp_reduce(y: torch.Tensor, partial: bool) -> torch.Tensor:
    """``y`` [B, S, ...], a partial sum over the model axis where
    ``partial``, summed in float32 and rounded once to ``y``'s dtype
    (every shard gets the same bits: ``spmd.psum`` folds in coordinate
    order); ``y`` itself where it is whole. Where the body splits the
    sequence, ``y`` is the whole sequence's and the result the shard's
    slice of it: the sum reduce-scattered along the sequence
    (``spmd.psum_scatter``, which gives each slice ``psum``'s bits), a
    whole ``y`` sliced."""
    if seq_axis() is not None:
        if not partial:
            return seq_slice(y)
        return spmd.psum_scatter(y.float(), TP_AXIS, 1).to(y.dtype)
    if not partial:
        return y
    return spmd.psum(y.float(), TP_AXIS).to(y.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def records(*trees) -> bool:
    """Whether autograd records an op on a tensor of ``trees`` (tensors or
    nested dicts and sequences of them): grad mode is on and one of them
    requires grad. Where it does, the train-mode paths run out of place."""
    def any_grad(tree):
        if isinstance(tree, torch.Tensor):
            return tree.requires_grad
        if isinstance(tree, dict):
            tree = tree.values()
        elif not isinstance(tree, (list, tuple)):
            return False
        return any(any_grad(v) for v in tree)
    return torch.is_grad_enabled() and any_grad(trees)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean token cross-entropy of ``logits`` [..., V] (taken in float32)
    against integer ``labels`` [...]; with ``mask`` [...], the mean over
    the masked-in tokens (at least one). Inside a ``shard_map`` body whose
    weights split ``vocab`` the logits are the shard's slice of the
    vocabulary, and the logsumexp and the label's logit are taken across
    the model axis (``_vocab_parallel_terms``)."""
    logits = logits.float()
    if is_split("vocab"):
        logz, ll = _vocab_parallel_terms(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - ll
    if mask is not None:
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def _vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logsumexp over the whole vocabulary and the label's logit, from
    this shard's slice ``logits`` [..., V/tp] (float32): the maximum
    over the shards (``pmax``, no gradient: the result does not depend on
    it), then one ``psum`` of the shifted exponentials' sum and of the
    label's logit, which only the shard holding its row contributes."""
    rows = logits.shape[-1]
    m = spmd.pmax(logits.detach().amax(dim=-1), TP_AXIS)
    ids = labels.long() - spmd.axis_index(TP_AXIS) * rows
    mine = (ids >= 0) & (ids < rows)
    ll = logits.gather(-1, ids.clamp(0, rows - 1)[..., None])[..., 0]
    both = spmd.psum(torch.stack([
        torch.exp(logits - m[..., None]).sum(dim=-1),
        torch.where(mine, ll, 0.0)]), TP_AXIS)
    return torch.log(both[0]) + m, both[1]
