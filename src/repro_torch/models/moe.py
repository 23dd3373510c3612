"""Mixture-of-Experts FFN with top-k routing (``repro/models/moe.py`` at
the same path).

Three execution paths:

- ``moe_dense``: oracle path — computes every expert on every token and
  combines with routing weights. Exact, used for smoke tests, for one
  card's CPU, float32 or training calls (``moe_ep`` falls back to it
  without a mesh, as the JAX package's does, where ``moe_routed`` does
  not take the call) and as the reference for the other paths'
  correctness tests. It does ``num_experts / top_k`` times the routed
  FLOPs.
- ``moe_routed``: one card, dropless. Each token goes to its top-k
  experts only: the assignments are grouped by expert into a padded
  buffer (``kernels.moe_experts.routed_plan``, on the device with no
  read-back), the gated experts run as two grouped products
  (``kernels.moe_experts``, hand-written CUDA on the card, the plain
  version on the CPU) and the outputs are summed back per token in k
  order. ``moe_ep``'s no-mesh fallback takes it for a bf16 x on the card
  (or on ``meta``) of gated experts whose widths the kernels tile, where
  autograd records nothing (``routes_on_card``); everything else keeps
  ``moe_dense``.
- ``moe_ep``: expert parallelism over the ``model`` axis of the active
  mesh (``models.sharding.use_sharding``) inside ``spmd.shard_map``:
  tokens are slotted into per-expert capacity buffers, exchanged with
  ``all_to_all``, processed as batched products on the expert owner, and
  combined back. FLOPs scale with top_k·capacity_factor, not num_experts.
  Called inside a ``shard_map`` body (a model served on a mesh, its
  experts already resident: ``E / tp`` a shard), it runs the same
  exchange on them directly (``shard_map`` does not nest).

Routing picks the top k probabilities with ``torch.topk``, which does not
say how it orders ties, where ``jax.lax.top_k`` takes the lower index:
the seeded float32 router probabilities of the tests do not tie, so the
two agree. Slot ranks come from a stable sort of the expert ids, as
``jnp.argsort(stable=True)``: within an expert a token's rank follows
token order. Nothing here adds into a location twice through atomics
(the combine sums over k in a fixed order), so decode steps repeat bit
for bit. Every path returns ``(out, aux)``; aux is the Switch
load-balance loss. The top-k weights are divided by their sum, as the
JAX package's are, unless the config says otherwise
(``configs.PortMoEConfig.norm_topk_prob`` False: OLMoE-1B-7B-0924's
softmax probabilities as they are).

Every path opens three spans (``core.spans``) a call: ``moe.route`` (the
router product, softmax, top-k and balance loss, on the routed path the
plan, and on the EP path the slotting and exchange of the rows to their
experts), ``moe.experts`` (the expert products, on the routed path the
gather before them, a shared expert's too) and ``moe.combine`` (the
weighted sum back to the tokens). ``COUNTS`` adds up, on the host and
from shapes alone (no read-back), the rows routed (tokens × top_k) and
the rows the expert products ran on: tokens × E in ``moe_dense``, tokens
× E_local in a body's dense oracle, the capacity slots (E_local × tp ×
capacity) on the EP path, tokens × top_k on the routed path (whose
kernels also compute each expert's padding to the row tile, up to E ×
(bm - 1) rows that depend on the routing and are not counted). A
replayed CUDA graph adds nothing to them.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import sanitizer, spans
from repro_torch.distributed import spmd
from repro_torch.kernels import moe_experts as KM
from repro_torch.models import layers as L
from repro_torch.models.sharding import (active_mesh, is_split, seq_axis,
                                         seq_gather)


# rows routed and rows the expert products ran on, since the last reset
COUNTS: Dict[str, float] = {"routed_rows": 0, "computed_rows": 0}
_counts_lock = sanitizer.make_lock("moe._counts_lock")


def _count(routed: float, computed: float) -> None:
    """Add a call's rows to ``COUNTS`` (shard bodies run on threads of
    their own)."""
    with _counts_lock:
        COUNTS["routed_rows"] += routed
        COUNTS["computed_rows"] += computed


def moe_init(gen, d_model: int, mcfg: MoEConfig, gated: bool, *, dtype,
             device, lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """``router`` [D, E] float32; ``wi``, ``wg`` [E, D, F] and ``wo``
    [E, F, D] in ``dtype``; ``shared`` (an MLP) where the config has one;
    ``lead`` prepends stacking axes."""
    e, ff = mcfg.num_experts, mcfg.d_ff_expert
    sc = 1.0 / math.sqrt(d_model)
    p = {"router": L.normal(gen, lead + (d_model, e), sc, torch.float32,
                            device),
         "wi": L.normal(gen, lead + (e, d_model, ff), sc, dtype, device),
         "wo": L.normal(gen, lead + (e, ff, d_model), 1.0 / math.sqrt(ff),
                        dtype, device)}
    if gated:
        p["wg"] = L.normal(gen, lead + (e, d_model, ff), sc, dtype, device)
    if mcfg.d_ff_shared:
        p["shared"] = L.mlp_init(gen, d_model, mcfg.d_ff_shared, gated,
                                 dtype=dtype, device=device, lead=lead)
    return p


def moe_axes(gated: bool, shared: bool,
             lead: L.Axes = ()) -> Dict[str, object]:
    """``moe_init``'s logical axes."""
    p = {"router": lead + ("embed", "experts"),
         "wi": lead + ("experts", "embed", "expert_mlp"),
         "wo": lead + ("experts", "expert_mlp", "embed")}
    if gated:
        p["wg"] = lead + ("experts", "embed", "expert_mlp")
    if shared:
        p["shared"] = L.mlp_axes(gated, lead)
    return p


def _route(router_w: torch.Tensor, x: torch.Tensor, mcfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (weights [T,k] float32, expert_idx [T,k], aux_loss
    scalar). The weights are the top k softmax probabilities, divided by
    their sum unless ``mcfg.norm_topk_prob`` is False."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)
    weights, idx = probs.topk(mcfg.top_k, dim=-1)
    if getattr(mcfg, "norm_topk_prob", True):
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, idx, balance_loss(probs, idx, mcfg)


def balance_loss(probs: torch.Tensor, idx: torch.Tensor, mcfg: MoEConfig,
                 axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """The Switch-style load-balance loss of routing probabilities
    [T, E] and choices [T, k]: E * sum_e f_e * p_e, f_e the mean number
    of a token's k slots routed to e (counted by a scatter-add, which
    needs no read-back of the largest index), p_e the mean probability.
    Inside a ``shard_map`` body, ``axes`` (data axes whose shards hold
    equal slices of the batch) average f and p over them first: the loss
    of the whole batch, as one device takes it."""
    e = mcfg.num_experts
    me = probs.mean(dim=0)                                        # [E]
    counts = torch.zeros(e, dtype=torch.float32, device=probs.device)
    counts.scatter_add_(0, idx.reshape(-1),
                        torch.ones(idx.numel(), device=probs.device))
    fe = counts / probs.shape[0]
    if axes:
        me, fe = spmd.pmean(torch.stack([me, fe]), axes)
    return e * (me * fe).sum() * mcfg.load_balance_loss_weight


def _expert_ffn(p, h: torch.Tensor, gated: bool) -> torch.Tensor:
    """h: [E, C, D] -> [E, C, D] (batched per-expert dense MLP)."""
    up = torch.bmm(h, p["wi"])
    if gated:
        up = F.silu(torch.bmm(h, p["wg"])) * up
    else:
        up = F.gelu(up, approximate="tanh")
    return torch.bmm(up, p["wo"])


def moe_dense(p, x: torch.Tensor, mcfg: MoEConfig, gated: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle: every expert on every token. x: [B,S,D]. The combine
    matrix is built in x's dtype from the routing weights cast to it.
    Inside a ``shard_map`` body each shard runs its own experts
    (``_moe_in_body``)."""
    if spmd.current_mesh() is not None:
        return _moe_in_body(p, x, mcfg, gated, dense=True)
    b, s, d = x.shape
    e = mcfg.num_experts
    xf = x.reshape(b * s, d)
    _count(b * s * mcfg.top_k, b * s * e)
    with spans.span("moe.route"):
        weights, idx, aux = _route(p["router"], xf, mcfg)
    with spans.span("moe.experts"):
        # every token as every expert's block (a view: no copy per expert)
        ys = _expert_ffn(p, xf.expand(e, b * s, d), gated)        # [E,T,D]
        sh = L.mlp_apply(p["shared"], xf, gated) if mcfg.d_ff_shared \
            else None
    with spans.span("moe.combine"):
        # top-k indices in a row are distinct: a scatter into zeros is the
        # JAX package's scatter-add, without colliding writes
        comb = torch.zeros((b * s, e), dtype=x.dtype, device=x.device)
        comb.scatter_(1, idx, weights.to(x.dtype))
        out = torch.einsum("te,etd->td", comb, ys)
        if sh is not None:
            out = out + sh
    return out.reshape(b, s, d), aux


def routes_on_card(p, x: torch.Tensor, mcfg: MoEConfig, gated: bool
                   ) -> bool:
    """Whether ``moe_routed`` takes a call that ``moe_ep`` would give the
    dense oracle: x a bf16 tensor on the card (or on ``meta``, the
    dry-run's stand-in for it), gated experts in bf16 whose widths
    and number the kernels take (D % 8 == F % 8 == 0, at most
    ``KM.MAX_EXPERTS``), and nothing that autograd records (the kernels
    have no backward)."""
    if not gated or x.device.type not in ("cuda", "meta") \
            or x.dtype != torch.bfloat16:
        return False
    ws = [p[n] for n in ("wg", "wi", "wo")]
    if any(w.dtype != torch.bfloat16 for w in ws):
        return False
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in ws + [x, p["router"]]):
        return False
    return (x.shape[-1] % 8 == 0 and mcfg.d_ff_expert % 8 == 0
            and mcfg.num_experts <= KM.MAX_EXPERTS)


def moe_routed(p, x: torch.Tensor, mcfg: MoEConfig, gated: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One card, dropless: each token through its top-k experts only.
    x: [B,S,D]. Routing as ``moe_dense``'s; the assignments are grouped
    by expert (``KM.routed_plan``), run through the gated experts as two
    grouped products (``KM.moe_experts``) and summed back per token in k
    order, the weights cast to x's dtype first (``KM.moe_combine``).
    Nothing is read back to the host, so a CUDA graph captured once
    replays right as the routing changes. Gated experts only."""
    if not gated:
        raise ValueError("moe_routed: the routed kernels are SwiGLU experts")
    b, s, d = x.shape
    t, k = b * s, mcfg.top_k
    xf = x.reshape(t, d)
    _count(t * k, t * k)
    with spans.span("moe.route"):
        weights, idx, aux = _route(p["router"], xf, mcfg)
        rows, tiles = KM.routed_plan(idx, mcfg.num_experts)
    with spans.span("moe.experts"):
        y = KM.moe_experts(xf, rows, tiles, p["wg"], p["wi"], p["wo"])
        sh = L.mlp_apply(p["shared"], xf, gated) if mcfg.d_ff_shared \
            else None
    with spans.span("moe.combine"):
        out = KM.moe_combine(y, rows, weights)
        if sh is not None:
            out = out + sh
    return out.reshape(b, s, d), aux


def capacity(t_loc: int, mcfg: MoEConfig, capacity_factor: float) -> int:
    """Slots per (shard, expert) buffer for ``t_loc`` local tokens: at
    least 4, a multiple of 4."""
    cap = int(math.ceil(t_loc * mcfg.top_k / mcfg.num_experts
                        * capacity_factor))
    return max(4, ((cap + 3) // 4) * 4)


def slot_ranks(idx: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each assignment's slot in its expert's buffer [T,k]: the number of
    assignments to the same expert before it in (token, k) order."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(num_experts, dtype=torch.long, device=idx.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = counts.cumsum(0) - counts
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(flat_e.numel(), device=idx.device) \
        - starts[flat_e[order]]
    return rank.view(idx.shape)


def _ep_local(p, xf: torch.Tensor, mcfg: MoEConfig, gated: bool, axis: str,
              capacity_factor: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Body run per (data, model) shard inside ``spmd.shard_map``.
    xf: [T_loc, D] local tokens; ``p`` holds the router and this shard's
    experts (sharded over ``axis``)."""
    tp = spmd.axis_size(axis)
    t_loc, d = xf.shape
    e = mcfg.num_experts
    e_loc = e // tp
    k = mcfg.top_k
    cap = capacity(t_loc, mcfg, capacity_factor)
    _count(t_loc * k, e_loc * tp * cap)

    with spans.span("moe.route"):
        weights, idx, aux = _route(p["router"], xf, mcfg)          # [T,k]
        rank = slot_ranks(idx, e).reshape(-1)
        keep = rank < cap
        # each kept assignment's row of the [E*cap, D] dispatch buffers;
        # the dropped ones write a spare last row, which no one reads
        rows = torch.where(keep, idx.reshape(-1) * cap + rank, e * cap)
        buf = torch.zeros((e * cap + 1, d), dtype=xf.dtype,
                          device=xf.device)
        buf[rows] = xf[:, None].expand(t_loc, k, d).reshape(t_loc * k, d)
        # exchange: [tp, E_loc, cap, D] -> owner gets [tp, E_loc, cap, D]
        buf = buf[:e * cap].view(tp, e_loc, cap, d)
        buf = spmd.all_to_all(buf, axis, 0, 0, tiled=True)
        h = buf.transpose(0, 1).reshape(e_loc, tp * cap, d)  # [E_loc,tp*cap,D]
    with spans.span("moe.experts"):
        y = _expert_ffn(p, h, gated)                       # local experts
    with spans.span("moe.combine"):
        y = y.view(e_loc, tp, cap, d).transpose(0, 1).reshape(
            tp, e_loc, cap, d)
        y = spmd.all_to_all(y, axis, 0, 0, tiled=True)
        # combine back to tokens: each assignment's row, weighted, summed
        # over k in order
        gathered = y.view(e * cap, d)[torch.where(keep, rows, 0)]  # [T*k, D]
        gathered = torch.where(keep[:, None], gathered, 0)
        w = weights.reshape(-1).to(xf.dtype)
        out = (gathered * w[:, None]).view(t_loc, k, d).sum(dim=1)
    return out, aux


def moe_ep(p, x: torch.Tensor, mcfg: MoEConfig, gated: bool, *,
           axis: str = "model", capacity_factor: float = 1.25,
           data_axes: Tuple[str, ...] = ("pod", "data"),
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE. x: [B,S,D], sharded over the data axes. Runs
    over the active mesh; without one, with ``axis`` absent or of size 1,
    or with the experts not dividing over it, one device's path:
    ``moe_routed`` where ``routes_on_card``, else the dense oracle. Tokens
    shard over ``axis`` along S where it divides (each model shard routes
    its own slice), else (decode) every model shard routes them all. The
    result lands on x's device. Inside a ``shard_map`` body
    (``_moe_in_body``) the same, on the shard's resident experts."""
    if spmd.current_mesh() is not None:
        return _moe_in_body(p, x, mcfg, gated, axis=axis,
                            capacity_factor=capacity_factor,
                            data_axes=data_axes)
    mesh = active_mesh()
    if mesh is None or axis not in mesh.shape or mesh.shape[axis] == 1 \
            or mcfg.num_experts % mesh.shape[axis] != 0:
        if routes_on_card(p, x, mcfg, gated):
            return moe_routed(p, x, mcfg, gated)
        return moe_dense(p, x, mcfg, gated)
    s = x.shape[1]
    batch_axes = tuple(a for a in data_axes if a in mesh.shape)
    tp = mesh.shape[axis]
    seq_shard = s % tp == 0 and s >= tp
    # the router, replicated, and the experts, sharded over ``axis``
    names = ["router"] + [n for n in ("wi", "wo", "wg") if n in p]

    def body(*args):
        *weights, xloc = args
        bl, sl, dl = xloc.shape
        out, aux = _ep_local(dict(zip(names, weights)),
                             xloc.reshape(bl * sl, dl), mcfg, gated, axis,
                             capacity_factor)
        # aux differs per shard; mean over all axes for a global scalar
        aux = spmd.pmean(aux, axis)
        if batch_axes:
            aux = spmd.pmean(aux, batch_axes)
        return out.view(bl, sl, dl), aux

    bax = batch_axes if len(batch_axes) != 1 else batch_axes[0]
    xs = spmd.P(bax if batch_axes else None, axis if seq_shard else None)
    especs = tuple(spmd.P() if n == "router" else spmd.P(axis)
                   for n in names)
    out, aux = spmd.shard_map(body, mesh, in_specs=especs + (xs,),
                              out_specs=(xs, spmd.P()))(
        *(p[n] for n in names), x)
    out, aux = out.full(x.device), aux.full(x.device)
    if mcfg.d_ff_shared:
        with spans.span("moe.experts"):
            out = out + L.mlp_apply(p["shared"], x, gated)
    return out, aux


def _moe_in_body(p, x: torch.Tensor, mcfg: MoEConfig, gated: bool, *,
                 axis: str = "model", capacity_factor: float = 1.25,
                 data_axes: Tuple[str, ...] = ("pod", "data"),
                 dense: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ep`` (or with ``dense``, ``moe_dense``) inside a
    ``shard_map`` body whose ``p`` holds this shard's blocks
    (``launch.mesh.param_specs``): the experts split over ``axis`` where
    they divide it, the router split with them, the shared expert column-
    then row-parallel like an MLP. x [B_loc, S, D] is replicated over
    ``axis``. The router is gathered whole. ``moe_ep`` then routes this
    shard's slice of S (or, in decode, all tokens) and exchanges them with
    its peers (``_ep_local``); the slices' outputs come back together in
    one ``psum`` over ``axis``, with the shared expert's partial sums. The
    dense oracle (``dense``, or where ``moe_ep`` falls back to it: the
    weights do not split ``experts`` (``sharding.is_split``), on an axis
    of size 1 or one the experts do not divide)
    routes every local token and runs the shard's own experts on them all,
    a partial sum over the experts; its load-balance loss takes the whole
    batch's statistics where data axes split the batch
    (``balance_loss``), as the oracle on one device does, while
    ``moe_ep``'s averages the shards' losses, as the JAX package's does.
    Returns the output, replicated over ``axis``, and the aux loss.

    Where the body splits the sequence over ``axis``
    (``sharding.split_sequence``), x and the output are the shard's slice:
    ``moe_ep`` routes the slice it holds, the same tokens as without the
    split, and its output is the slice's, with no collective for the
    routed part; the shared expert and the dense oracle take the gathered
    sequence and reduce-scatter their partial sums (``layers.tp_reduce``).
    """
    mesh = spmd.current_mesh()
    tp = mesh.shape.get(axis, 1)
    seq = seq_axis()
    e, d = mcfg.num_experts, x.shape[-1]
    e_loc = p["wi"].shape[0]
    split = is_split("experts")
    # the whole sequence, where a part takes it
    x_all = seq_gather(x) if dense or not split or "shared" in p else x
    b, s, _ = x_all.shape
    experts = {k: p[k] for k in ("wi", "wo", "wg") if k in p}
    router = p["router"]
    if split:
        # [tp, D, E/tp] -> [D, E], experts in shard order
        router = spmd.all_gather(router, axis).permute(1, 0, 2).reshape(d, e)
    experts["router"] = router
    # a mean over axes of one shard is the value itself
    batch_axes = tuple(a for a in data_axes if mesh.shape.get(a, 1) > 1)
    # the routed part [B, S, D] in float32, partial where it is split (the
    # shard's slice [B, S/tp, D] where the sequence splits and moe_ep
    # routes)
    if dense or not split:
        xf = x_all.reshape(b * s, d)
        # the model shards that split the experts route the same tokens:
        # each counts its share of their rows
        _count(b * s * mcfg.top_k / (tp if split else 1), b * s * e_loc)
        with spans.span("moe.route"):
            weights, idx, aux = _route(router, xf, mcfg)
            if batch_axes:
                # the whole batch's load-balance loss, as the oracle takes
                # it
                aux = balance_loss(torch.softmax(xf.float() @ router,
                                                 dim=-1),
                                   idx, mcfg, batch_axes)
        with spans.span("moe.experts"):
            ys = _expert_ffn(experts, xf.expand(e_loc, b * s, d), gated)
        with spans.span("moe.combine"):
            comb = torch.zeros((b * s, e), dtype=x.dtype, device=x.device)
            comb.scatter_(1, idx, weights.to(x.dtype))
            e0 = spmd.axis_index(axis) * e_loc if split else 0
            y = torch.einsum("te,etd->td", comb[:, e0:e0 + e_loc], ys)
        y, partial, whole = y.view(b, s, d).float(), split, True
    else:
        seq_shard = s % tp == 0 and s >= tp
        xs = x
        if seq_shard and seq is None:
            sl = s // tp
            s0 = spmd.axis_index(axis) * sl
            xs = x[:, s0:s0 + sl]
        out, aux = _ep_local(experts, xs.reshape(-1, d), mcfg, gated, axis,
                             capacity_factor)
        aux = spmd.pmean(aux, axis)
        if batch_axes:
            aux = spmd.pmean(aux, batch_axes)
        whole = seq is None
        if seq is not None:
            # the slice's own output: complete
            y = out.view(xs.shape).float()
        elif seq_shard:
            # each shard's slice into a zero [B, S, D]
            y = torch.zeros_like(x, dtype=torch.float32)
            y[:, s0:s0 + sl] = out.view(xs.shape)
        else:
            # every shard routed all tokens: the same output on each
            y = out.view(x.shape).float()
        partial = seq_shard and seq is None
    sh = None
    if "shared" in p:
        with spans.span("moe.experts"):
            sh = L.mlp_partial(p["shared"], x_all, gated)
        if partial and is_split("mlp"):
            # row-parallel: its partial sums join the routed part's psum
            y, sh = y + sh, None
        else:
            sh = L.tp_sum(sh, "mlp")
    if whole and seq is not None:
        y = L.tp_reduce(y, partial)
    elif partial:
        y = spmd.psum(y, axis)
    y = y.to(x.dtype)
    return (y if sh is None else y + sh), aux
