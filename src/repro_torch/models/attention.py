"""Attention: GQA projections and the execution paths
(``repro/models/attention.py`` at the same path).

- ``flash_attention``: blockwise online-softmax attention in plain torch,
  causal or bidirectional, with an optional padding mask over the keys
  (the JAX package's scan over KV blocks); never materializes the full
  [S, T] score matrix. It serves the encoder-decoder's bidirectional
  encoder and cross-attention too.
- ``flash_attention_gqa`` (``kernels/flash_attention.py``): the hand-written
  CUDA kernel that replaces the Pallas one, taken for causal global
  self-attention when ``use_kernel`` is set, as ``use_pallas`` routes
  ``_pallas_flash``.
- ``qk_norm``: OLMoE's QK-norm, an RMS norm over each position's whole
  projected q and k widths before RoPE, where the configuration has it
  (``configs.PortModelConfig``; the JAX package has none).
- ``window_attention``: exact sliding-window attention via block-banded
  computation (each query block attends to itself + previous block), for
  ``local_attn`` layers.
- ``decode_attention``: one new token against a KV cache, in plain torch
  (the CPU's route, cross-attention and anything autograd records), with a
  sequence-sharded variant (``seq_sharded_decode``: logsumexp partials
  combined over a mesh axis of ``distributed.spmd``). Inside a
  ``shard_map`` body whose cache blocks hold a slice of the slots
  (``sharding.kv_seq_axis``: ``Flags.seq_shard_kv`` with the weights
  placed) every attention layer writes and reads its shard's slots and
  combines the partials over that axis (``_seq_split_decode``). Where
  the body splits the activations' sequence (``sharding.split_sequence``)
  ``attention_layer`` gathers it before its projections and
  reduce-scatters ``wo``'s sums.
- ``KD.decode_attention`` (``kernels/decode_attention.py``): the
  hand-written CUDA kernel that reads a self-attention cache where it lies,
  only each row's valid slots, taken in decode when ``use_kernel`` is set
  for a bf16 cache on the card whose slots are not split
  (``_takes_decode_kernel``). It replaces no Pallas kernel.

The JAX package computes the blockwise, window and decode paths outside
any Pallas kernel, and so they are plain torch here, with float32 scores.
Where autograd records (training), the blockwise and window paths run
their tiles out of place, and global attention never takes the kernel,
which has no backward (``transformer.Flags``). Their products take
the operands in their own dtype with a float32 result (``bmm_f32``), as
the JAX package's ``preferred_element_type`` does. Caches for
local-attention layers are ring buffers of ``min(window, capacity)``
slots. Cross-attention passes its keys and values in (``kv_override``) and
keeps no cache of its own here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import spmd
from repro_torch.kernels import decode_attention as KD
from repro_torch.kernels.flash_attention import NEG_INF, flash_attention_gqa
from repro_torch.models import layers as L
from repro_torch.models.sharding import (active_mesh, constrain, is_split,
                                         kv_seq_axis, seq_gather)


def attn_init(gen, d_model: int, n_heads: int, n_kv_heads: int,
              head_dim: int, *, dtype, device, lead: Tuple[int, ...] = (),
              qk_norm: bool = False) -> Dict[str, torch.Tensor]:
    """``wq``, ``wk``, ``wv``, ``wo`` in ``dtype``; with ``qk_norm`` also
    the QK-norm scales ``q_norm`` [H·d] and ``k_norm`` [KH·d] (float32,
    like every norm's, drawn from nothing)."""
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(n_heads * head_dim)
    p = {
        "wq": L.normal(gen, lead + (d_model, n_heads, head_dim), s_in,
                       dtype, device),
        "wk": L.normal(gen, lead + (d_model, n_kv_heads, head_dim), s_in,
                       dtype, device),
        "wv": L.normal(gen, lead + (d_model, n_kv_heads, head_dim), s_in,
                       dtype, device),
        "wo": L.normal(gen, lead + (n_heads, head_dim, d_model), s_out,
                       dtype, device),
    }
    if qk_norm:
        p["q_norm"] = L.scale_init(n_heads * head_dim, device=device,
                                   lead=lead)
        p["k_norm"] = L.scale_init(n_kv_heads * head_dim, device=device,
                                   lead=lead)
    return p


def attn_axes(lead: L.Axes = (), qk_norm: bool = False
              ) -> Dict[str, L.Axes]:
    """``attn_init``'s logical axes. The QK-norm scales span the
    flattened heads; no rule splits ``qk_norm``, so they stay whole."""
    p = {"wq": lead + ("embed", "heads", "head_dim"),
         "wk": lead + ("embed", "kv_heads", "head_dim"),
         "wv": lead + ("embed", "kv_heads", "head_dim"),
         "wo": lead + ("heads", "head_dim", "embed")}
    if qk_norm:
        p["q_norm"] = p["k_norm"] = lead + ("qk_norm",)
    return p


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` of two operands of one dtype with a float32 result. On
    the card the operands stay as they are and the products accumulate in
    float32 (``aten::bmm.dtype``); the CPU has no kernel for that, and
    there ``bmm_f32_upcast`` casts them first. A product of two bf16
    values is exact in float32, so both compute one function, up to the
    order of the float32 sums. ``aten::bmm.dtype`` has no derivative in
    torch, so where autograd records, the card's product goes through
    ``_BmmF32``, whose backward multiplies on the operands' dtype too.
    A ``meta`` tensor (the dry-run) takes the card's route."""
    if a.device.type in ("cuda", "meta"):
        if L.records(a, b):
            return _BmmF32.apply(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return bmm_f32_upcast(a, b)


class _BmmF32(torch.autograd.Function):
    """``torch.bmm(a, b, out_dtype=float32)`` with its backward: the
    float32 cotangent is rounded to the operands' dtype, each gradient is
    a product of operands in that dtype with a float32 result, rounded to
    its operand's dtype. Nothing is upcast: the backward's products run
    where the forward's do."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.bmm(g, b.transpose(1, 2),
                           out_dtype=torch.float32).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.bmm(a.transpose(1, 2), g,
                           out_dtype=torch.float32).to(b.dtype)
        return ga, gb


def bmm_f32_upcast(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``bmm_f32`` with the operands cast to float32 first."""
    return torch.bmm(a.float(), b.float())


def _split_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """[B,S,H,D] -> [B,S,K,G,D]: query head h belongs to KV head h // G."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


# ---------------------------------------------------------------------------
# Full (causal or bidirectional) blockwise attention
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_block: int = 512,
                    kv_block: int = 512,
                    kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B,S,K,G,D]; k, v: [B,T,K,D]; kv_valid: optional [T] bool
    (padding mask). Returns [B,S,K,G,D]. Positions are ``arange(S)`` /
    ``arange(T)``, the only ones the JAX package's callers pass. The
    blocks must divide S and T, as the JAX package asserts.

    Online softmax over q blocks (outer) and kv blocks (inner): the live
    score tile is one [B*K, qb*G, kb] float32 tensor. Each tile is
    ``bmm_f32`` of the operands in their own dtype, scaled and masked to
    ``NEG_INF`` in place; ``p`` is rounded to v's dtype before ``p·v``;
    the output ``acc / max(l, 1e-30)`` in q's dtype. Causal kv blocks
    wholly above a q block's last position are skipped, which changes no
    bit (they add ``p = 0`` at ``alpha = 1``). Where autograd records
    (q, k or v requires grad), the same arithmetic runs out of place,
    which autograd differentiates as it does the JAX package's scan;
    serving keeps the in-place tiles."""
    # the same operations in the same order either way: the same bits
    in_place = not L.records(q, k, v)
    b, s, kh, g, d = q.shape
    t = k.shape[1]
    qb, kb = min(q_block, s), min(kv_block, t)
    if s % qb or t % kb:
        raise ValueError(f"flash_attention: S={s}, T={t} must be multiples "
                         f"of the blocks ({qb}, {kb})")
    scale = d ** -0.5
    dev = q.device
    # heads into the batch: q rows (position, group) in order, so a q block
    # is qb*g consecutive rows
    qr = q.permute(0, 2, 1, 3, 4).reshape(b * kh, s * g, d)
    kr = k.permute(0, 2, 1, 3).reshape(b * kh, t, d)
    vr = v.permute(0, 2, 1, 3).reshape(b * kh, t, d)
    out = torch.empty((b * kh, s * g, d), dtype=q.dtype, device=dev) \
        if in_place else None
    outs = []
    for q0 in range(0, s, qb):
        qblk = qr[:, q0 * g:(q0 + qb) * g]
        qpos = torch.arange(q0, q0 + qb, device=dev).repeat_interleave(g)
        acc = torch.zeros((b * kh, qb * g, d), dtype=torch.float32,
                          device=dev)
        m = torch.full((b * kh, qb * g), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        for k0 in range(0, min(t, q0 + qb) if causal else t, kb):
            sc = bmm_f32(qblk, kr[:, k0:k0 + kb].transpose(1, 2))
            sc = sc.mul_(scale) if in_place else sc * scale
            mask = None
            if causal:
                kpos = torch.arange(k0, k0 + kb, device=dev)
                mask = kpos[None, :] <= qpos[:, None]          # [qb*g,kb]
            if kv_valid is not None:
                km = kv_valid[k0:k0 + kb][None, :]
                mask = km if mask is None else mask & km
            if mask is not None:
                sc = sc.masked_fill_(~mask, NEG_INF) if in_place \
                    else sc.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            if in_place:
                p = sc.sub_(m_new[..., None]).exp_()
            else:
                p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = bmm_f32(p.to(v.dtype), vr[:, k0:k0 + kb])
            del sc, p
            acc = acc.mul_(alpha[..., None]).add_(pv) if in_place \
                else acc * alpha[..., None] + pv
            m = m_new
        denom = l.clamp_min(1e-30)[..., None]
        if in_place:
            out[:, q0 * g:(q0 + qb) * g] = acc.div_(denom)
        else:
            outs.append((acc / denom).to(q.dtype))
    if not in_place:
        out = torch.cat(outs, dim=1)
    return out.view(b, kh, s, g, d).permute(0, 2, 1, 3, 4)


# ---------------------------------------------------------------------------
# Sliding-window attention (exact, block-banded)
# ---------------------------------------------------------------------------

def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     positions: torch.Tensor, window: int) -> torch.Tensor:
    """Causal attention restricted to the last ``window`` positions.
    q: [B,S,K,G,D], k/v: [B,S,K,D]. Each query block of size W attends to
    (block-1, block) — exact for window size W. Ragged S is padded
    internally (padded keys get +inf positions and are never attended).
    The score tile is scaled and masked in place, or out of place where
    autograd records."""
    b, s, kh, g, d = q.shape
    w = min(window, s)
    pad = (-s) % w
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        positions = torch.cat([positions, positions.new_full((pad,), 2**30)])
    s_orig, s = s, s + pad
    nb = s // w

    # the blocks as one batch of products over (b, block, kv head): q
    # [., w*g, d]; k and v [., 2w, d], each block after the one before it
    # (zeros before block 0, masked out by positions), read from a strided
    # view of k and v padded by one block in front
    qb = q.reshape(b, nb, w, kh, g, d).permute(0, 1, 3, 2, 4, 5).reshape(
        b * nb * kh, w * g, d)

    def band(x):
        xp = F.pad(x, (0, 0, 0, 0, w, 0))                     # [b,s+w,kh,d]
        st = xp.stride()
        view = xp.as_strided((b, nb, kh, 2 * w, d),
                             (st[0], w * st[1], st[2], st[1], st[3]))
        return view.reshape(b * nb * kh, 2 * w, d)

    pos = positions.reshape(nb, w)
    pprev = torch.cat([torch.full_like(pos[:1], -10**9), pos[:-1]], dim=0)
    pcat = torch.cat([pprev, pos], dim=1)                     # [nb,2w]
    valid = (pcat[:, None, :] <= pos[:, :, None]) & \
            (pos[:, :, None] - pcat[:, None, :] < w)           # [nb,w,2w]

    # the float32 scores scaled and masked in place; the softmax (one pass,
    # where an in-place one takes four) into a second tile, the first
    # freed before p is rounded to v's dtype
    sc = bmm_f32(qb, band(k).transpose(1, 2))
    del qb
    sc6 = sc.view(b, nb, kh, w, g, 2 * w)
    invalid = ~valid[None, :, None, :, None, :]
    if L.records(sc):
        # autograd records: the same scale and mask out of place
        sc = (sc6 * d ** -0.5).masked_fill(invalid, NEG_INF).view(sc.shape)
    else:
        sc6.mul_(d ** -0.5)
        sc6.masked_fill_(invalid, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    del sc, sc6
    p = p.to(v.dtype)
    out = bmm_f32(p, band(v))                                 # [.,w*g,d]
    out = out.view(b, nb, kh, w, g, d).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, s, kh, g, d).to(q.dtype)[:, :s_orig]


# ---------------------------------------------------------------------------
# Decode attention
# ---------------------------------------------------------------------------

def _decode_scores(q: torch.Tensor, k_cache: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Masked float32 scores [B,K,G,T] of q [B,K,G,D] against the cache
    [B,T,K,D]: one product over (b, kv head), in the operands' dtype."""
    b, kh, g, d = q.shape
    t = k_cache.shape[1]
    kt = k_cache.transpose(1, 2).reshape(b * kh, t, d)   # a view where kh = 1
    sc = bmm_f32(q.reshape(b * kh, g, d), kt.transpose(1, 2))
    sc = sc.view(b, kh, g, t).mul_(d ** -0.5)
    return sc.masked_fill_(~valid[:, None, None, :], NEG_INF)


def _decode_values(p: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
    """p [B,K,G,T] (rounded to the cache's dtype) times the cache
    [B,T,K,D]: float32 [B,K,G,D]."""
    b, kh, g, t = p.shape
    d = v_cache.shape[-1]
    vt = v_cache.transpose(1, 2).reshape(b * kh, t, d)
    out = bmm_f32(p.to(v_cache.dtype).reshape(b * kh, g, t), vt)
    return out.view(b, kh, g, d)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *,
                     valid: torch.Tensor) -> torch.Tensor:
    """q: [B,K,G,D] (one step), cache: [B,T,K,D], valid: [B,T] bool."""
    p = torch.softmax(_decode_scores(q, k_cache, valid), dim=-1)
    return _decode_values(p, v_cache).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, *, valid: torch.Tensor,
                             axis_name: str) -> torch.Tensor:
    """Sequence-sharded decode: each shard holds a slice of the KV cache
    along T; partial attention is combined with a logsumexp reduction over
    ``axis_name``. Call inside ``spmd.shard_map``. Collective volume:
    O(B·H·D) per shard instead of gathering O(B·T·K·D) of cache."""
    sc = _decode_scores(q, k_cache, valid)
    m_glob = spmd.pmax(sc.amax(dim=-1), axis_name)                 # [b,k,g]
    p = torch.exp(sc - m_glob[..., None])
    l_loc = p.sum(dim=-1)
    o_loc = _decode_values(p, v_cache)
    l_glob = spmd.psum(l_loc, axis_name)
    o_glob = spmd.psum(o_loc, axis_name)
    out = o_glob / l_glob[..., None].clamp_min(1e-30)
    return out.to(q.dtype)


def cache_slots(block: torch.Tensor) -> int:
    """The slots of a KV cache block [..., B, T, K, D] over the whole
    mesh: T, times the shards splitting it inside a body whose cache is
    split along the slots (``sharding.kv_seq_axis``)."""
    axis = kv_seq_axis(block)
    return block.shape[-3] * (spmd.axis_size(axis) if axis else 1)


def _slot_offset(block: torch.Tensor) -> int:
    """The first slot of this shard's slice of ``block``'s slots (0 for a
    whole block)."""
    axis = kv_seq_axis(block)
    return spmd.axis_index(axis) * block.shape[-3] if axis else 0


def _cache_heads(a: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """``a`` [B,S,K',D] with the kv heads ``block`` [B,T,K,D] holds: all
    of them gathered over the model axis where the weights split them and
    the block does not (a cache split along its slots keeps every kv
    head)."""
    if a.shape[2] == block.shape[2]:
        return a
    g = spmd.all_gather(a, L.TP_AXIS)                    # [tp,B,S,K',D]
    b, s, _, d = a.shape
    return g.permute(1, 2, 0, 3, 4).reshape(b, s, -1, d)


def write_prefix(block: torch.Tensor, vals: torch.Tensor) -> None:
    """Write ``vals`` [B,w,K,D], the cache's slots ``[0, w)``, into
    ``block`` [B,T,K,D]: all of them, or inside a body whose cache is split
    along the slots the part that falls in this shard's slice."""
    vals = _cache_heads(vals, block)
    w = vals.shape[1]
    if kv_seq_axis(block) is None:
        block[:, :w] = vals
        return
    lo = _slot_offset(block)
    hi = min(lo + block.shape[1], w)
    if hi > lo:
        block[:, :hi - lo] = vals[:, lo:hi]


def _write_slot(block: torch.Tensor, slot: torch.Tensor,
                vals: torch.Tensor) -> None:
    """Write ``vals`` [B,K,D] at slot ``slot[b]`` of ``block`` [B,T,K,D]
    for each row b, with tensor indices only (no host sync); inside a
    body whose cache is split along the slots only the rows whose slot
    falls in this shard's slice change."""
    rows = torch.arange(block.shape[0], device=block.device)
    vals = _cache_heads(vals[:, None], block)[:, 0]
    if kv_seq_axis(block) is None:
        block[rows, slot] = vals
        return
    t_loc = block.shape[1]
    local = slot - _slot_offset(block)
    inside = (local >= 0) & (local < t_loc)
    idx = local.clamp(0, t_loc - 1)
    block[rows, idx] = torch.where(inside[:, None, None], vals,
                                   block[rows, idx])


def _takes_decode_kernel(use_kernel: bool, q: torch.Tensor,
                         cache: torch.Tensor) -> bool:
    """Whether a decode step's self-attention against ``cache`` [B,T,K,D]
    (whole along its slots) goes through the hand-written kernel
    (``kernels/decode_attention.py``): with ``use_kernel`` set, bf16 q and
    cache on the card (or ``meta``, the dry-run's stand-in), heads the
    kernel takes (D % 8 == 0, D <= 256, G <= 16) and nothing that
    autograd records. A CPU cache keeps ``decode_attention``."""
    d, g = q.shape[-1], q.shape[2]
    return (use_kernel and cache.device.type in ("cuda", "meta")
            and q.dtype == cache.dtype == torch.bfloat16
            and d % 8 == 0 and d <= KD.MAX_D and g <= KD.MAX_G
            and not L.records(q, cache))


def _seq_split_decode(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, valid: torch.Tensor,
                      own) -> torch.Tensor:
    """Decode attention inside a ``shard_map`` body whose cache blocks hold
    a slice of the slots along a mesh axis: partials of this shard's
    slots combined by logsumexp over the axis
    (``decode_attention_partial``). q [B,1,H',D] holds the query heads of
    the shard's weights. Where the slots split over the model axis and
    the weights split the heads, each shard's slots serve every query
    head: the heads are gathered first and the shard's own taken back
    after, for its row-parallel ``wo``. Returns [B,1,H',D]."""
    axis = kv_seq_axis(k_cache)
    b, _, h, d = q.shape
    gather = axis == L.TP_AXIS and is_split("heads")
    if gather:
        q = spmd.all_gather(q, axis).permute(1, 2, 0, 3, 4).reshape(
            b, 1, -1, d)
    else:
        k_cache, v_cache = own(k_cache), own(v_cache)
    qd = _split_gqa(q, k_cache.shape[2])[:, 0]                # [B,K,G,D]
    out = decode_attention_partial(qd, k_cache, v_cache, valid=valid,
                                   axis_name=axis).reshape(b, -1, d)
    if gather:
        r = spmd.axis_index(axis)
        out = out[:, r * h:(r + 1) * h]
    return out[:, None]


def seq_sharded_decode(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, *, valid: torch.Tensor,
                       axis: str = "data") -> torch.Tensor:
    """``decode_attention`` with the KV cache's seq dim sharded over
    ``axis`` of the active mesh (``models.sharding.use_sharding``) and the
    partials combined by logsumexp. q: [B,K,G,D]; cache: [B,T,K,D]; valid:
    [B,T]. Without a mesh, with ``axis`` of size 1 or absent, or with T
    not divisible by it, plain ``decode_attention``.

    axis='data' serves long-context decode (batch too small to shard);
    axis='model' serves kv-head-replicated GQA archs (kv % TP != 0). The
    batch shards over the other data axes where it divides, the kv heads
    over 'model' unless it is the seq axis. The result lands on q's
    device."""
    mesh = active_mesh()
    if mesh is None or axis not in mesh.shape or mesh.shape[axis] == 1 \
            or k_cache.shape[1] % mesh.shape[axis] != 0:
        return decode_attention(q, k_cache, v_cache, valid=valid)
    b = q.shape[0]
    baxes = tuple(a for a in ("pod", "data") if a in mesh.shape and a != axis)
    bsize = math.prod(mesh.shape[a] for a in baxes)
    bspec = None
    if baxes and b % bsize == 0:
        bspec = baxes if len(baxes) > 1 else baxes[0]
    msize = mesh.shape.get("model", 1)
    khead = "model" if (axis != "model" and "model" in mesh.shape
                        and msize > 1 and q.shape[1] % msize == 0) else None

    def body(qs, ks, vs, vld):
        return decode_attention_partial(qs, ks, vs, valid=vld,
                                        axis_name=axis)

    P = spmd.P
    out = spmd.shard_map(
        body, mesh,
        in_specs=(P(bspec, khead), P(bspec, axis, khead),
                  P(bspec, axis, khead), P(bspec, axis)),
        out_specs=P(bspec, khead),
    )(q, k_cache, v_cache, valid)
    return out.full(q.device)


# ---------------------------------------------------------------------------
# Full attention layer (projection + rope + path dispatch + cache handling)
# ---------------------------------------------------------------------------

def init_attn_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                    *, dtype, device, lead: Tuple[int, ...] = ()
                    ) -> Dict[str, torch.Tensor]:
    shape = lead + (batch, cache_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, *w.shape[1:])


def qk_norm(params: Dict[str, torch.Tensor], q: torch.Tensor,
            k: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """QK-norm: q [B,S,H,D] RMS-normed over each position's whole H·D
    width with ``q_norm``, and k [B,S,KH,D] over KH·D with ``k_norm``
    (``layers.rms_norm``: float32 inside, the input's dtype out). The sum runs over every head, so a shard holding some of
    the heads cannot take it alone: inside a ``shard_map`` body whose
    weights split the heads it raises."""
    if is_split("heads") or is_split("kv_heads"):
        raise NotImplementedError(
            "QK-norm with the heads split over a mesh needs a sum over the "
            "shards: not ported (see ROADMAP.md)")
    return (L.rms_norm(q.flatten(2), params["q_norm"], eps).view_as(q),
            L.rms_norm(k.flatten(2), params["k_norm"], eps).view_as(k))


def local_kv_heads(n_kv_heads: int, h_loc: int) -> Tuple[int, int]:
    """Which kv heads serve a shard's ``h_loc`` query heads inside a
    ``shard_map`` body whose weights split ``heads``: (first, count) among
    the kv heads it holds. Where they split ``kv_heads`` too it holds just
    those: all of them. Where ``n_kv_heads`` does not divide the model
    axis, ``param_specs`` replicates ``wk`` and ``wv``, and the shard takes
    the kv heads of its own query groups (query head h reads kv head
    h // G)."""
    tp = spmd.axis_size(L.TP_AXIS)
    if is_split("kv_heads"):
        return 0, n_kv_heads // tp
    g = h_loc * tp // n_kv_heads
    first = spmd.axis_index(L.TP_AXIS) * h_loc
    if h_loc % g == 0:
        return first // g, h_loc // g
    if g % h_loc == 0:
        return first // g, 1
    raise NotImplementedError(
        f"{h_loc} query heads a shard neither cover whole groups of {g} "
        f"nor lie in one: not ported (see ROADMAP.md)")


def attention_layer(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                    kind: str, rope_theta: float, n_kv_heads: int, mode: str,
                    window: int = 0,
                    lengths: Optional[torch.Tensor] = None,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    causal: bool = True,
                    use_rope: bool = True,
                    kv_override: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                    kv_valid: Optional[torch.Tensor] = None,
                    use_kernel: bool = False, flash_block: int = 512,
                    qk_norm_eps: Optional[float] = None,
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention layer. mode: 'train' | 'prefill' | 'decode'. kind:
    'global_attn' | 'local_attn' (sliding ``window``, a ring-buffer cache).
    ``causal=False`` attends both ways (the encoder's); ``use_rope=False``
    leaves q and k unrotated. ``kv_override`` = (k, v), each [B,T,KH,D],
    supplies keys and values computed elsewhere (cross-attention): the
    layer projects no k or v, rotates neither and keeps no cache, and
    ``kv_valid`` [T] bool masks their padding. The JAX layer reads
    ``kv_valid`` in decode only, the one mode its callers pass it in; here
    it masks the keys in every mode.

    Prefill with a ``cache`` writes the layer's k and v into it in place
    and returns it: slots ``[0, S)`` of a global layer's capacity cache;
    for a local layer of t slots, position p of the last ``min(t, S)`` at
    slot ``p % t``. Without one it returns what the JAX package returns: k
    and v of length S, or of a local layer the last ``min(window, S)``
    rolled into ring order. Decode (``lengths`` [B]: the new token goes to
    position ``lengths[b]``) writes slot ``lengths[b]`` (local: ``% t``)
    in place, with tensor indices only (no host sync, so a CUDA graph can
    capture it), and returns the cache; with ``kv_override`` it reads the
    given k and v under ``kv_valid`` (all of them without one) and returns
    no cache. ``use_kernel`` is the counterpart of ``use_pallas``: it
    takes a prefill's causal attention with T = S and S % 128 == 0 and no
    mask; the rest goes the blockwise way, and so does train mode, which
    never takes the forward-only kernel (the JAX model trains with
    ``use_pallas`` off). In decode it also takes self-attention against a
    bf16 cache on the card whose slots are not split through the decode
    kernel, over the valid prefix ``n = pos + 1`` (a ring: ``min(pos + 1,
    t)``; softmax does not depend on the slots' order); a CPU cache,
    ``kv_override`` and the sequence-split partials keep
    ``decode_attention``. ``qk_norm_eps`` (None: off) RMS-norms the
    projected q and k over their whole widths (``qk_norm``, with
    ``params["q_norm"]``, ``["k_norm"]``) before RoPE, in every mode and
    on every path, so that a decode step writes the normed k to the cache.

    Inside a ``shard_map`` body whose weights split ``heads``
    (``sharding.is_split``) the layer runs on its shard's blocks: the
    query heads ``wq`` holds, the kv heads ``local_kv_heads`` picks for
    them (a cache of replicated kv heads is written whole, as every
    replica holds it), and the row-parallel ``wo`` followed by a ``psum``
    over the model axis (``layers.tp_sum``). Where the body splits the
    sequence (``sharding.split_sequence``), ``x`` is the shard's slice:
    the whole sequence is gathered before the projections, the attention
    (the kernel's in prefill, the window path's) runs over it on the
    shard's heads, the cache is written from the whole sequence's k and v,
    and ``wo``'s partial sums are reduce-scattered back to the shard's
    slice."""
    if kind not in ("global_attn", "local_attn"):
        raise ValueError(f"attention_layer: {kind!r} is not an attention "
                         f"kind (global_attn, local_attn)")
    local = kind == "local_attn"
    if local and window < 1 and kv_override is None:
        raise ValueError(f"a local_attn layer needs a window, got {window}")
    x = seq_gather(x)
    b, s, _ = x.shape
    q = _project(x, params["wq"])
    q = constrain(q, "act_batch", None, "act_heads", None)
    if kv_override is None:
        k = _project(x, params["wk"])
        v = _project(x, params["wv"])
    else:
        k, v = kv_override
    if qk_norm_eps is not None:
        q, k = qk_norm(params, q, k, qk_norm_eps)
    kv0, n_kv_heads = local_kv_heads(n_kv_heads, q.shape[2]) \
        if is_split("heads") else (0, n_kv_heads)

    def own(t: torch.Tensor) -> torch.Tensor:
        """The kv heads this shard's query heads read."""
        return t if n_kv_heads == t.shape[2] else \
            t[:, :, kv0:kv0 + n_kv_heads]

    if mode in ("train", "prefill"):
        positions = torch.arange(s, device=x.device)
        if use_rope:
            q = L.apply_rope(q, positions, rope_theta)
            if kv_override is None:
                k = L.apply_rope(k, positions, rope_theta)
        qg = _split_gqa(q, n_kv_heads)
        ko, vo = own(k), own(v)
        if local and kv_override is None:
            out = window_attention(qg, ko, vo, positions=positions,
                                   window=window)
        elif use_kernel and mode == "prefill" and causal \
                and kv_valid is None and k.shape[1] == s and s % 128 == 0:
            out = flash_attention_gqa(qg, ko.contiguous(), vo.contiguous())
        else:
            out = flash_attention(qg, ko, vo, causal=causal,
                                  q_block=flash_block, kv_block=flash_block,
                                  kv_valid=kv_valid)
        del ko, vo
        new_cache = None
        if mode == "prefill" and kv_override is None:
            if local:
                # ring buffer: slot j holds the position p with p % t == j;
                # the roll aligns the last w positions to their slots
                t = window if cache is None else cache_slots(cache["k"])
                w = min(t, s)
                k, v = (torch.roll(a[:, s - w:], s % w, dims=1)
                        for a in (k, v))
            else:
                w = s
            if cache is None:
                new_cache = {"k": k, "v": v}
            else:
                write_prefix(cache["k"], k)
                write_prefix(cache["v"], v)
                new_cache = cache
    elif mode == "decode":
        if lengths is None or (cache is None and kv_override is None):
            raise ValueError("decode needs lengths and a cache or "
                             "kv_override")
        pos = lengths.to(torch.int64)                                 # [B]
        if use_rope:
            q = L.apply_rope(q, pos[:, None], rope_theta)
            if kv_override is None:
                k = L.apply_rope(k, pos[:, None], rope_theta)
        qd = _split_gqa(q, n_kv_heads)[:, 0]                          # [B,K,G,D]
        if kv_override is not None:
            t = k.shape[1]
            if kv_valid is None:
                valid = torch.ones((b, t), dtype=torch.bool, device=x.device)
            else:
                off = _slot_offset(k)
                valid = kv_valid[None, off:off + t].expand(b, t)
            if kv_seq_axis(k) is not None:
                out = _seq_split_decode(q, k, v, valid, own)
            else:
                out = decode_attention(qd, own(k), own(v),
                                       valid=valid)[:, None]
            new_cache = None
        else:
            t = cache_slots(cache["k"])
            slot = pos % t if local else pos
            _write_slot(cache["k"], slot, k[:, 0])
            _write_slot(cache["v"], slot, v[:, 0])
            # the valid slots are a prefix: [0, pos] of a global layer, of
            # a ring all that have been written
            n = torch.clamp(pos + 1, max=t) if local else pos + 1
            kc, vc = own(cache["k"]), own(cache["v"])
            if kv_seq_axis(cache["k"]) is None \
                    and _takes_decode_kernel(use_kernel, qd, kc):
                out = KD.decode_attention(
                    qd.contiguous(), kc, vc, n.to(torch.int32))[:, None]
            else:
                iota = torch.arange(cache["k"].shape[1], device=x.device)
                if kv_seq_axis(cache["k"]) is not None:
                    iota = iota + _slot_offset(cache["k"])
                valid = iota[None, :] < n[:, None]
                if kv_seq_axis(cache["k"]) is not None:
                    out = _seq_split_decode(q, cache["k"], cache["v"], valid,
                                            own)
                else:
                    out = decode_attention(qd, kc, vc, valid=valid)[:, None]
            new_cache = cache
    else:
        raise ValueError(mode)

    wo = params["wo"]                                                 # [H,D,M]
    y = out.to(x.dtype).reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])
    y = L.tp_sum(y, "heads")
    y = constrain(y, "act_batch", "act_seq", "act_embed")
    return y, new_cache
