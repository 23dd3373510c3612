"""Decode attention against a KV cache: the CUDA kernel
(``csrc/decode_attention.cu``) and its plain PyTorch version.

Replaces no Pallas kernel. The JAX package computes one decode step's
attention as two einsums (``repro/models/attention.py``,
``decode_attention``), and the port's plain version
(``models.attention.decode_attention``) as two batched products, which on
the card copy the whole cache into a [B*K, T, D] layout every layer and
score every slot of its capacity. The kernel reads each valid cached byte
once, where it lies, and computes the same function: float32 scores of the
bf16 operands times ``D**-0.5``, a float32 online softmax over the slots
``[0, n[b])`` of row b (the slots past it contribute exactly zero, as the
plain path's ``NEG_INF`` mask gives), ``p`` rounded to the cache's dtype
before ``p·v`` (as the prefill kernel does), float32 accumulation, the
output ``acc / max(l, 1e-30)`` in q's dtype.

``decode_attention(q[B,K,G,D], k[B,T,K,D], v, n[B])``: the caches are read
through their strides (a slice of the kv heads, or one layer of a stacked
cache, needs no copy), ``n`` is int32 on q's device and is never read on
the host, so a CUDA graph captured once replays right as the lengths grow.
The slots split into ``split_plan`` chunks of ``TILE``-slot tiles, one
block per (split, kv head, request), each split's partial (acc, m, l)
combined by logsumexp in a second small kernel; the call counts one
launch. It is bound by bytes: see the note in the CUDA source.

A CPU tensor takes ``decode_attention_plain``, the same split arithmetic
in PyTorch. A CUDA tensor launches the kernel or raises: bf16 operands,
8 <= D <= 256 with D % 8 == 0, G <= 16. On the ``meta`` device the wrapper
checks what the card's does, allocates what it allocates and returns an
empty output, recording the launch and its ``cost`` with the dry-run's
counter.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import opcount
from repro_torch.kernels import Cost, aligned16, count_launch
from repro_torch.kernels.flash_attention import NEG_INF

TILE = 64          # slots a block loads at once, 16 a warp
WARP_SLOTS = 16    # slots of one warp's share of a tile
SMS = 132          # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 4  # blocks of a launch per SM that the split count aims at
MAX_D, MAX_G = 256, 16


def split_plan(b: int, kh: int, t: int,
               splits: Optional[int] = None) -> Tuple[int, int]:
    """(splits, chunk): the slots ``[0, t)`` cut into ``splits`` chunks of
    ``chunk`` slots, a multiple of ``TILE``. By default enough splits that
    the ``b * kh`` heads give about ``BLOCKS_PER_SM`` blocks to each SM,
    each split at least two tiles; a given ``splits`` is the most there
    are (fewer where whole tiles leave some empty)."""
    if splits is None:
        splits = min(-(-t // (2 * TILE)),
                     -(-BLOCKS_PER_SM * SMS // max(1, b * kh)))
    splits = max(1, splits)
    chunk = TILE * -(-(-(-t // splits)) // TILE)
    return -(-t // chunk), chunk


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, n: torch.Tensor, *,
                           splits: Optional[int] = None) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch: q [B,K,G,D], caches [B,T,K,D],
    n [B] → [B,K,G,D] in q's dtype.

    Each split's ``chunk`` slots go by tiles of ``TILE``, each tile's
    ``WARP_SLOTS``-slot shares kept apart (a warp each), every share with
    its own online softmax; the shares of a split, then the splits, are
    combined by logsumexp. Slots at or past ``min(n[b], T)`` are read as
    zeros and give ``p = 0``."""
    b, kh, g, d = q.shape
    t = k_cache.shape[1]
    splits, chunk = split_plan(b, kh, t, splits)
    warps = TILE // WARP_SLOTS
    dev = q.device
    f32 = torch.float32
    limit = torch.clamp(n.to(device=dev, dtype=torch.int64), max=t)
    slots = (torch.arange(splits, device=dev)[:, None, None] * chunk
             + torch.arange(warps, device=dev)[None, :, None] * WARP_SLOTS
             + torch.arange(WARP_SLOTS, device=dev))          # [S,W,16]
    qf = q.float()
    m = torch.full((splits, warps, b, kh, g), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (d,), dtype=f32, device=dev)
    for j in range(chunk // TILE):
        slot = slots + j * TILE
        ok = slot[:, :, None] < limit[:, None]                # [S,W,B,16]
        idx = slot.clamp(max=t - 1)
        okx = ok.permute(2, 0, 1, 3)[..., None, None]         # [B,S,W,16,1,1]
        kk = torch.where(okx, k_cache[:, idx], 0).float()     # [B,S,W,16,K,D]
        vv = torch.where(okx, v_cache[:, idx], 0)
        okm = ok[:, :, :, None, None, :]                      # [S,W,B,1,1,16]
        sc = torch.einsum("bkgd,bswikd->swbkgi", qf, kk) * (d ** -0.5)
        sc = torch.where(okm, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(okm, torch.exp(sc - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("swbkgi,bswikd->swbkgd", p.to(v_cache.dtype).float(),
                          vv.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    # the warps of a split, then the splits
    mb = m.amax(dim=1)
    f = torch.exp(m - mb[:, None])
    lb = (l * f).sum(dim=1)
    ob = (acc * f[..., None]).sum(dim=1)
    mt = mb.amax(dim=0)
    f = torch.exp(mb - mt)
    lt = (lb * f).sum(dim=0)
    ot = (ob * f[..., None]).sum(dim=0)
    return (ot / lt.clamp_min(1e-30)[..., None]).to(q.dtype)


def cost(q: torch.Tensor, k_cache: torch.Tensor) -> Cost:
    """One call's work, q [B,K,G,D] and a cache [B,T,K,D], from shapes:
    4·D FLOPs for each (query head, slot) pair (q·k and p·v) over the
    cache's T slots; q read once, K and V read once, the output written
    once."""
    b, kh, g, d = q.shape
    t = k_cache.shape[1]
    nbytes = (2 * q.numel() + 2 * k_cache.numel()) * q.element_size()
    return Cost(4 * b * kh * g * d * t, nbytes)


def _check(q, k, v, n) -> None:
    what = "decode_attention"
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError(f"{what}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         f"the kernel takes bfloat16")
    if n.dtype != torch.int32 or n.dim() != 1:
        raise ValueError(f"{what}: n must be a 1-d int32 tensor, got "
                         f"{n.dtype} of shape {tuple(n.shape)}")
    devs = {x.device for x in (q, k, v, n)}
    if len(devs) != 1 or q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what}: operands on {sorted(map(str, devs))}; "
                         f"the kernel needs one CUDA device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q{tuple(q.shape)}, k{tuple(k.shape)}, "
                         f"v{tuple(v.shape)}")
    b, kh, g, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kh, d) \
            or n.shape[0] != b:
        raise ValueError(f"{what}: q{tuple(q.shape)} vs cache "
                         f"{tuple(k.shape)} and n{tuple(n.shape)}")
    if not (8 <= d <= MAX_D and d % 8 == 0) or not 1 <= g <= MAX_G:
        raise ValueError(f"{what}: D={d}, G={g}; the kernel takes "
                         f"8 <= D <= {MAX_D} with D % 8 == 0, G <= {MAX_G}")
    if not q.is_contiguous():
        raise ValueError(f"{what}: q must be contiguous")
    if k.stride() != v.stride() or k.stride(3) != 1 \
            or any(s % 8 for s in k.stride()[:3]) \
            or max(k.stride()) >= 2 ** 31:
        raise ValueError(f"{what}: cache strides {k.stride()} and "
                         f"{v.stride()}: both alike, unit along D, rows of "
                         f"16-byte multiples, int32 offsets")
    if not all(aligned16(x) for x in (q, k, v)) or (
            q.device.type == "cuda"
            and any(x.data_ptr() % 16 for x in (q, k, v))):
        raise ValueError(f"{what}: operands must be 16-byte aligned")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, n: torch.Tensor, *,
                     splits: Optional[int] = None) -> torch.Tensor:
    """q [B,K,G,D]; caches [B,T,K,D]; n [B] int32, row b attending to
    slots ``[0, n[b])`` → [B,K,G,D] in q's dtype."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, n, splits=splits)
    _check(q, k_cache, v_cache, n)
    b, kh, g, d = q.shape
    t = k_cache.shape[1]
    splits, chunk = split_plan(b, kh, t, splits)
    out = torch.empty_like(q)
    part_o = torch.empty((splits, b, kh, g, d), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((splits, b, kh, g, 2), dtype=torch.float32,
                          device=q.device)
    if q.device.type == "meta":
        opcount.kernel("decode_attention", *cost(q, k_cache))
        return out
    from repro_torch.kernels import _build
    lib = _build.library("decode_attention")
    sb, st, sk, _ = k_cache.stride()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.decode_attention_bf16(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            n.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
            out.data_ptr(), b, t, kh, g, d, sb, st, sk, splits, chunk,
            ctypes.c_float(d ** -0.5), stream), "decode_attention")
    count_launch("decode_attention")
    opcount.kernel("decode_attention", *cost(q, k_cache))
    return out
