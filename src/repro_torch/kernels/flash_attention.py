"""Forward flash attention: the CUDA kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``_flash_kernel`` / ``flash_attention`` of
``repro/kernels/flash_attention.py``: scores ``dot(q, kᵀ)`` in float32,
then times ``D**-0.5``; the optional causal mask ``kpos <= qpos`` with
both positions counted from 0 (top-left) and ``NEG_INF = -1e30``; an
online softmax with float32 ``m``, ``l`` and ``acc``; ``p`` rounded to
v's dtype before ``p·v``; output ``acc / max(l, 1e-30)`` in q's dtype.

Two entry points share one kernel, which reads its operands through
strides and a group size ``G``:

  * ``flash_attention(q[BH,S,D], k[BH,T,D], v)``: the Pallas contract
    (heads folded, GQA broadcast beforehand);
  * ``flash_attention_gqa(q[B,S,KH,G,D], k[B,T,KH,D], v)``: what the
    attention layer calls. Query head ``(kh, g)`` reads KV head ``kh`` in
    place, without the broadcast copies and transposes of the JAX
    package's ``_pallas_flash``.

The kernel takes float32 and bfloat16, any D, any S and T (rows past S
are not stored, K and V rows past T are read as zeros and masked to
``NEG_INF``), and 16-byte aligned operands (both arms copy 16 bytes at a
time with cp.async). That is every input the Pallas entry point takes
(any D; any S, T up to 128, or multiples of 128) and more. bfloat16 runs
on the tensor cores (mma.sync), float32 on the CUDA cores in IEEE
float32 (register-blocked, K and V tiles double-buffered). Heads wider
than 128 take a kernel per dtype that gives each block one 128-wide
group of output columns and recomputes the full-D scores in 64-wide
chunks. It is bound by operations: see the note in the CUDA source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import count_launch

NEG_INF = -1e30
TILE = 64            # the kernels' kv tile
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_block: int = TILE,
                          kv_block: int = TILE) -> torch.Tensor:
    """The same online softmax in plain PyTorch, block by block.

    q: [B,S,KH,G,D]; k, v: [B,T,KH,D]. Positions are ``arange(S)`` and
    ``arange(T)``. With
    the default blocks it walks the kv tiles in the kernel's order; kv
    blocks wholly above the causal diagonal are skipped, which changes no
    bit (they add ``p = 0`` at ``alpha = 1``). The last q and kv blocks
    are cut short where the blocks do not divide S and T."""
    b, s, kh, g, d = q.shape
    t = k.shape[1]
    scale = d ** -0.5
    out = torch.empty_like(q)
    for q0 in range(0, s, q_block):
        qb = min(q_block, s - q0)
        qblk = q[:, q0:q0 + qb].float()
        qpos = torch.arange(q0, q0 + qb, device=q.device)
        acc = torch.zeros((b, qb, kh, g, d), dtype=torch.float32,
                          device=q.device)
        m = torch.full((b, qb, kh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        k_end = min(t, q0 + qb) if causal else t
        for k0 in range(0, k_end, kv_block):
            kb = min(kv_block, t - k0)
            kblk = k[:, k0:k0 + kb]
            vblk = v[:, k0:k0 + kb]
            sc = torch.einsum("bqkgd,bckd->bqkgc", qblk, kblk.float()) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kb, device=q.device)
                mask = kpos[None, :] <= qpos[:, None]            # [qb,kb]
                sc = sc.masked_fill(~mask[None, :, None, None, :], NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bqkgc,bckd->bqkgd", p.to(v.dtype).float(),
                              vblk.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, q0:q0 + qb] = (acc / torch.clamp(l[..., None], min=1e-30)
                              ).to(q.dtype)
    return out


def _check(q, k, v, what):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise ValueError(f"{what}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         f"the kernel takes float32 or bfloat16, all alike")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"{what}: operands on {q.device}, {k.device}, "
                         f"{v.device}; the kernel needs one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    if k.shape != v.shape:
        raise ValueError(f"{what}: k{tuple(k.shape)} != v{tuple(v.shape)}")


def _launch(q, k, v, b, s, t, kh, g, d, causal, what) -> torch.Tensor:
    if d <= 0:
        raise ValueError(f"{what}: head dim {d} must be positive")
    if s <= 0 or t <= 0:
        raise ValueError(f"{what}: S={s}, T={t} must be positive")
    if b * kh * g > 65535:
        raise ValueError(f"{what}: {b * kh * g} heads exceed the grid")
    from repro_torch.kernels import _build
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, kh, g, d, int(causal), ctypes.c_float(d ** -0.5),
            stream), what)
    count_launch("flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: [BH,S,D]; k, v: [BH,T,D] → [BH,S,D] in q's dtype (the Pallas
    kernel's contract)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q[:, :, None, None], k[:, :, None],
                                     v[:, :, None], causal=causal)[:, :, 0, 0]
    _check(q, k, v, "flash_attention")
    bh, s, d = q.shape
    bh2, t, d2 = k.shape
    if bh2 != bh or d2 != d:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} vs "
                         f"k{tuple(k.shape)}")
    return _launch(q, k, v, bh, s, t, 1, 1, d, causal, "flash_attention")


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: [B,S,KH,G,D]; k, v: [B,T,KH,D] → [B,S,KH,G,D] in q's dtype;
    query head ``kh·G + g`` attends with KV head ``kh``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    _check(q, k, v, "flash_attention_gqa")
    b, s, kh, g, d = q.shape
    b2, t, kh2, d2 = k.shape
    if (b2, kh2, d2) != (b, kh, d):
        raise ValueError(f"flash_attention_gqa: q{tuple(q.shape)} vs "
                         f"k{tuple(k.shape)}")
    return _launch(q, k, v, b, s, t, kh, g, d, causal, "flash_attention_gqa")
