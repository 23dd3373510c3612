"""Mamba-2 SSD intra-chunk form: the CUDA kernel (``csrc/ssd.cu``) and its
plain PyTorch version.

Replaces the Pallas TPU kernel ``_ssd_chunk_kernel`` / ``ssd_chunk`` of
``repro/kernels/ssd.py``. For every (batch x chunk) index of
``x [bc,q,h,p]``, ``dt [bc,q,h]``, ``A [h]``, ``B, C [bc,q,n]``
(ngroups = 1):

  * ``cs = cumsum(dt·A)`` over q;
  * ``y[l,h,p] = Σ_{s≤l} (C_l·B_s)·exp(cs_l − cs_s)·dt_s·x[s,h,p]``;
  * ``states[h,p,n] = Σ_s B_s[n]·exp(cs_last − cs_s)·dt_s·x[s,h,p]``;

both float32. The cumulative sum is accumulated in float64 and rounded to
float32, which is what ``torch.cumsum`` of a float32 tensor computes on the
CPU; on the card it keeps the kernel's and the plain version's ``cs``
equal (see the note in the CUDA source).

The kernel takes float32 at any q, h, p and n, as the Pallas kernel does.
It factors the decay off the diagonal 64-row tiles, so that the scores
``C·Bᵀ`` (computed once a call) and the off-diagonal part of ``y`` and the
states become plain register-blocked products shared by all heads; the
diagonal tiles, and the heads whose ``cs`` increases somewhere in a chunk,
keep the direct masked form. It needs a float32 workspace of
``BC·(H·Q·(3 + ⌈Q/64⌉) + H + 64·Q·⌈Q/64⌉)`` floats (62 MB at the
mamba2-370m prefill's 128 chunks of 256), which the wrapper allocates per
call; that is the only limit beside memory. It is bound by operations.
On the ``meta`` device the wrapper checks and allocates what the card's
does and records the launch and its ``cost`` with the dry-run's counter.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import opcount
from repro_torch.kernels import Cost, aligned16, count_launch

_TILE = 64           # the kernels' row tile (``kT`` in csrc/ssd.cu)


def cumsum_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Cumulative sum accumulated in float64, rounded to float32."""
    return torch.cumsum(x.double(), dim=dim).float()


def _shapes(x, dt, A, B, C) -> Tuple[int, int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"ssd_chunk: x{tuple(x.shape)} is not [bc,q,h,p]")
    bc, q, h, p = x.shape
    n = B.shape[-1]
    want = {"dt": (bc, q, h), "A": (h,), "B": (bc, q, n), "C": (bc, q, n)}
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_chunk: {name}{tuple(t.shape)}, want "
                             f"{want[name]} for x{tuple(x.shape)}")
    return bc, q, h, p, n


def cost(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
         B: torch.Tensor, C: torch.Tensor) -> Cost:
    """One call's work: the products C·Bᵀ over the causal half, w·xdt over
    it and the states contraction (the elementwise decay and exponentials,
    about 1/p of these, are not counted); each input read once and each
    output (y, states) written once, float32."""
    bc, q, h, p, n = _shapes(x, dt, A, B, C)
    pairs = q * (q + 1) // 2
    flops = 2 * bc * (pairs * n + h * pairs * p + h * q * p * n)
    nbytes = 4 * (2 * bc * q * h * p + bc * q * h + h + 2 * bc * q * n
                  + bc * h * p * n)
    return Cost(flops, nbytes)


def workspace_floats(bc: int, q: int, h: int) -> int:
    """The kernel's workspace (``ssd_workspace_floats`` in csrc/ssd.cu)."""
    t = -(-q // _TILE)
    return bc * (h * q * (3 + t) + h + q * t * _TILE)


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, one head at a time: the largest
    temporary is one head's ``[bc, q, q]`` decay."""
    bc, q, h, p, n = _shapes(x, dt, A, B, C)
    cs = cumsum_f32(dt * A, dim=1)                          # [bc,q,h]
    scores = torch.bmm(C, B.transpose(1, 2))                # [bc,l,s]
    xdt = x * dt[..., None]
    causal = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    y = torch.empty((bc, q, h, p), dtype=torch.float32, device=x.device)
    for hh in range(h):
        c = cs[:, :, hh]
        L = torch.where(causal, torch.exp(c[:, :, None] - c[:, None, :]),
                        0.0)
        y[:, :, hh] = torch.bmm(scores * L, xdt[:, :, hh])
    decay = torch.exp(cs[:, -1:] - cs)                      # [bc,q,h]
    u = x * (decay * dt)[..., None]                         # [bc,s,h,p]
    st = torch.bmm(u.permute(0, 2, 3, 1).reshape(bc, h * p, q), B)
    return y, st.reshape(bc, h, p, n).float()


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [bc,q,h,p]; dt: [bc,q,h]; A: [h]; B, C: [bc,q,n] →
    (y_diag [bc,q,h,p], states [bc,h,p,n]), float32 (the Pallas kernel's
    contract)."""
    bc, q, h, p, n = _shapes(x, dt, A, B, C)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, A, B, C)
    args = (x, dt, A, B, C)
    if any(t.dtype != torch.float32 for t in args):
        raise ValueError(f"ssd_chunk: dtypes {[t.dtype for t in args]}; the "
                         f"kernel takes float32")
    route = "meta" if x.device.type == "meta" else "cuda"
    if any(t.device != x.device for t in args) or x.device.type != route:
        raise ValueError(f"ssd_chunk: operands on "
                         f"{[str(t.device) for t in args]}; the kernel needs "
                         f"one CUDA device")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("ssd_chunk: operands must be contiguous")
    # the kernel reads rows as float4: a view that starts off a 16-byte
    # boundary is copied first (a fresh tensor starts on one)
    x, dt, A, B, C = (t if aligned16(t) else t.clone() for t in args)
    if min(q, h, p, n) < 1:
        raise ValueError(f"ssd_chunk: empty dimension in (q, h, p, n) = "
                         f"{(q, h, p, n)}")
    y = torch.empty((bc, q, h, p), dtype=torch.float32, device=x.device)
    st = torch.empty((bc, h, p, n), dtype=torch.float32, device=x.device)
    if route == "meta":
        torch.empty(workspace_floats(bc, q, h), dtype=torch.float32,
                    device=x.device)
        opcount.kernel("ssd_chunk", *cost(x, dt, A, B, C))
        return y, st
    from repro_torch.kernels import _build
    lib = _build.library("ssd")
    floats = ctypes.c_longlong(0)
    _build.check(lib.ssd_workspace_floats(bc, q, h, ctypes.addressof(floats)),
                 "ssd_chunk")
    work = torch.empty(floats.value, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.ssd_chunk_f32(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), st.data_ptr(), work.data_ptr(), bc,
            q, h, p, n, stream), "ssd_chunk")
    count_launch("ssd_chunk")
    opcount.kernel("ssd_chunk", *cost(x, dt, A, B, C))
    return y, st
