"""Mamba-2 SSD (state-space duality) block (``repro/models/ssm.py`` at the
same path).

Training and prefill use the chunked SSD algorithm (intra-chunk quadratic
form + inter-chunk linear recurrence); decode uses the O(1) recurrent state
update. With ``use_kernel`` and one group, the intra-chunk part (``y_diag``
and the chunk ``states``) comes from ``kernels.ssd.ssd_chunk``, the CUDA
kernel that replaces the JAX package's Pallas one (its plain version on a
CPU tensor); otherwise from the JAX module's einsums, ported as they are.
The inter-chunk recurrence and ``y_off`` are plain PyTorch, as the JAX
package computes them outside the Pallas kernel.

Cumulative sums accumulate in float64 and round to float32
(``kernels.ssd.cumsum_f32``): ``torch.cumsum`` of float32 does exactly
that on the CPU, and on the card it keeps the kernel and the einsum path
on the same ``cs``.

Inside a ``shard_map`` body the block's weights are whole (``ssm_inner``
is replicated). Where the body splits the sequence
(``sharding.split_sequence``) the block gathers it, runs whole (the
kernel in prefill) and keeps its shard's slice of the output.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd import cumsum_f32, ssd_chunk
from repro_torch.models import layers as L
from repro_torch.models.sharding import seq_gather, seq_slice


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., q] -> [..., q, q] lower-triangular inclusive segment sums:
    out[..., i, j] = sum_{k=j+1..i} x[..., k] (-inf above the diagonal)."""
    q = x.shape[-1]
    cs = cumsum_f32(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def ssd_init(gen, d_model: int, scfg: SSMConfig, *, dtype, device,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Random weights from ``gen``; ``lead`` prepends stacking axes."""
    di = scfg.expand * d_model
    nh = di // scfg.headdim
    gn = scfg.ngroups * scfg.d_state
    conv_ch = di + 2 * gn

    def per_head(values: torch.Tensor) -> torch.Tensor:
        return values.to(device).expand(lead + (nh,)).clone()

    return {
        # fused input projection: [z, x, B, C, dt]
        "in_proj": L.dense_init(gen, d_model, 2 * di + 2 * gn + nh,
                                dtype=dtype, device=device, lead=lead),
        "conv_w": L.normal(gen, lead + (scfg.conv_width, conv_ch),
                           1.0 / math.sqrt(scfg.conv_width), dtype, device),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, nh))),
        "D": per_head(torch.ones(nh)),
        "dt_bias": per_head(torch.log(torch.expm1(torch.full((nh,), 0.01)))),
        "norm": L.scale_init(di, device=device, lead=lead),
        "out_proj": L.dense_init(gen, di, d_model, dtype=dtype, device=device,
                                 lead=lead),
    }


def ssd_axes(lead: L.Axes = ()) -> Dict[str, L.Axes]:
    """``ssd_init``'s logical axes (``ssm_inner`` stays replicated: pure
    data parallelism, as in the JAX package)."""
    return {"in_proj": lead + ("embed", "ssm_inner"),
            "conv_w": lead + ("conv", "ssm_inner"),
            "conv_b": lead + ("ssm_inner",), "A_log": lead + (None,),
            "D": lead + (None,), "dt_bias": lead + (None,),
            "norm": lead + ("ssm_inner",),
            "out_proj": lead + ("ssm_inner", "embed")}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: [B,S,C]; w: [W,C]. Returns (y, new_state)
    where state is the last W-1 inputs [B,W-1,C]. The sum of shifted
    products in x's dtype, in the JAX package's order (no ``conv1d``,
    whose sum order differs in bf16)."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(width)) + b
    new_state = xp[:, xp.shape[1] - (width - 1):]
    return F.silu(y), new_state


def _ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, chunk: int,
                 init_state: Optional[torch.Tensor] = None,
                 use_kernel: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. x: [b,s,h,p]; dt: [b,s,h]; A: [h]; B,C: [b,s,g,n] with g
    dividing h. Returns (y [b,s,h,p], final_state [b,h,p,n])."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        # dt=0 on padding → decay 1, zero input: state passes through unchanged
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    s_orig, s = s, s + pad
    c = s // q
    rep = h // g

    xr = x.reshape(b, c, q, h, p)
    dtr = dt.reshape(b, c, q, h)
    dA = dtr * A                                        # [b,c,q,h] (negative)
    dA_cs = cumsum_f32(dA, dim=2)                       # [b,c,q,h]
    if use_kernel and g == 1:
        # intra-chunk (diagonal blocks) and chunk states from the kernel
        y_diag, states = ssd_chunk(
            xr.reshape(b * c, q, h, p).contiguous(),
            dtr.reshape(b * c, q, h).contiguous(), A.contiguous(),
            B.reshape(b * c, q, n).contiguous(),
            C.reshape(b * c, q, n).contiguous())
        y_diag = y_diag.reshape(b, c, q, h, p)
        states = states.reshape(b, c, h, p, n)
    else:
        Br = torch.repeat_interleave(B.reshape(b, c, q, g, n), rep, dim=3)
        Cr = torch.repeat_interleave(C.reshape(b, c, q, g, n), rep, dim=3)
        # intra-chunk (diagonal blocks)
        Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))  # [b,c,h,q,q]
        xdt = xr * dtr[..., None]
        scores = torch.einsum("bclhn,bcshn->bchls", Cr, Br) * Lmat
        y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xdt)
        # chunk states
        decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # [b,c,q,h]
        states = torch.einsum("bcshn,bcsh,bcshp->bchpn", Br, decay_states,
                              xdt)
        del Br, Cr, Lmat, scores
    # inter-chunk recurrence: emit the state *before* each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])         # [b,c,h]
    carry = init_state.float() if init_state is not None else \
        torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prev_states = torch.empty((b, c, h, p, n), dtype=torch.float32,
                              device=x.device)
    for i in range(c):
        prev_states[:, i] = carry
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    state_decay = torch.exp(dA_cs)                      # [b,c,q,h]
    # y_off[l,h,p] = Σ_n C[l,g(h),n]·prev[h,p,n]·state_decay[l,h], each
    # group's C row against its heads' states
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", C.reshape(b, c, q, g, n),
                         prev_states.reshape(b, c, g, rep, p, n))
    y_off = y_off.reshape(b, c, q, h, p) * state_decay[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y[:, :s_orig], carry


def ssd_layer(params: Dict[str, torch.Tensor], u: torch.Tensor, *,
              scfg: SSMConfig, mode: str,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              use_kernel: bool = False
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full Mamba-2 block. u: [B,S,D]. mode: train|prefill|decode.
    cache: {"conv": [B,W-1,C], "state": [B,H,P,N]}; a prefill reads its
    conv state (the scan starts from zero), a decode both. Returns
    (out, new_cache) with new tensors in ``new_cache``. ``use_kernel``
    takes the intra-chunk form from the kernel in prefill; train mode
    takes the einsum path, which autograd differentiates (the kernel has
    no backward). Where the body splits the sequence, ``u`` and the output
    are the shard's slice (module docstring)."""
    u = seq_gather(u)
    b, s, d = u.shape
    di = scfg.expand * d
    nh = di // scfg.headdim
    gn = scfg.ngroups * scfg.d_state

    proj = u @ params["in_proj"]
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * gn, nh], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    x, B, C = torch.split(xbc, [di, gn, gn], dim=-1)
    x = x.reshape(b, s, nh, scfg.headdim)
    B = B.reshape(b, s, scfg.ngroups, scfg.d_state).float()
    C = C.reshape(b, s, scfg.ngroups, scfg.d_state).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"])        # [b,s,h]
    A = -torch.exp(params["A_log"])                              # [h]

    if mode in ("train", "prefill"):
        y, final_state = _ssd_chunked(x.float(), dt, A, B, C,
                                      scfg.chunk_size,
                                      use_kernel=use_kernel
                                      and mode == "prefill")
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv": new_conv, "state": final_state}
    elif mode == "decode":
        if cache is None:
            raise ValueError("ssd_layer: decode needs a cache")
        st = cache["state"].float()                              # [b,h,p,n]
        rep = nh // scfg.ngroups
        B1 = torch.repeat_interleave(B[:, 0], rep, dim=1)        # [b,h,n]
        C1 = torch.repeat_interleave(C[:, 0], rep, dim=1)
        dt1 = dt[:, 0]                                           # [b,h]
        dA = torch.exp(dt1 * A)                                  # [b,h]
        x1 = x[:, 0].float()                                     # [b,h,p]
        st = st * dA[:, :, None, None] + torch.einsum(
            "bhp,bhn,bh->bhpn", x1, B1, dt1)
        y = torch.einsum("bhpn,bhn->bhp", st, C1)[:, None]       # [b,1,h,p]
        new_cache = {"conv": new_conv, "state": st}
        x = x1[:, None]
    else:
        raise ValueError(mode)

    y = y + params["D"][:, None] * x.float()
    y = y.reshape(b, s, di).to(u.dtype)
    y = y * F.silu(z)
    y = L.rms_norm(seq_slice(y), params["norm"])
    return y @ params["out_proj"], new_cache


def init_ssd_cache(batch: int, d_model: int, scfg: SSMConfig, *, dtype,
                   device, lead: Tuple[int, ...] = ()
                   ) -> Dict[str, torch.Tensor]:
    di = scfg.expand * d_model
    nh = di // scfg.headdim
    gn = scfg.ngroups * scfg.d_state
    return {
        "conv": torch.zeros(lead + (batch, scfg.conv_width - 1, di + 2 * gn),
                            dtype=dtype, device=device),
        "state": torch.zeros(lead + (batch, nh, scfg.headdim, scfg.d_state),
                             dtype=torch.float32, device=device),
    }
