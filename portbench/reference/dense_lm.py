"""Plain reference of a dense decoder-only transformer of the Llama form
(Yi-9B, arXiv:2403.04652): token embedding; per layer a pre-norm
grouped-query attention with rotary positions and a pre-norm gated MLP,
each added to the residual stream; a final norm and an untied
unembedding.

    h = rms(x) * g1;  q, k, v = h Wq, h Wk, h Wv;  q, k = rope(q), rope(k)
    x = x + softmax(q k^T / sqrt(d) + causal) v Wo
    h = rms(x) * g2;  x = x + (silu(h Wg) * (h Wi)) Wo'
    logits = (rms(x) * g) U

RoPE rotates the two halves of each head as pairs (x_i, x_{i + d/2}) by
position * theta^(-2i/d). Query head j reads KV head j // (H / KH).

Float32 throughout, with TF32 off, layer by layer (each layer's weights
cast once), one request and one head at a time in attention, so that it
fits beside the served weights. ``products=
"fp8"`` is the control: every product's operands (the activations per
row, the weights per output column, q, k and v per head row) rounded to
float8 e4m3 with a scale of their largest magnitude over 448, then
multiplied in float32.

Takes the weights as the benchmark drew them (``portbench.weights``:
``embed`` [V, D], ``final_norm`` [D], ``unembed`` [D, V], and per layer
stacked ``layers.norm1`` [L, D], ``layers.attn.wq`` [L, D, H, d], ``wk``,
``wv`` [L, D, KH, d], ``wo`` [L, H, d, D], ``layers.norm2``,
``layers.mlp.wi``, ``wg`` [L, D, F], ``wo`` [L, F, D]). Imports nothing but
torch.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32 (no TF32) inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded to float8 e4m3, scaled by its largest
    magnitude along ``dim`` over 448, and scaled back."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Products:
    def __init__(self, mode: str):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"products {mode!r}: fp32 or fp8")
        self.fp8 = mode == "fp8"

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x [..., K] (float32) times w [K, N] (any float type)."""
        w = w.float()
        if self.fp8:
            x, w = fp8_round(x, -1), fp8_round(w, 0)
        return x @ w

    def heads(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t, -1) if self.fp8 else t


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * g.float()


def rope(t: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """t [S, heads, d] rotated by ``positions`` [S]."""
    d = t.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=t.device) / d)
    ang = (positions.to(torch.float64)[:, None] * inv).float()[:, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = t[..., :d // 2], t[..., d // 2:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """q [S, H, d], k, v [S, KH, d] -> [S, H, d], causal."""
    s, h, d = q.shape
    g = h // k.shape[1]
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    for j in range(h):          # one head at a time: [S, S] scores
        sc = (q[:, j] @ kk[:, j].T) / d ** 0.5
        sc.masked_fill_(torch.ones(s, s, dtype=torch.bool,
                                   device=q.device).triu_(1), float("-inf"))
        out[:, j] = torch.softmax(sc, dim=-1) @ vv[:, j]
    return out


def forward(w: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
            logit_positions: Iterable[int], *, products: str = "fp32",
            kv_positions: Optional[slice] = None
            ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Run ``tokens`` [B, S] through the model. Returns the logits at
    ``logit_positions`` [B, P, V] (float32) and, per layer, each request's
    k (after rope) and v at ``kv_positions`` [B, T, KH, d] (float32; none
    where ``kv_positions`` is None)."""
    n_layers, eps, theta = cfg["n_layers"], cfg["norm_eps"], cfg["rope_theta"]
    h_, kh, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    pr = _Products(products)
    pos_list = list(logit_positions)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    kv: List[Tuple[torch.Tensor, torch.Tensor]] = []
    with exact_float32(), torch.no_grad():
        x = w["embed"][tokens.long()].float()                   # [B, S, D]
        for li in range(n_layers):
            p = {k: t[li] for k, t in _layer(w).items()}
            h = rms(x, p["norm1"], eps)
            q = pr.linear(h, p["wq"].reshape(h.shape[-1], -1))
            k = pr.linear(h, p["wk"].reshape(h.shape[-1], -1))
            v = pr.linear(h, p["wv"].reshape(h.shape[-1], -1))
            q = pr.heads(rope(q.view(b * s, h_, d), positions.repeat(b),
                              theta)).view(b, s, h_, d)
            k = pr.heads(rope(k.view(b * s, kh, d), positions.repeat(b),
                              theta)).view(b, s, kh, d)
            v = pr.heads(v.view(b, s, kh, d))
            if kv_positions is not None:
                kv.append((k[:, kv_positions], v[:, kv_positions]))
            o = torch.stack([causal_attention(q[r], k[r], v[r])
                             for r in range(b)]).reshape(b, s, h_ * d)
            del q, k, v
            x = x + pr.linear(o, p["wo"].reshape(h_ * d, -1))
            h = rms(x, p["norm2"], eps)
            gate = torch.nn.functional.silu(pr.linear(h, p["wg"]))
            x = x + pr.linear(gate * pr.linear(h, p["wi"]), p["mo"])
            del h, gate
        xf = rms(x[:, pos_list], w["final_norm"], eps)
        logits = pr.linear(xf, w["unembed"])
    return logits, kv


def _layer(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"norm1": w["layers.norm1"], "wq": w["layers.attn.wq"],
            "wk": w["layers.attn.wk"], "wv": w["layers.attn.wv"],
            "wo": w["layers.attn.wo"], "norm2": w["layers.norm2"],
            "wi": w["layers.mlp.wi"], "wg": w["layers.mlp.wg"],
            "mo": w["layers.mlp.wo"]}
