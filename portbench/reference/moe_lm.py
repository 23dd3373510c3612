"""Plain reference of OLMoE-1B-7B-0924 (arXiv:2409.02060,
https://huggingface.co/allenai/OLMoE-1B-7B-0924): token embedding; per
layer a pre-norm attention whose projected queries and keys are each
RMS-normed over their whole width before rotary positions (QK-norm), and a
pre-norm routed mixture of SwiGLU experts, each added to the residual
stream; a final norm and an untied unembedding.

    h = rms(x) * g1
    q = rms_{H d}(h Wq) * gq;  k = rms_{KH d}(h Wk) * gk;  v = h Wv
    q, k = rope(q), rope(k)
    x = x + softmax(q k^T / sqrt(d) + causal) v Wo
    h = rms(x) * g2;  p = softmax(h Wr) over the E experts
    (w_i, e_i) = the top k of p, not renormalised
    x = x + sum_i w_i (silu(h Wg_{e_i}) * (h Wi_{e_i})) Wo_{e_i}
    logits = (rms(x) * g) U

RoPE, the causal attention, the norms (eps from the configuration) and
the float8 control are ``dense_lm``'s. Float32 throughout, with TF32 off,
layer by layer (each layer's weights cast once), so that it fits beside
the served weights. Each expert computes only the rows routed to it, and
each row's k outputs are added to it weighted, in expert order.
``products="fp8"`` is the control: every product's operands rounded to
float8 e4m3 as ``dense_lm`` rounds them, but for the router's weights,
which the configuration keeps in float32 (its input rows are rounded).

Departures from the published model: the weights are the benchmark's,
drawn from the seed, not the trained ones; the router's top k is
``torch.topk``'s, whose order among exactly equal probabilities is not
defined (the published code's is ``torch.topk`` too); there is no
load-balance or router z-loss, which only training reads; nothing else.

Takes the weights as the benchmark draws them (``kinds/
moe_prefill_batches.py``): ``embed`` [V, D], ``final_norm`` [D],
``unembed`` [D, V], and per layer stacked ``layers.norm1`` [L, D],
``layers.attn.wq`` [L, D, H, d], ``wk``, ``wv`` [L, D, KH, d], ``wo``
[L, H, d, D], ``q_norm`` [L, H d], ``k_norm`` [L, KH d],
``layers.norm2``, ``layers.moe.router`` [L, D, E] (float32),
``wi``, ``wg`` [L, E, D, F], ``wo`` [L, E, F, D]. Imports nothing but
torch and ``dense_lm``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from portbench.reference.dense_lm import (_Products, causal_attention,
                                          exact_float32, rms, rope)

# the 8th and 9th probabilities of a row lie within this share of the 8th:
# a near tie, which rounding can reorder
NEAR_TIE = 2.0 ** -8


def forward(w: Dict[str, torch.Tensor], cfg: dict, tokens: torch.Tensor,
            logit_positions: Iterable[int], *, products: str = "fp32",
            kv_positions: Optional[slice] = None,
            stats: Optional[dict] = None
            ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Run ``tokens`` [B, S] through the model. Returns the logits at
    ``logit_positions`` [B, P, V] (float32) and, per layer, each request's
    k (after QK-norm and rope) and v at ``kv_positions`` [B, T, KH, d]
    (float32; none where ``kv_positions`` is None). ``stats`` (a dict)
    gains ``rows``, the (position, layer) rows routed, and ``near_ties``,
    those whose k-th and (k+1)-th probabilities lie within ``NEAR_TIE`` of
    the k-th."""
    n_layers, eps, theta = cfg["n_layers"], cfg["norm_eps"], cfg["rope_theta"]
    h_, kh, d = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    pr = _Products(products)
    pos_list = list(logit_positions)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).repeat(b)
    kv: List[Tuple[torch.Tensor, torch.Tensor]] = []
    with exact_float32(), torch.no_grad():
        x = w["embed"][tokens.long()].float()                   # [B, S, D]
        for li in range(n_layers):
            p = {k: t[li] for k, t in w.items() if k.startswith("layers.")}
            h = rms(x, p["layers.norm1"], eps)
            dm = h.shape[-1]
            q = rms(pr.linear(h, p["layers.attn.wq"].reshape(dm, -1)),
                    p["layers.attn.q_norm"], eps)
            k = rms(pr.linear(h, p["layers.attn.wk"].reshape(dm, -1)),
                    p["layers.attn.k_norm"], eps)
            v = pr.linear(h, p["layers.attn.wv"].reshape(dm, -1))
            q = pr.heads(rope(q.view(b * s, h_, d), positions,
                              theta)).view(b, s, h_, d)
            k = pr.heads(rope(k.view(b * s, kh, d), positions,
                              theta)).view(b, s, kh, d)
            v = pr.heads(v.view(b, s, kh, d))
            if kv_positions is not None:
                kv.append((k[:, kv_positions], v[:, kv_positions]))
            o = torch.stack([causal_attention(q[r], k[r], v[r])
                             for r in range(b)]).reshape(b, s, h_ * d)
            del q, k, v
            x = x + pr.linear(o, p["layers.attn.wo"].reshape(h_ * d, -1))
            h = rms(x, p["layers.norm2"], eps).view(b * s, dm)
            y = experts(h, p, cfg, pr, stats)
            x = x + y.view(b, s, dm)
            del h, y
        xf = rms(x[:, pos_list], w["final_norm"], eps)
        logits = pr.linear(xf, w["unembed"])
    return logits, kv


def experts(h: torch.Tensor, p: Dict[str, torch.Tensor], cfg: dict,
            pr: _Products, stats: Optional[dict] = None) -> torch.Tensor:
    """One layer's routed experts on the normed rows h [T, D] (float32):
    the top ``cfg["top_k"]`` of the router's softmax, unrenormalised, each
    expert on its own rows."""
    k = cfg["top_k"]
    probs = torch.softmax(pr.heads(h) @ p["layers.moe.router"].float(), -1)
    top, idx = probs.topk(k + 1, dim=-1)
    if stats is not None:
        near = (top[:, k - 1] - top[:, k]) <= NEAR_TIE * top[:, k - 1]
        stats["rows"] = stats.get("rows", 0) + h.shape[0]
        stats["near_ties"] = stats.get("near_ties", 0) + int(near.sum())
    idx = idx[:, :k]
    weights = probs.gather(1, idx)
    out = torch.zeros_like(h)
    for e in range(cfg["num_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        he = h[rows]
        up = torch.nn.functional.silu(pr.linear(he, p["layers.moe.wg"][e])) \
            * pr.linear(he, p["layers.moe.wi"][e])
        out.index_add_(0, rows, pr.linear(up, p["layers.moe.wo"][e])
                       * weights[rows, slot, None])
    return out
