"""Frozen operation and byte counts of the benchmark's own shapes, and the
table of peaks they are held against.

Nothing here reads the program: each count is worked out from the shapes
that a configuration file and a traffic file give, so a later change to
the program's own cost functions moves none of them. Each count is the
work the problem needs (each input byte read once, each output byte
written once, the FLOPs of the mathematics), whatever kernels compute it.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional

PEAKS_FILE = pathlib.Path(__file__).with_name("peaks.json")

BF16 = 2
F32 = 4


def peaks(card: str) -> Optional[dict]:
    """The peak row of ``card`` (its name as
    ``torch.cuda.get_device_name`` gives it), or None where the table has
    none: a share is then not given."""
    return json.loads(PEAKS_FILE.read_text())["cards"].get(card)


# ---------------------------------------------------------------------------
# Jacobi3D: the 7-point stencil (six neighbours averaged)
# ---------------------------------------------------------------------------

def stencil_sweep_bytes(n: int, dtype_bytes: int = F32) -> int:
    """Bytes one sweep of an n^3 domain needs: every cell read once and
    written once."""
    return 2 * n ** 3 * dtype_bytes


def stencil_chunk_bytes(shape, dtype_bytes: int = F32) -> int:
    """Bytes one chunk update needs: the chunk read once, its six face
    halos read once, the chunk written once."""
    x, y, z = shape
    return (2 * x * y * z + 2 * (y * z + x * z + x * y)) * dtype_bytes


def chunk_shape(n: int, chunks: int):
    """The chunk of an n^3 domain cut into ``chunks`` equal blocks, halving
    the longest axis first (8 chunks of 768^3: 384^3)."""
    shape = [n, n, n]
    while chunks > 1:
        axis = shape.index(max(shape))
        shape[axis] //= 2
        chunks //= 2
    return tuple(shape)


# ---------------------------------------------------------------------------
# Dense decoder-only transformer (GQA, gated MLP, untied unembedding)
# ---------------------------------------------------------------------------

def layer_linear_params(cfg: dict) -> int:
    """Weights of one layer's products: q, k, v, o and the gated MLP."""
    d, h, kh, hd, ff = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                        cfg["head_dim"], cfg["d_ff"])
    return d * h * hd + 2 * d * kh * hd + h * hd * d + 3 * d * ff


def linear_params(cfg: dict) -> int:
    """Weights of every layer's products (8.30e9 for yi-9b)."""
    return cfg["n_layers"] * layer_linear_params(cfg)


def causal_attention_flops(batch: int, seq: int, heads: int,
                           head_dim: int) -> int:
    """FLOPs of one causal self-attention over ``seq`` positions: query i
    meets keys 0..i, each pair a dot product of q and k and one of p and v
    (2 FLOPs a multiply-add)."""
    pairs = seq * (seq + 1) // 2
    return 4 * batch * heads * head_dim * pairs


def prefill_flops(cfg: dict, batch: int, seq: int) -> int:
    """FLOPs of one prefill: every layer's products on every token, the
    causal attention of every layer, and the unembedding of the last
    position (the one the prefill returns)."""
    tokens = batch * seq
    return (2 * linear_params(cfg) * tokens
            + cfg["n_layers"] * causal_attention_flops(
                batch, seq, cfg["n_heads"], cfg["head_dim"])
            + 2 * cfg["d_model"] * cfg["vocab"] * batch)


def decode_step_flops(cfg: dict, batch: int, context: int) -> int:
    """FLOPs of one greedy decode step with ``context`` positions in the
    cache after its write: the products and the unembedding on each
    request's token, attention over the context."""
    return (2 * (linear_params(cfg) + cfg["d_model"] * cfg["vocab"]) * batch
            + 4 * batch * cfg["n_heads"] * cfg["head_dim"] * context
            * cfg["n_layers"])


def kv_bytes_per_position(cfg: dict, batch: int) -> int:
    """Cache bytes of one position of every request, every layer, K and
    V, in bfloat16."""
    return 2 * batch * cfg["n_kv_heads"] * cfg["head_dim"] * BF16 \
        * cfg["n_layers"]


def decode_step_bytes(cfg: dict, batch: int, context: int) -> int:
    """Bytes one decode step needs: every product weight and the
    unembedding read once, the batch's embedding rows, the cache's
    ``context`` positions read and the new position written."""
    weights = (linear_params(cfg) + cfg["d_model"] * cfg["vocab"]) * BF16
    rows = batch * cfg["d_model"] * BF16
    norms = (2 * cfg["n_layers"] + 1) * cfg["d_model"] * F32
    kv = kv_bytes_per_position(cfg, batch)
    return weights + rows + norms + kv * context + kv


def decode_generation_bound_s(cfg: dict, batch: int, prompt: int,
                              steps: int, peak: dict) -> float:
    """Least time of a generation of ``steps`` decode steps after a
    prompt of ``prompt`` positions: each step the larger of its FLOPs over
    the bf16 peak and its bytes over the memory bandwidth."""
    total = 0.0
    for i in range(steps):
        ctx = prompt + i + 1
        total += max(decode_step_flops(cfg, batch, ctx) / peak["bf16_flop_s"],
                     decode_step_bytes(cfg, batch, ctx) / peak["hbm_bytes_s"])
    return total
