"""Weights drawn by the benchmark from ``--seed``, on the device, in the
type they are served in, one call a leaf (every layer's leaf in one
stacked tensor). The program and the reference get the same tensors: the
program's parameter tree is filled from them by leaf name.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def dense_lm_shapes(cfg: dict) -> Dict[str, tuple]:
    """Leaf name -> (shape, std, dtype name) of a dense decoder-only model:
    products at 1/sqrt(fan-in), norms around 1 (float32)."""
    n, d, h, kh, hd, f, v = (cfg["n_layers"], cfg["d_model"], cfg["n_heads"],
                             cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"],
                             cfg["vocab"])
    dt = cfg["dtype"]
    return {
        "embed": ((v, d), 1.0, dt),
        "final_norm": ((d,), 0.1, "float32"),
        "unembed": ((d, v), 1 / math.sqrt(d), dt),
        "layers.norm1": ((n, d), 0.1, "float32"),
        "layers.attn.wq": ((n, d, h, hd), 1 / math.sqrt(d), dt),
        "layers.attn.wk": ((n, d, kh, hd), 1 / math.sqrt(d), dt),
        "layers.attn.wv": ((n, d, kh, hd), 1 / math.sqrt(d), dt),
        "layers.attn.wo": ((n, h, hd, d), 1 / math.sqrt(h * hd), dt),
        "layers.norm2": ((n, d), 0.1, "float32"),
        "layers.mlp.wi": ((n, d, f), 1 / math.sqrt(d), dt),
        "layers.mlp.wg": ((n, d, f), 1 / math.sqrt(d), dt),
        "layers.mlp.wo": ((n, f, d), 1 / math.sqrt(f), dt),
    }


def draw(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``shapes`` from one generator seeded with ``seed``: a
    product's leaf normal with its std; a norm's 1 + its std times a
    normal, so that each norm's weights matter."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, (shape, std, dtype) in shapes.items():
        t = torch.randn(shape, generator=gen, dtype=getattr(torch, dtype),
                        device=device)
        t.mul_(std)
        if name.endswith("norm") or ".norm" in name:
            t.add_(1.0)
        out[name] = t
    return out


def into_tree(w: Dict[str, torch.Tensor], abstract: dict,
              prefix: str = "") -> dict:
    """The program's parameter tree (``abstract``: its leaves' names,
    shapes and types, as meta tensors) filled with the drawn leaves of the
    same name. Raises where a name, shape or type differs."""
    tree = {}
    for key, val in abstract.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            tree[key] = into_tree(w, val, name + ".")
            continue
        got = w.get(name)
        if got is None or tuple(got.shape) != tuple(val.shape) \
                or got.dtype != val.dtype:
            raise ValueError(
                f"leaf {name}: the program wants {tuple(val.shape)} "
                f"{val.dtype}, the benchmark drew "
                f"{None if got is None else (tuple(got.shape), got.dtype)}")
        tree[key] = got
    if not prefix:
        missing = set(w) - set(_names(abstract))
        if missing:
            raise ValueError(f"drawn leaves the program has no place for: "
                             f"{sorted(missing)}")
    return tree


def _names(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _names(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"
