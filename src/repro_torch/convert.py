"""State carried between numpy and torch.

``to_torch`` and ``to_numpy`` move numpy arrays (a Jacobi domain, DGEMM
operands, hetero-object values) into and out of torch tensors with the
dtype mapped both ways. ``lm_from_jax`` and ``cache_from_jax`` carry the
JAX package's model weights and caches (KV, or SSD conv and state), handed
over as trees of numpy arrays, into the port's layout.

bfloat16 has no numpy dtype of its own. Where a numpy bfloat16 exists (it is
registered by whichever package provides it, e.g. the one JAX ships with), it
is recognised by its name and its bits travel through a ``uint16`` view. No
such package is imported here.
"""
from __future__ import annotations

import numpy as np
import torch

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}
_TORCH_TO_NP = {v: k for k, v in _NP_TO_TORCH.items()}


def _is_bf16(dtype: np.dtype) -> bool:
    return dtype.name == "bfloat16"


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or of a torch dtype, unchanged)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dtype = np.dtype(dtype)
    if _is_bf16(dtype):
        return torch.bfloat16
    try:
        return _NP_TO_TORCH[dtype]
    except KeyError:
        raise TypeError(f"no torch dtype for numpy {dtype}") from None


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (or of a numpy dtype, unchanged).
    ``np.dtype(torch.float32)`` raises, so every place that reads the dtype
    of a device tensor goes through here."""
    if not isinstance(dtype, torch.dtype):
        return np.dtype(dtype)
    if dtype == torch.bfloat16:
        try:
            return np.dtype("bfloat16")
        except TypeError:
            raise TypeError("torch.bfloat16 has no numpy counterpart: numpy "
                            "has no bfloat16 dtype registered in this "
                            "process") from None
    try:
        return _TORCH_TO_NP[dtype]
    except KeyError:
        raise TypeError(f"no numpy dtype for torch {dtype}") from None


def to_torch(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """A tensor on ``device`` holding ``arr``'s values. On the CPU the result
    may alias ``arr``; on any other device it is a copy."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:      # torch tensors are always writable
        arr = arr.copy()
    if _is_bf16(arr.dtype):
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A numpy array holding ``t``'s values (a copy unless ``t`` is a
    contiguous CPU tensor, whose memory it then shares)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(numpy_dtype(t.dtype))
    return t.numpy()


# block layouts the port runs: global attention + MLP, and Mamba-2 SSD
_BLOCK_KEYS = ({"norm1", "attn", "norm2", "mlp"}, {"norm1", "ssd"})
_CACHE_KEYS = ({"k", "v"}, {"conv", "state"})


def lm_from_jax(tree: dict, device="cpu"):
    """The port's weights (a ``ParamTree``) of a JAX decoder-only LM.

    ``tree`` is the JAX package's ``unbox``ed parameter tree with numpy
    leaves: ``embed``, ``final_norm``, ``unembed`` (absent when tied) and
    ``periods``, a one-element tuple (the period of these stacks is one
    layer) whose block leaves carry the leading layer axis: ``norm1``,
    ``attn``, ``norm2``, ``mlp`` for a dense block, ``norm1`` and ``ssd``
    (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``,
    ``norm``, ``out_proj``) for an SSD block. Names and layouts map one to
    one; values keep their dtype."""
    from repro_torch.models.transformer import ParamTree
    extra = sorted(set(tree) - {"embed", "final_norm", "unembed", "periods"})
    if extra or len(tree["periods"]) != 1:
        raise NotImplementedError(
            f"only one-layer periods convert (found {extra} and "
            f"{len(tree['periods'])} period blocks); see ROADMAP.md")
    block = tree["periods"][0]
    if set(block) not in _BLOCK_KEYS:
        raise NotImplementedError(
            f"block layout {sorted(block)} is not ported; the port runs "
            f"{[sorted(k) for k in _BLOCK_KEYS]} (see ROADMAP.md)")

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return to_torch(np.asarray(node), device)

    params = {k: conv(tree[k]) for k in ("embed", "final_norm", "unembed")
              if k in tree}
    params["layers"] = conv(block)
    return ParamTree(params)


def cache_from_jax(tree: dict, device="cpu") -> dict:
    """The port's cache from the JAX package's cache tree
    ``{"periods": (block,)}``: ``{"k", "v"}: [L, B, T, KH, D]`` for a KV
    cache, ``{"conv": [L, B, W-1, C], "state": [L, B, H, P, N]}`` for an SSD
    cache."""
    (block,) = tree["periods"]
    if set(block) not in _CACHE_KEYS:
        raise NotImplementedError(
            f"cache layout {sorted(block)} is not ported (see ROADMAP.md)")
    return {k: to_torch(np.asarray(block[k]), device) for k in sorted(block)}
