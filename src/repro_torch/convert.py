"""State carried between numpy and torch.

``to_torch`` and ``to_numpy`` move numpy arrays (a Jacobi domain, DGEMM
operands, hetero-object values) into and out of torch tensors with the
dtype mapped both ways. ``lm_from_jax`` and ``cache_from_jax`` carry the
JAX package's model weights and caches (KV, SSD and RG-LRU conv and state,
or the encoder-decoder's self and cross KV), handed over as trees of numpy
arrays, into the port's layout (``lm_tree_from_jax`` and
``cache_tree_from_jax`` map any leaves so: logical axes, shardings), and
``lm_placed_from_jax`` places such weights onto a mesh
(``distributed.spmd.place`` by ``launch.mesh.param_specs``);
``train_state_from_jax`` a JAX
``TrainState`` (weights, AdamW moments and master, step, error-feedback
residuals), and ``train_state_to_numpy`` the port's back to numpy.

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
    """A tensor on ``device`` holding ``arr``'s values, of its shape (a 0-d
    array gives a 0-d tensor). On the CPU the result may alias ``arr``; on
    any other device it is a copy."""
    # ascontiguousarray returns at least one dimension: reshape back
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
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


# block layouts the port runs: attention + MLP, Mamba-2 SSD, RG-LRU + MLP,
# attention + MoE
_BLOCK_KEYS = ({"norm1", "attn", "norm2", "mlp"}, {"norm1", "ssd"},
               {"norm1", "rglru", "norm2", "mlp"},
               {"norm1", "attn", "norm2", "moe"})
# an MoE subtree: the router and experts, optionally the gate and a shared
# MLP
_MOE_KEYS = ({"router", "wi", "wo"}, {"router", "wi", "wo", "wg", "shared"})
_MLP_KEYS = ({"wi", "wo"}, {"wi", "wo", "wg"})
# KV caches; SSD and RG-LRU caches (conv inputs, float32 state)
_CACHE_KEYS = ({"k", "v"}, {"conv", "state"})
# the encoder-decoder (models.encdec): its top level and its two stacks;
# the attention subtrees
_ENCDEC_KEYS = {"embed", "pos_embed", "enc_final_norm", "final_norm",
                "unembed", "encoder", "decoder"}
_ENCDEC_STACKS = {"encoder": {"norm1", "attn", "norm2", "mlp"},
                  "decoder": {"norm1", "self_attn", "norm_x", "cross_attn",
                              "norm2", "mlp"}}
_ATTN_KEYS = {"wq", "wk", "wv", "wo"}


def _blocks_of(tree: dict, layouts, what: str, cache: bool) -> dict:
    """The JAX tree's blocks (``periods``, a tuple of one block per
    position of the period, and ``rem_{i}``) by their path in the port's
    tree (``models.transformer.block_paths``): parameter paths, or cache
    paths where ``cache``."""
    from repro_torch.models.transformer import block_paths
    periods = list(tree.get("periods", ()))
    rems = sorted((k for k in tree if k.startswith("rem_")),
                  key=lambda k: int(k[4:]))
    blocks = periods + [tree[k] for k in rems]
    for block in blocks:
        if set(block) not in layouts or not _moe_ported(block.get("moe")):
            raise NotImplementedError(
                f"{what} layout {sorted(block)} is not ported; the port runs "
                f"{[sorted(k) for k in layouts]} (see ROADMAP.md)")
    paths = block_paths(len(periods), len(rems))
    return {p[1] if cache else p[0]: b for p, b in zip(paths, blocks,
                                                       strict=True)}


def _moe_ported(moe) -> bool:
    """Whether an MoE subtree (None: none) has a layout the port runs."""
    if moe is None:
        return True
    lo, hi = _MOE_KEYS
    return lo <= set(moe) <= hi and (
        "shared" not in moe or set(moe["shared"]) in _MLP_KEYS)


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node)


def _encdec_from_jax(tree: dict, fn):
    """The encoder-decoder's tree, checked against its layout; its leaves
    map one to one (the stacks keep their leading layer axis)."""
    for stack, keys in _ENCDEC_STACKS.items():
        block = tree[stack]
        if set(block) != keys or set(block["mlp"]) not in _MLP_KEYS or any(
                set(block[k]) != _ATTN_KEYS for k in keys
                if k.endswith("attn")):
            raise NotImplementedError(
                f"{stack} layout {sorted(block)} is not ported; the port "
                f"runs {sorted(keys)} (see ROADMAP.md)")
    return _map(tree, fn)


def lm_tree_from_jax(tree: dict, fn=lambda leaf: leaf) -> dict:
    """A JAX parameter-shaped tree (weights, logical axes, shardings) in
    the port's layout (``lm_from_jax``'s mapping), each leaf ``fn(leaf)``:
    a nested dict."""
    from repro_torch.models.transformer import put_path
    if set(tree) == _ENCDEC_KEYS:
        return _encdec_from_jax(tree, fn)
    extra = sorted(set(tree) - {"embed", "final_norm", "unembed", "periods"}
                   - {k for k in tree if k.startswith("rem_")})
    if extra:
        raise NotImplementedError(
            f"parameters {extra} are not ported (see ROADMAP.md)")
    params = {k: _map(tree[k], fn)
              for k in ("embed", "final_norm", "unembed") if k in tree}
    for path, block in _blocks_of(tree, _BLOCK_KEYS, "block",
                                  cache=False).items():
        put_path(params, path, _map(block, fn))
    return params


def cache_tree_from_jax(tree: dict, fn=lambda leaf: leaf) -> dict:
    """A JAX cache-shaped tree in the port's layout (``cache_from_jax``'s
    mapping), each leaf ``fn(leaf)``."""
    from repro_torch.models.transformer import put_path
    dec = tree.get("decoder")
    if set(tree) == {"decoder"} and isinstance(dec, dict) \
            and set(dec) == {"self", "cross"} \
            and all(set(dec[k]) == {"k", "v"} for k in dec):
        return _map(tree, fn)
    out: dict = {}
    for path, block in _blocks_of(tree, _CACHE_KEYS, "cache",
                                  cache=True).items():
        put_path(out, path, _map(block, fn))
    return out


def _tensor(device):
    return lambda leaf: to_torch(np.asarray(leaf), device)


def lm_from_jax(tree: dict, device="cpu"):
    """The port's weights (a ``ParamTree``) of a JAX decoder-only LM.

    ``tree`` is the JAX package's ``unbox``ed parameter tree with numpy
    leaves: ``embed``, ``final_norm``, ``unembed`` (absent when tied),
    ``periods``, a tuple of one block per position of the layer pattern
    whose leaves carry the leading period axis, and ``rem_{i}`` blocks.
    Blocks are ``norm1``, ``attn``, ``norm2``, ``mlp`` for attention,
    ``norm1`` and ``ssd`` (``in_proj``, ``conv_w``, ``conv_b``, ``A_log``,
    ``D``, ``dt_bias``, ``norm``, ``out_proj``) for SSD, ``norm1``,
    ``rglru`` (``in_x``, ``in_gate``, ``conv_w``, ``conv_b``, ``w_r``,
    ``b_r``, ``w_i``, ``b_i``, ``lam``, ``out``), ``norm2``, ``mlp`` for
    RG-LRU, ``norm1``, ``attn``, ``norm2``, ``moe`` (``router``, ``wi``,
    ``wo``, optionally ``wg`` and ``shared.{wi,wo[,wg]}``) for attention +
    MoE. An encoder-decoder's tree (``models.encdec``: ``embed``,
    ``pos_embed``, ``enc_final_norm``, ``final_norm``, ``unembed`` and the
    layer-stacked ``encoder`` and ``decoder``) crosses as it is. Names and
    layouts map one to one; values keep their dtype (float32 leaves, the
    norms and the MoE router among them, stay float32 under bf16
    weights)."""
    from repro_torch.models.transformer import ParamTree
    return ParamTree(lm_tree_from_jax(tree, _tensor(device)))


def lm_placed_from_jax(tree: dict, model, mesh):
    """The JAX package's weights (``lm_from_jax``'s input) placed on
    ``mesh`` by ``launch.mesh.param_specs`` of ``model.axes()``: a nested
    dict of ``spmd.Sharded``, each leaf moved onto the shards' devices
    from the host one at a time."""
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import param_specs
    params = lm_tree_from_jax(tree, _tensor("cpu"))
    return spmd.place(params, param_specs(params, model.axes(), mesh),
                      consume=True)


def cache_from_jax(tree: dict, device="cpu") -> dict:
    """The port's cache from the JAX package's cache tree (``periods``, a
    tuple of one block per position, and ``rem_{i}``): for a one-layer
    period ``{"k", "v"}: [L, B, T, KH, D]`` for a KV cache, ``{"conv": [L,
    B, W-1, C], "state": [L, B, H, P, N]}`` for an SSD cache; for a longer
    one the same blocks under ``periods`` ("0", "1", ...) and ``rem_{i}``,
    an RG-LRU layer's as ``{"conv": [B, K-1, W], "state": [B, W]}`` (with
    the leading period axis under ``periods``). An encoder-decoder's
    ``{"decoder": {"self": {"k", "v"}, "cross": {"k", "v"}}}`` crosses as it
    is. Values keep their dtype."""
    return cache_tree_from_jax(tree, _tensor(device))


def _plain(tree: dict, device) -> dict:
    """A JAX parameter-shaped tree of numpy leaves as the port's nested
    dict of plain tensors (``lm_from_jax``'s layout)."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda p: p.detach(), lm_from_jax(tree, device).tree())


def train_state_from_jax(state, device="cpu"):
    """The port's ``train.TrainState`` of a JAX ``TrainState`` whose leaves
    are numpy arrays (``jax.tree.map(np.asarray, state)``): ``params``,
    ``opt.m``, ``opt.v`` and ``opt.master`` each through ``lm_from_jax``'s
    layout, ``opt.step`` an int32 scalar tensor, and ``ef`` (the
    error-feedback residuals, a leading pod axis on every leaf) likewise
    where it is not None. Values keep their dtype."""
    from repro_torch.train.optimizer import AdamWState, TrainState
    opt = state.opt
    return TrainState(
        params=_plain(state.params, device),
        opt=AdamWState(
            step=to_torch(np.asarray(opt.step, dtype=np.int32), device),
            m=_plain(opt.m, device), v=_plain(opt.v, device),
            master=_plain(opt.master, device)),
        ef=None if state.ef is None else _plain(state.ef, device))


def train_state_placed_from_jax(state, model, mesh, zero: bool = False):
    """A JAX ``TrainState`` of numpy leaves (``train_state_from_jax``'s
    input, its residuals ``ef`` included) placed on ``mesh`` by
    ``launch.mesh.place_train_state`` (``zero``: the moments and master
    split over ``data`` as well): each leaf moved from the host onto the
    shards' devices one at a time."""
    from repro_torch.launch.mesh import place_train_state
    return place_train_state(train_state_from_jax(state, "cpu"),
                             model.axes(), mesh, consume=True, zero=zero)


def train_state_to_numpy(state):
    """The port's ``TrainState`` with every tensor leaf as a numpy array
    (``to_numpy``; bfloat16 leaves need a numpy bfloat16), in the port's
    layout."""
    from repro_torch.train.optimizer import AdamWState, TrainState, tree_map

    def conv(tree):
        return None if tree is None else tree_map(to_numpy, tree)
    opt = state.opt
    return TrainState(
        params=conv(state.params),
        opt=AdamWState(step=to_numpy(opt.step), m=conv(opt.m),
                       v=conv(opt.v), master=conv(opt.master)),
        ef=conv(state.ef))
