"""Mesh construction and the shardings of program states
(``repro/launch/mesh.py`` at the same path), over the port's
single-controller ``Mesh``: the production and smoke meshes, and the
parameter, optimizer-state, batch and cache specs, each a tree of
``spmd.NamedSharding`` (the batch specs are ``P``s, as in the JAX
package) that ``spmd.place`` puts a tree on. The rules are JAX's line for
line, the divisibility fallback included. ``place_train_state`` puts a
``TrainState`` on a mesh by ``opt_specs``: the moments and master by
their parameters' specs, as the JAX driver's state lies under GSPMD, or
with ``zero=True`` split over the data axis as well (ZeRO-1, as the JAX
dry-run places them); the error-feedback residuals of the compressed
cross-pod step lie over ``pod`` by their leading dim and as their
parameters inside a pod (``ef_specs``).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.spmd import P, Mesh, NamedSharding
from repro_torch.distributed.spmd import _axes as spmd_axes
from repro_torch.models.sharding import resolve_spec


def _cards(n: int, what: str) -> list:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"{what} needs {n} CUDA cards, found {have}: "
                           f"pass devices= to place shards on fewer cards "
                           f"or on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None,
                         data: int = 1) -> Mesh:
    """The serving and training mesh of one node: ``("data", "model") =
    (data, n / data)`` over its n cards (every CUDA card by default, or
    ``devices``, which may repeat one), ``data`` 1 unless asked, so that
    tensor and expert parallelism stay inside the node's NVLink domain;
    with ``multi_pod``, ``("pod", "data", "model") = (2, data, n / (2 *
    data))``. The JAX package's (16, 16) and (2, 16, 16) name 256 and 512
    TPU chips, its ``pod`` axis an axis of one GSPMD mesh; here ``pod`` is
    an axis of the single-controller ``Mesh`` over one node's cards, as
    every other axis is. A mesh across processes is not ported
    (ROADMAP.md)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = _cards(max(n, 1), "the production mesh")
    pods = 2 if multi_pod else 1
    n = len(devices)
    if n % (pods * data):
        raise ValueError(f"{n} devices do not split into {pods} pod(s) "
                         f"of data {data}: a multi-pod mesh needs an even "
                         f"number of them" if multi_pod else
                         f"{n} devices do not split over data {data}")
    if multi_pod:
        return Mesh(devices, (2, data, n // (2 * data)),
                    ("pod", "data", "model"))
    return Mesh(devices, (data, n // data), ("data", "model"))


def make_smoke_mesh(data: int = 1, model: int = 1,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh. ``devices`` lists each shard's device and
    may repeat one (``[torch.device("cpu")] * 4``, four shards on one
    card); by default the first ``data * model`` CUDA cards, one shard
    each."""
    n = data * model
    if devices is None:
        devices = _cards(n, f"a {data}x{model} mesh")
    return Mesh(devices, (data, model), ("data", "model"))


# ---------------------------------------------------------------------------
# Spec builders
# ---------------------------------------------------------------------------

def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _map(fn, tree, axes_tree):
    """``fn(leaf, axes)`` over a nested dict and its axes tree (tuples of
    logical axis names at the leaves)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, axes_tree[k]) for k, v in tree.items()}
    if not _is_axes(axes_tree):
        raise ValueError(f"no logical axes for a leaf: {axes_tree!r}")
    return fn(tree, axes_tree)


def param_specs(abs_params, axes_tree, mesh: Mesh):
    """NamedShardings for a parameter tree (leaves with a ``.shape``:
    tensors, meta tensors or ``Sharded``) given its logical axes tree
    (``Model.axes()``)."""
    return _map(lambda x, ax: NamedSharding(
        mesh, resolve_spec(ax, shape=x.shape, mesh=mesh)),
        abs_params, axes_tree)


def zero_shard(spec: P, shape: Tuple[int, ...], mesh: Mesh,
               zero_axes: Tuple[str, ...] = ("data",)) -> P:
    """Add ZeRO-1 sharding: place ``zero_axes`` on the first unsharded dim
    whose size divides. Leaves the spec unchanged if nothing fits. Reads
    only ``mesh.shape``."""
    za = tuple(a for a in zero_axes if a in mesh.shape)
    if not za:
        return spec
    zsize = math.prod(mesh.shape[a] for a in za)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for p in parts:
        if p is None:
            continue
        used.update(p if isinstance(p, tuple) else (p,))
    if any(a in used for a in za):
        return spec
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s % zsize == 0 and s > 0:
            parts[i] = za if len(za) > 1 else za[0]
            return P(*parts)
    return spec


def ef_specs(abs_ef, axes_tree, mesh: Mesh):
    """Shardings for the error-feedback residuals of the compressed
    cross-pod step (``TrainState.ef``: [pods, ...] a leaf): the leading
    dim over ``pod`` (replicated on a mesh without one), the rest as the
    parameter's spec, so that each shard holds its pod's residual of its
    parameter block."""
    lead = "pod" if "pod" in mesh.shape else None
    return _map(lambda x, ax: NamedSharding(mesh, P(lead, *resolve_spec(
        ax, shape=tuple(x.shape[1:]), mesh=mesh))), abs_ef, axes_tree)


def opt_specs(abs_state, axes_tree, mesh: Mesh, zero: bool = True):
    """Shardings for a ``train.TrainState``: params get their natural
    specs; m, v and master additionally ZeRO-1 sharding over the data
    axis; the step is replicated; residuals, where the state has them, by
    ``ef_specs``."""
    from repro_torch.train.optimizer import AdamWState, TrainState
    p_specs = param_specs(abs_state.params, axes_tree, mesh)

    def zspec(x, ax):
        spec = resolve_spec(ax, shape=x.shape, mesh=mesh)
        if zero:
            spec = zero_shard(spec, tuple(x.shape), mesh)
        return NamedSharding(mesh, spec)

    opt = abs_state.opt
    ef = abs_state.ef
    return TrainState(
        params=p_specs,
        opt=AdamWState(step=NamedSharding(mesh, P()),
                       m=_map(zspec, opt.m, axes_tree),
                       v=_map(zspec, opt.v, axes_tree),
                       master=_map(zspec, opt.master, axes_tree)),
        ef=None if ef is None else ef_specs(ef, axes_tree, mesh))


def place_train_state(state, axes_tree, mesh: Mesh, *,
                      consume: bool = False, zero: bool = False):
    """A ``train.TrainState`` (plain tensors on one device, or on a meta
    device) placed on ``mesh`` by ``opt_specs(state, axes_tree, mesh,
    zero=zero)``: every leaf a ``spmd.Sharded`` whose shards each hold a
    tensor of their own (the step updates them in place), the moments and
    master laid out as their parameters (``zero``: split over ``data``
    as well), the step replicated, the residuals by ``ef_specs``. With
    ``consume`` each leaf is dropped from ``state`` as it is placed."""
    from repro_torch.distributed.spmd import place
    from repro_torch.train.optimizer import AdamWState, TrainState
    specs = opt_specs(state, axes_tree, mesh, zero=zero)

    def put(tree, sh):
        return place(tree, sh, consume=consume, share=False)
    opt = state.opt
    return TrainState(params=put(state.params, specs.params),
                      opt=AdamWState(
                          step=put({"s": opt.step}, {"s": specs.opt.step})["s"],
                          m=put(opt.m, specs.opt.m),
                          v=put(opt.v, specs.opt.v),
                          master=put(opt.master, specs.opt.master)),
                      ef=None if state.ef is None else put(state.ef,
                                                           specs.ef))


def _data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def batch_specs(shape_kind: str, mesh: Mesh, global_batch: int,
                seq_shard_kv: bool = False) -> Dict[str, P]:
    """Input specs for train, prefill and decode batches: the batch over
    the data axes where it divides them."""
    data_axes = _data_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in data_axes)
    baxes = data_axes if global_batch % dsize == 0 else None
    if baxes is not None and len(baxes) == 1:
        baxes = baxes[0]
    return {"batch": P(baxes), "scalar": P()}


def _leaves_with_path(tree, path: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_path(v, path + (k,))
        else:
            yield path + (k,), v


def cache_specs(abs_cache, mesh: Mesh, cfg, *, seq_shard: bool = False,
                seq_axis: Optional[str] = None):
    """Shardings for a cache tree in the port's layout
    (``models.transformer``: a one-layer period's stack at the root,
    longer ones under ``periods`` / ``rem_{i}``; an encoder-decoder's
    ``decoder.{self,cross}``).

    Leaf layouts (by layer kind and role):
      attn k/v   : [..., B, T, K, D]  (stacked leading layer dims optional)
      ssd conv   : [..., B, W-1, C]    (replicated over model: DP-only SSD)
      ssd state  : [..., B, H, P, N]
      rglru conv : [..., B, W-1, lru]  (lru dim shards over model)
      rglru state: [..., B, lru]
    Batch shards over the data axes when divisible; otherwise
    (``seq_shard``) the attention T dim shards over 'data' (long-context
    decode); ``seq_axis`` shards T over that axis where it is still free
    (where the batch took it, a spec would name it twice).
    """
    from repro_torch.configs.base import RGLRU, SSD

    data_axes = _data_axes(mesh)
    dsize = math.prod(mesh.shape[a] for a in data_axes)
    msize = mesh.shape.get("model", 1)
    baxes = data_axes if len(data_axes) > 1 else data_axes[0]
    period = len(cfg.layer_pattern)
    rem = tuple(cfg.layer_pattern[:cfg.n_layers % period])

    def kind_of(path) -> str:
        if path[0] == "periods":
            return cfg.layer_pattern[int(path[1])]
        if path[0].startswith("rem_"):
            return rem[int(path[0][4:])]
        if path[0] == "decoder":
            return "global_attn"     # encdec decoder self/cross caches
        return cfg.layer_pattern[0]  # a one-layer period's stack

    def leaf_spec(path, x):
        role, kind = path[-1], kind_of(path)
        shape, nd = tuple(x.shape), len(x.shape)
        parts: list = [None] * nd
        if role in ("k", "v"):
            b_dim, t_dim, k_dim = nd - 4, nd - 3, nd - 2
            if shape[b_dim] % dsize == 0:
                parts[b_dim] = baxes
            elif seq_shard and "data" in mesh.shape and \
                    shape[t_dim] % mesh.shape["data"] == 0:
                parts[t_dim] = "data"
            if seq_axis is not None and parts[t_dim] is None \
                    and seq_axis in mesh.shape \
                    and seq_axis not in spmd_axes(parts[b_dim]) \
                    and shape[t_dim] % mesh.shape[seq_axis] == 0:
                parts[t_dim] = seq_axis
            if shape[k_dim] % msize == 0 and msize > 1 \
                    and seq_axis != "model":
                parts[k_dim] = "model"
        else:
            b_dim = nd - (3 if role == "conv" else
                          4 if role == "state" and kind == SSD else 2)
            b_dim = max(b_dim, 0)
            if shape[b_dim] % dsize == 0:
                parts[b_dim] = baxes
            if kind == RGLRU and shape[-1] % msize == 0 and msize > 1 \
                    and nd - 1 != b_dim:
                parts[-1] = "model"
        return NamedSharding(mesh, P(*parts))

    out: Dict[str, Any] = {}
    for path, x in _leaves_with_path(abs_cache):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf_spec(path, x)
    return out
