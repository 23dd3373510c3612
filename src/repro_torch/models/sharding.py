"""Logical-axis sharding rules and the active mesh
(``repro/models/sharding.py`` at the same path): MaxText-style rules
mapping logical axis names to mesh axes, a no-op without a mesh, and
divisibility-aware (kv_heads=1 cannot shard 16-way).

The port shards nothing implicitly. ``resolve_spec`` gives the spec a
logical layout takes, ``named_sharding`` the mesh with it, and
``launch.mesh``'s spec builders apply them to whole trees, which
``distributed.spmd.place`` puts on the mesh. ``constrain`` lays out a
``spmd.Sharded`` value by its logical axes; it moves nothing inside a
``shard_map`` body, where the layers run on their shards' blocks and
reduce explicitly (``spmd.psum`` after a row-parallel product). Which
logical axes the body's weights are split along is decided once, by
their specs: ``split_weights`` tells the body, and the layers ask
``is_split``.

Sequence parallelism is the rule ``"act_seq": "model"`` written out in
the Megatron form. ``sequence_axis`` decides once, in the thread that
calls a step (the rules are per thread), whether the step's activations
split along the sequence: where the rule maps ``act_seq`` to the model
axis of more than one shard and the global sequence divides it, as
``resolve_spec`` requires (so decode, S = 1, never splits). The body
opens ``split_sequence`` with the answer. Between the layers each shard
then holds its slice of the sequence (the residual stream, the norms,
the residual adds); a layer gathers the whole sequence before its
column-parallel products (``seq_gather``) and its row-parallel partial
sums come back reduce-scattered along the sequence
(``spmd.psum_scatter``, in ``layers.tp_reduce``) where they were
``psum``'d. ``seq_axis_for`` re-decides inside the body for a second
sequence (the encoder's frames). The mesh
that ``use_sharding`` activates is read by the serving steps, which then
run each step as one ``shard_map`` over the placed weights and cache, and
by the modules that run explicitly over it (``models.attention.
seq_sharded_decode``, ``models.moe.moe_ep``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, FrozenSet, Optional, Sequence, Tuple, Union

from repro_torch.distributed import spmd
from repro_torch.distributed.spmd import P, Mesh, NamedSharding

MeshAxes = Union[None, str, Tuple[str, ...]]

# Default logical→mesh rules. ``data``-like axes map to all data-parallel mesh
# axes; ``model``-like axes to the tensor-parallel axis.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    # parameter axes
    "vocab": "model",
    "embed": None,
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "experts": "model",
    "expert_mlp": None,
    "lru": "model",
    # SSD inner dims stay replicated (pure DP for mamba2-370m)
    "ssm_inner": None,
    "ssm_state": None,
    "conv": None,
    "layers": None,           # stacked leading axis, never sharded
    # optimizer state extra sharding (ZeRO-1)
    "zero": "data",
    # activation axes
    "act_batch": ("pod", "data"),
    "act_seq": None,          # → "model" when sequence parallelism enabled
    "act_kv_seq": None,       # KV-cache seq axis; → "data" for long-context
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: Optional[Mesh] = None
        self.rules: Dict[str, MeshAxes] = dict(DEFAULT_RULES)
        self.split: FrozenSet[str] = frozenset()
        # storage identity of a cache block -> the axis splitting its T
        self.kv_seq: Dict[int, str] = {}
        # the mesh axis splitting the activations' sequence in a body
        self.seq: Optional[str] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_sharding(mesh: Optional[Mesh],
                 rules: Optional[Dict[str, MeshAxes]] = None):
    """Activate a mesh + logical rules in this thread."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _CTX.rules = merged
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def active_mesh() -> Optional[Mesh]:
    return _CTX.mesh


def _axis_size(mesh: Mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def resolve_spec(logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None,
                 mesh: Optional[Mesh] = None) -> P:
    """Map logical axis names to a spec under the active rules (a tuple:
    ``P``). If ``shape`` is given, drops sharding on any dim not divisible
    by its mesh axis size (e.g. kv_heads=4 over a 16-way model axis →
    replicated)."""
    mesh = mesh or _CTX.mesh
    parts = []
    used: set = set()
    for i, name in enumerate(logical_axes):
        axes = _CTX.rules.get(name) if name else None
        if axes is not None and mesh is not None:
            present = tuple(a for a in ((axes,) if isinstance(axes, str)
                                        else axes)
                            if a in mesh.shape and a not in used)
            axes = present if present else None
            if axes is not None and shape is not None:
                if shape[i] % _axis_size(mesh, axes) != 0:
                    axes = None
            if axes is not None:
                used.update(axes)
        elif mesh is None:
            axes = None
        if axes is None:
            parts.append(None)
        elif isinstance(axes, tuple) and len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(axes)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def constrain(x, *logical_axes: Optional[str]):
    """``with_sharding_constraint`` by logical axes. Without a mesh, and
    inside a ``shard_map`` body (where each shard holds its block and the
    layers reduce explicitly), ``x`` unchanged; a plain tensor is left
    where it lies too, since the port places nothing implicitly. A
    ``spmd.Sharded`` value is laid out as ``resolve_spec`` says over the
    active mesh (``spmd.reshard``: each shard slices its block where the
    spec adds an axis; the value is gathered where it drops one). The
    value itself never changes."""
    mesh = _CTX.mesh
    if mesh is None or spmd.current_mesh() is not None \
            or not isinstance(x, spmd.Sharded):
        return x
    if x.mesh is not mesh:
        raise ValueError(f"constrain: the value lies on {x.mesh}, not on "
                         f"the active {mesh}")
    return spmd.reshard(x, resolve_spec(logical_axes, shape=x.shape,
                                        mesh=mesh))


def split_axes(axes_tree, placed) -> FrozenSet[str]:
    """The logical axes (of ``axes_tree``, ``Model.axes()``) along which
    the leaves of ``placed`` (``spmd.Sharded`` or ``NamedSharding``, each
    with its ``.mesh`` and ``.spec``) are split over more than one shard.
    A layer asks by axis name, so an axis split in some leaves and not in
    others is refused."""
    seen: Dict[str, bool] = {}

    def walk(axes, leaf):
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                walk(axes[k], v)
            return
        for i, name in enumerate(axes):
            if name is None:
                continue
            part = leaf.spec[i] if i < len(leaf.spec) else None
            split = _axis_size(leaf.mesh, part) > 1
            if seen.setdefault(name, split) != split:
                raise NotImplementedError(
                    f"the logical axis {name!r} is split in some weights "
                    f"and not in others: not ported (see ROADMAP.md)")

    walk(axes_tree, placed)
    return frozenset(n for n, split in seen.items() if split)


@contextlib.contextmanager
def split_weights(split: FrozenSet[str]):
    """Opened inside a ``shard_map`` body with ``split_axes`` of its
    weights: while open, ``is_split`` answers for them in this thread."""
    prev = _CTX.split
    _CTX.split = split
    try:
        yield
    finally:
        _CTX.split = prev


def is_split(name: str) -> bool:
    """Whether the weights of the ``shard_map`` body running in this thread
    hold only their shard's slice along logical axis ``name`` (so a
    product over it is a partial sum, a lookup along it a masked one);
    False outside ``split_weights``."""
    return name in _CTX.split


@contextlib.contextmanager
def split_cache(blocks: Dict[str, Sequence]):
    """Opened inside a ``shard_map`` body whose KV cache blocks hold only
    their shard's slice of the slots (``launch.mesh.cache_specs(...,
    seq_axis=)``): ``blocks`` maps the mesh axis splitting the slots to
    the shard's blocks it splits. While open, ``kv_seq_axis`` answers for
    those blocks and every view of them (a layer's slice of a stacked
    cache), by storage identity."""
    prev = _CTX.kv_seq
    _CTX.kv_seq = {t.untyped_storage()._cdata: axis
                   for axis, ts in blocks.items() for t in ts}
    try:
        yield
    finally:
        _CTX.kv_seq = prev


def kv_seq_axis(t) -> Optional[str]:
    """The mesh axis over which the KV cache block ``t`` (or a view of it)
    holds a slice of the slots, inside a body that ``split_cache`` told;
    None for a whole block, and outside a body."""
    if not _CTX.kv_seq:
        return None
    return _CTX.kv_seq.get(t.untyped_storage()._cdata)


# the mesh axes a body's sequence may split over: the model axis, over
# which the layers' partial sums are reduced
SEQ_AXES = ("model",)


def sequence_axis(mesh: Mesh, batch: int, seq: int) -> Optional[str]:
    """The mesh axis over which a step of ``batch`` x ``seq`` tokens on
    ``mesh`` splits its activations along the sequence under the active
    rules: ``act_seq``'s axis in ``resolve_spec(("act_batch",
    "act_seq"), shape=(batch, seq))``, where it spans more than one shard;
    None otherwise. Called in the thread that runs the step, outside its
    body. An axis other than the model axis raises."""
    spec = resolve_spec(("act_batch", "act_seq"), shape=(batch, seq),
                        mesh=mesh)
    part = spec[1] if len(spec) > 1 else None
    if part is None or _axis_size(mesh, part) == 1:
        return None
    if part not in SEQ_AXES:
        raise NotImplementedError(
            f"the activations' sequence split over {part!r}: only "
            f"{SEQ_AXES} is ported (see ROADMAP.md)")
    return part


@contextlib.contextmanager
def split_sequence(axis: Optional[str]):
    """Opened inside a ``shard_map`` body with ``sequence_axis``'s answer:
    while open, the layers in this thread receive and return their
    shard's slice of the sequence along ``axis`` (none: the whole
    sequence)."""
    prev = _CTX.seq
    _CTX.seq = axis
    try:
        yield
    finally:
        _CTX.seq = prev


def seq_axis_for(length: int) -> Optional[str]:
    """The axis over which a second sequence of ``length`` positions in
    the same body (the encoder's frames) splits: the body's where
    ``length`` divides it, else None. Its layers run under
    ``split_sequence`` of the answer (and so does their recomputation in
    the backward)."""
    axis = _CTX.seq
    if axis is not None and length % spmd.axis_size(axis):
        axis = None
    return axis


def seq_axis() -> Optional[str]:
    """The mesh axis splitting the sequence of the activations the layers
    receive in this thread (``split_sequence``); None outside a body and
    where the sequence is whole."""
    return _CTX.seq


def seq_gather(x, dim: int = 1):
    """The whole sequence from each shard's slice ``x`` along ``dim``
    (an ``all_gather`` over the split axis, in coordinate order); ``x``
    itself where the sequence is whole."""
    axis = _CTX.seq
    if axis is None:
        return x
    return spmd.all_gather(x, axis, tiled_dim=dim)


def seq_slice(x, dim: int = 1):
    """This shard's slice along ``dim`` of ``x``, which holds the whole
    sequence; ``x`` itself where the sequence is whole."""
    axis = _CTX.seq
    if axis is None:
        return x
    n = x.shape[dim] // spmd.axis_size(axis)
    return x.narrow(dim, spmd.axis_index(axis) * n, n)


def seq_start(local: int) -> int:
    """The position of this shard's first row, for slices of ``local``
    rows (0 where the sequence is whole)."""
    axis = _CTX.seq
    return 0 if axis is None else spmd.axis_index(axis) * local


def seq_last(x):
    """The last position [B, 1, ...] of the sequence of which ``x`` holds
    this shard's slice: the last shard's, gathered."""
    axis = _CTX.seq
    if axis is None:
        return x[:, -1:]
    return spmd.all_gather(x[:, -1:], axis)[-1]


def named_sharding(mesh: Mesh, *logical_axes: Optional[str],
                   shape: Optional[Sequence[int]] = None) -> NamedSharding:
    return NamedSharding(mesh, resolve_spec(logical_axes, shape=shape,
                                            mesh=mesh))
