"""Logical-axis sharding rules and the active mesh
(``repro/models/sharding.py`` at the same path): MaxText-style rules
mapping logical axis names to mesh axes, a no-op without a mesh, and
divisibility-aware (kv_heads=1 cannot shard 16-way).

The port shards nothing implicitly: it has no ``constrain``. The mesh that
``use_sharding`` activates is read by the modules that run explicitly over
it (``models.attention.seq_sharded_decode``, ``models.moe.moe_ep``), and
``resolve_spec`` gives the spec a logical layout would take.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.distributed.spmd import P, Mesh

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
