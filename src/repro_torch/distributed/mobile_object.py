"""Mobile objects + owner map (paper §1.1): globally addressable,
location-independent containers. The owner map is the load-balancing lever —
migrating a mobile object is an owner-map update plus a data transfer, which
is how PREMA does implicit distributed load balancing and how we do
straggler mitigation (move chunks off a slow rank) and elastic rescale
(re-map chunks of a lost/added rank). ``repro/distributed/mobile_object.py``
at the same path.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_ids = itertools.count()


@dataclasses.dataclass(frozen=True)
class MobilePtr:
    """Global name of a mobile object."""
    oid: int

    def __int__(self):
        return self.oid


class OwnerMap:
    """oid -> rank, replicated control state. Deterministic given the event
    log (assign/migrate), so every rank can replay it.

    Each entry may also carry a per-chunk **device hint** — the device id
    (on the owner rank) whose tasks consume the chunk. Migration executors
    pass it as ``Rank.send(..., consumer_device=...)``/``put(...)`` so the
    payload lands where the chunk's tasks run (ROADMAP follow-up d). A
    migration without a new hint clears the old one: device ids are local
    to the previous owner and would mis-route on the new rank."""

    def __init__(self):
        self._owner: Dict[int, int] = {}
        self._hints: Dict[int, int] = {}
        self.version = 0

    def assign(self, oid: int, rank: int,
               device_hint: Optional[int] = None) -> None:
        self._owner[oid] = rank
        if device_hint is not None:
            self._hints[oid] = device_hint
        self.version += 1

    def owner(self, oid: int) -> int:
        return self._owner[oid]

    def device_hint(self, oid: int) -> Optional[int]:
        """Consumer device id on the owner rank, if a hint is recorded."""
        return self._hints.get(oid)

    def set_device_hint(self, oid: int, device_id: Optional[int]) -> None:
        if device_id is None:
            self._hints.pop(oid, None)
        else:
            self._hints[oid] = device_id
        self.version += 1

    def migrate(self, oid: int, new_rank: int,
                device_hint: Optional[int] = None) -> None:
        self._owner[oid] = new_rank
        if device_hint is None:
            self._hints.pop(oid, None)
        else:
            self._hints[oid] = device_hint
        self.version += 1

    def owned_by(self, rank: int) -> List[int]:
        return [o for o, r in self._owner.items() if r == rank]

    def items(self):
        return self._owner.items()

    def __len__(self):
        return len(self._owner)


def block_distribution(n_objects: int, n_ranks: int) -> Dict[int, int]:
    """Contiguous block assignment (the paper's initial decomposition)."""
    return {i: min(i * n_ranks // n_objects, n_ranks - 1)
            for i in range(n_objects)}


def rebalance_greedy(loads: Dict[int, float], owner: OwnerMap,
                     chunk_load: Dict[int, float],
                     max_moves: int = 8) -> List[Tuple[int, int, int]]:
    """Greedy diffusion: move chunks from the most- to the least-loaded rank.
    Returns [(oid, src, dst)] migration plan; the caller executes transfers
    and applies owner.migrate. Used for straggler mitigation: a straggler's
    effective load is inflated by its slowdown factor."""
    plan: List[Tuple[int, int, int]] = []
    loads = dict(loads)
    for _ in range(max_moves):
        src = max(loads, key=loads.get)
        dst = min(loads, key=loads.get)
        if loads[src] - loads[dst] < 1e-9:
            break
        movable = [o for o in owner.owned_by(src)]
        if not movable:
            break
        # smallest chunk that helps
        movable.sort(key=lambda o: chunk_load.get(o, 1.0))
        best = None
        gap = loads[src] - loads[dst]
        for o in movable:
            w = chunk_load.get(o, 1.0)
            if w < gap:
                best = o
        if best is None:
            break
        w = chunk_load.get(best, 1.0)
        owner.migrate(best, dst)
        plan.append((best, src, dst))
        loads[src] -= w
        loads[dst] += w
    return plan


class MobileObject:
    """A chunk of application data bound to an owner rank. Holds a
    hetero_object on the owner; elsewhere it is just the pointer.

    ``meta["device"]`` (see ``device_hint``) records which of the owner's
    devices consumes this chunk. Migration executors that ship a chunk's
    data should pass it as ``Rank.send(..., consumer_device=...)`` so the
    payload lands where the chunk's tasks will run instead of on the
    landing fallback (wiring a built-in executor is a ROADMAP item)."""

    def __init__(self, ptr: Optional[MobilePtr] = None,
                 data: Any = None, meta: Optional[Dict[str, Any]] = None):
        self.ptr = ptr or MobilePtr(next(_ids))
        self.data = data            # HeteroObject on the owner rank
        self.meta = meta or {}

    @property
    def device_hint(self) -> Optional[int]:
        """Consumer device id on the owner rank, if known."""
        return self.meta.get("device")

    def __repr__(self):
        return f"MobileObject(oid={self.ptr.oid}, meta={self.meta})"
