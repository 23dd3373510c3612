"""Residency & placement engine (paper §3.1.1 + §3.1.3/§4.4).

One source of truth for *where data lives*: a per-device **residency
ledger** tracks every HeteroObject's valid device replicas — bytes, pin
state, last touch — and every layer that previously walked ``obj.copies``
ad hoc (scheduler placement, coherence walk, LRU eviction, distributed
payload landing) now consults the ledger instead.

On top of the ledger sit pluggable **placement policies**: cost models
scoring candidate devices for a task. The default ``DataGravityPolicy``
implements the paper's data-locality scheduling ("place tasks where their
arguments already live") as bytes-to-move minus bytes-resident with a
load-pressure penalty, so tasks gravitate to their data but one hot device
cannot serialize the queue. ``Runtime`` binds the ledger to the scheduler's
policy at startup; schedulers re-key their indexed ready queues by the
policy's best placement.

The ledger also answers the distributed layer's landing question — "which
device should an incoming DIRECT payload land on when no consumer is known
yet?" — with the least-loaded device by (queue pressure, bytes resident).
"""
from __future__ import annotations

import abc
import collections
import itertools

from repro_torch.core import sanitizer
from typing import Any, Callable, Dict, Optional, Sequence, Set, Tuple

_touch_clock = itertools.count()


class _Entry:
    """One replica record: (object, bytes, last-touch tick)."""

    __slots__ = ("obj", "nbytes", "last_touch")

    def __init__(self, obj, nbytes: int):
        self.obj = obj
        self.nbytes = nbytes
        self.last_touch = next(_touch_clock)


class ResidencyLedger:
    """Per-device replica ledger + capacity accounting + LRU eviction.

    ``record``/``drop``/``touch`` are called by the runtime wherever a
    device copy is created, invalidated, or reused; everything else reads.

    Pin ownership lives HERE (ROADMAP follow-up c): the runtime pins an
    object while any task, host access, or device view holds it
    (``pin``/``unpin``), and eviction skips pinned replicas by consulting
    the ledger alone — no ``obj.busy()`` walk, no object locks on the
    eviction path. ``version`` ticks on every replica change so placement
    decisions can detect staleness (the scheduler re-scores aged
    ready-queue entries on pop when the version moved).
    """

    def __init__(self, capacities: Dict[int, int]):
        self._cap = dict(capacities)
        self._usage: Dict[int, int] = {d: 0 for d in capacities}
        # device -> OrderedDict[id(obj) -> _Entry]  (insertion order = LRU)
        self._lru: Dict[int, "collections.OrderedDict[int, _Entry]"] = {
            d: collections.OrderedDict() for d in capacities}
        # id(obj) -> set of devices holding a valid replica
        self._where: Dict[int, Set[int]] = {}
        # id(obj) -> pin count; pinned objects are never evicted. The
        # pinner always holds a strong reference for the pin's lifetime,
        # so a recycled id() cannot alias a live pin.
        self._pins: Dict[int, int] = {}
        self._lock = sanitizer.make_rlock("ResidencyLedger._lock")
        self.evictions = 0
        self.version = 0          # bumped on every record/drop

    # -- replica bookkeeping -------------------------------------------
    def record(self, device_id: int, obj, nbytes: Optional[int] = None
               ) -> None:
        nb = obj.nbytes if nbytes is None else nbytes
        with self._lock:
            lru = self._lru[device_id]
            if id(obj) not in lru:
                self._usage[device_id] += nb
                lru[id(obj)] = _Entry(obj, nb)
                self.version += 1
            else:
                lru[id(obj)].last_touch = next(_touch_clock)
            lru.move_to_end(id(obj))
            self._where.setdefault(id(obj), set()).add(device_id)

    def drop(self, device_id: int, obj, nbytes: Optional[int] = None) -> None:
        nb = obj.nbytes if nbytes is None else nbytes
        with self._lock:
            if self._lru[device_id].pop(id(obj), None) is not None:
                self._usage[device_id] -= nb
                self.version += 1
            devs = self._where.get(id(obj))
            if devs is not None:
                devs.discard(device_id)
                if not devs:
                    del self._where[id(obj)]

    def drop_many(self, pairs: Sequence[Tuple[int, Any]]) -> None:
        """Batched ``drop``: one lock acquisition for a replay window's
        rebind invalidations instead of one per stale replica."""
        with self._lock:
            for device_id, obj in pairs:
                nb = obj.nbytes
                if self._lru[device_id].pop(id(obj), None) is not None:
                    self._usage[device_id] -= nb
                    self.version += 1
                devs = self._where.get(id(obj))
                if devs is not None:
                    devs.discard(device_id)
                    if not devs:
                        del self._where[id(obj)]

    def record_many(self, pairs: Sequence[Tuple[int, Any]]) -> None:
        """Batched ``record``: one lock acquisition for a whole replay
        window's rebinds instead of one per written object."""
        with self._lock:
            for device_id, obj in pairs:
                nb = obj.nbytes
                lru = self._lru[device_id]
                if id(obj) not in lru:
                    self._usage[device_id] += nb
                    lru[id(obj)] = _Entry(obj, nb)
                    self.version += 1
                else:
                    lru[id(obj)].last_touch = next(_touch_clock)
                lru.move_to_end(id(obj))
                self._where.setdefault(id(obj), set()).add(device_id)

    # -- pin ownership (eviction guard) --------------------------------
    def pin(self, obj) -> None:
        """Mark ``obj`` in active use (task argument, host access, device
        view): its replicas are skipped by eviction until ``unpin``."""
        with self._lock:
            self._pins[id(obj)] = self._pins.get(id(obj), 0) + 1

    def unpin(self, obj) -> None:
        with self._lock:
            n = self._pins.get(id(obj), 0) - 1
            if n <= 0:
                self._pins.pop(id(obj), None)
            else:
                self._pins[id(obj)] = n

    def pin_many(self, objs: Sequence[Any]) -> None:
        """Batched ``pin`` — the replay fast path pins a whole traced
        window's objects under a single lock acquisition."""
        with self._lock:
            pins = self._pins
            for obj in objs:
                pins[id(obj)] = pins.get(id(obj), 0) + 1

    def unpin_many(self, objs: Sequence[Any]) -> None:
        with self._lock:
            pins = self._pins
            for obj in objs:
                n = pins.get(id(obj), 0) - 1
                if n <= 0:
                    pins.pop(id(obj), None)
                else:
                    pins[id(obj)] = n

    def pinned(self, obj) -> bool:
        with self._lock:
            return self._pins.get(id(obj), 0) > 0

    def forget(self, obj) -> None:
        """Drop every replica of ``obj`` and clear its pins — the object
        left this runtime entirely (elastic chunk migration: the source
        rank must stop counting the bytes against its devices)."""
        with self._lock:
            devs = list(self._where.get(id(obj), ()))
        for d in devs:
            self.drop(d, obj)
        with self._lock:
            self._pins.pop(id(obj), None)

    def touch(self, device_id: int, obj) -> None:
        with self._lock:
            e = self._lru[device_id].get(id(obj))
            if e is not None:
                e.last_touch = next(_touch_clock)
                self._lru[device_id].move_to_end(id(obj))

    def touch_many(self, pairs: Sequence[Tuple[int, Any]]) -> None:
        """Batched ``touch``: LRU-bump a replay window's staged replicas
        under one lock acquisition."""
        with self._lock:
            for device_id, obj in pairs:
                e = self._lru[device_id].get(id(obj))
                if e is not None:
                    e.last_touch = next(_touch_clock)
                    self._lru[device_id].move_to_end(id(obj))

    # -- queries --------------------------------------------------------
    def devices_of(self, obj) -> Set[int]:
        """Devices holding a valid replica (never includes HOST)."""
        with self._lock:
            return set(self._where.get(id(obj), ()))

    def holds(self, device_id: int, obj) -> bool:
        with self._lock:
            return id(obj) in self._lru[device_id]

    def usage(self, device_id: int) -> int:
        return self._usage[device_id]

    def capacity(self, device_id: int) -> int:
        return self._cap[device_id]

    def task_bytes_resident(self, task, device_id: int) -> int:
        """Bytes of the task's (unique) arguments already on device_id."""
        with self._lock:
            lru = self._lru[device_id]
            seen, total = set(), 0
            for ref in task.args:
                oid = id(ref.obj)
                if oid not in seen:
                    seen.add(oid)
                    if oid in lru:
                        total += ref.obj.nbytes
            return total

    def task_bytes_to_move(self, task, device_id: int) -> int:
        """Bytes the coherence walk would have to copy in before launch."""
        with self._lock:
            lru = self._lru[device_id]
            seen, total = set(), 0
            for ref in task.args:
                oid = id(ref.obj)
                if oid not in seen:
                    seen.add(oid)
                    if oid not in lru:
                        total += ref.obj.nbytes
            return total

    def least_loaded_device(self, pressure: Optional[Callable[[int], int]]
                            = None,
                            among: Optional[Sequence[int]] = None) -> int:
        """Landing device for data with no known consumer: least queue
        pressure first (when the scheduler provides it), then fewest bytes
        resident, then lowest id — deterministic. ``among`` restricts the
        candidates (e.g. to one device type)."""
        devs = sorted(self._cap if among is None
                      else (d for d in among if d in self._cap))
        if not devs:
            devs = sorted(self._cap)
        if pressure is None:
            return min(devs, key=lambda d: (self._usage[d], d))
        return min(devs, key=lambda d: (pressure(d), self._usage[d], d))

    # -- capacity / eviction -------------------------------------------
    def ensure_capacity(self, device_id: int, nbytes: int,
                        evict: Callable[[Any, int], bool]) -> bool:
        """Evict LRU replicas (via ``evict(obj, device_id)``, which returns
        False when an object is busy and must be skipped) until ``nbytes``
        fits. Returns True on success."""
        with self._lock:
            if self._usage[device_id] + nbytes <= self._cap[device_id]:
                return True
            # pinned replicas never leave the candidate list — the whole
            # point of ledger-owned pins: no per-object lock or busy()
            # walk on the eviction path
            candidates = [e.obj for e in self._lru[device_id].values()
                          if self._pins.get(id(e.obj), 0) == 0]
        for obj in candidates:
            if self._usage[device_id] + nbytes <= self._cap[device_id]:
                return True
            if evict(obj, device_id):
                self.evictions += 1
        with self._lock:
            return self._usage[device_id] + nbytes <= self._cap[device_id]

    # -- observability --------------------------------------------------
    def gauges(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "bytes_resident": dict(self._usage),
                "objects_resident": {d: len(lru)
                                     for d, lru in self._lru.items()},
                "evictions": self.evictions,
                "pinned_objects": len(self._pins),
            }


# ---------------------------------------------------------------------------
# placement cost models
# ---------------------------------------------------------------------------

class PlacementPolicy(abc.ABC):
    """Scores candidate devices for a task; lower is better. A ledger is
    bound by the runtime (``bind``); unbound policies fall back to the
    object-level ``has_copy`` walk so schedulers remain usable standalone.
    The runtime also binds its ``InterconnectModel`` (``bind_topology``)
    so cost models can price data movement in measured link terms."""

    def __init__(self):
        self.ledger: Optional[ResidencyLedger] = None
        self.topology = None      # Optional[InterconnectModel]

    def bind(self, ledger: ResidencyLedger) -> None:
        self.ledger = ledger

    def bind_topology(self, model) -> None:
        self.topology = model

    def _bytes_split(self, task, device_id: int) -> Tuple[int, int]:
        """(bytes_resident, bytes_to_move) for the task on device_id."""
        if self.ledger is not None:
            return (self.ledger.task_bytes_resident(task, device_id),
                    self.ledger.task_bytes_to_move(task, device_id))
        seen, res, move = set(), 0, 0
        for ref in task.args:
            if id(ref.obj) in seen:
                continue
            seen.add(id(ref.obj))
            if ref.obj.has_copy(device_id):
                res += ref.obj.nbytes
            else:
                move += ref.obj.nbytes
        return res, move

    @abc.abstractmethod
    def score(self, task, device_id: int, pressure: int) -> float: ...

    def choose(self, task, eligible: Sequence[int],
               pressure: Callable[[int], int]) -> int:
        """Best device: minimal score, ties broken by lowest device id
        (deterministic — tested)."""
        return min(eligible,
                   key=lambda d: (self.score(task, d, pressure(d)), d))


class DataGravityPolicy(PlacementPolicy):
    """The paper's data-locality placement as a cost model: prefer the
    device needing the fewest argument bytes copied in and holding the most
    already, with queue pressure converted to bytes so load still balances
    when residency ties.

    The pressure penalty is DERIVED from the interconnect model when one
    is bound (ROADMAP follow-up b): one queued task costs
    ``penalty_seconds`` of that device's measured host→device bandwidth,
    so a fast link tolerates more queueing before work migrates off its
    data and a slow link sheds load sooner. ``load_penalty_bytes`` is only
    the standalone fallback when no topology is bound."""

    def __init__(self, load_penalty_bytes: int = 256 << 10,
                 penalty_seconds: float = 50e-6):
        super().__init__()
        self.load_penalty = load_penalty_bytes
        self.penalty_seconds = penalty_seconds

    def penalty_bytes(self, device_id: int) -> int:
        """Byte cost of one queued/running task on ``device_id``."""
        if self.topology is None:
            return self.load_penalty
        from repro_torch.core.hetero_object import HOST
        return self.topology.penalty_bytes(HOST, device_id,
                                           self.penalty_seconds)

    def transfer_cost_s(self, task, device_id: int) -> float:
        """Predicted seconds the coherence walk would spend staging the
        task's missing argument bytes onto ``device_id`` — the scheduler's
        transfer-cost estimate, surfaced for diagnostics and tests."""
        _, move = self._bytes_split(task, device_id)
        if not move:
            return 0.0
        if self.topology is None:
            from repro_torch.core.topology import LinkEstimate
            return LinkEstimate().cost_s(move)    # default-link fallback
        from repro_torch.core.hetero_object import HOST
        return self.topology.cost_s(HOST, device_id, move)

    def score(self, task, device_id: int, pressure: int) -> float:
        res, move = self._bytes_split(task, device_id)
        return move - res + pressure * self.penalty_bytes(device_id)


class LoadOnlyPolicy(PlacementPolicy):
    """Pure pressure balancing — ignores residency entirely. The control
    arm for the gravity model in benchmarks and tests."""

    def score(self, task, device_id: int, pressure: int) -> float:
        return float(pressure)


PLACEMENTS: Dict[str, Callable[[], PlacementPolicy]] = {
    "gravity": DataGravityPolicy,
    "load_only": LoadOnlyPolicy,
}
