"""Modular scheduler (paper §3.1.4): an abstract class with push/pop as the
only operations the runtime requires; policies are pluggable.

Indexed ready queues: every built-in policy now routes through
``IndexedScheduler`` — tasks are placed into a per-device deque at ``push``
time (the policy decides the placement), with a shared overflow deque for
tasks that have no placement preference. ``pop(device_hint)`` is O(1) in
the common case: pop the head of the hint's own deque, else the head of the
overflow deque. The old implementations re-scanned the whole global queue
under one lock on every pop — O(queue length) per worker wake-up, which
serialized the dedicated per-device threads (paper §4.1.6) behind the scan.

Data-gravity placement (paper §3.1.3: "the scheduler optimizes data
locality to reduce memory transfers"): the ready queues are re-keyed by
*best placement* — a pluggable cost model (``core.residency.PLACEMENTS``)
scores candidate devices by bytes-to-move minus bytes-resident (plus a
pressure penalty) against the runtime's residency ledger, and ``push``
indexes the task under the winner. The caller's device hint only selects
*which queue to pop*, it no longer decides placement.

Two extra hooks support the runtime's argument-prefetch pipeline
(paper §4.1.3 — overlap transfers with compute):
  peek(device_hint)   — the next task this device would receive (no removal)
  assign(device_hint) — pop + commit in one step; the prefetcher uses this
                        to claim the next task early and enqueue its
                        argument transfers while the current task computes.
"""
from __future__ import annotations

import abc
import collections
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core import sanitizer
from repro_torch.core.hetero_task import HeteroTask
from repro_torch.core.residency import (DataGravityPolicy, PlacementPolicy,
                                  ResidencyLedger)


class Scheduler(abc.ABC):
    """Device table: {device_id: device_type}. ``load`` is maintained by the
    runtime (tasks queued+running per device) and may be used by policies.
    ``placement`` is an optional cost model; the runtime binds its residency
    ledger to it via ``bind_residency``."""

    def __init__(self, device_types: Dict[int, str],
                 placement: Optional[PlacementPolicy] = None):
        self.device_types = dict(device_types)
        self.load: Dict[int, int] = {d: 0 for d in device_types}
        self.placement = placement
        self._lock = sanitizer.make_lock("Scheduler._lock")

    def bind_residency(self, ledger: ResidencyLedger) -> None:
        if self.placement is not None:
            self.placement.bind(ledger)

    def bind_topology(self, model) -> None:
        """Hand the runtime's InterconnectModel to the placement cost
        model so transfer costs are priced from measured bandwidth."""
        if self.placement is not None:
            self.placement.bind_topology(model)

    @abc.abstractmethod
    def push(self, task: HeteroTask) -> None: ...

    @abc.abstractmethod
    def pop(self, device_hint: Optional[int] = None
            ) -> Optional[Tuple[HeteroTask, int]]: ...

    def peek(self, device_hint: Optional[int] = None
             ) -> Optional[HeteroTask]:
        """Next task ``pop(device_hint)`` would return, without removing it.
        Policies may return None when peeking is unsupported."""
        return None

    def assign(self, device_hint: Optional[int] = None
               ) -> Optional[Tuple[HeteroTask, int]]:
        """Claim the next (task, device) pair — identical to ``pop`` but
        named for the prefetch pipeline, which commits the assignment before
        the worker is ready to launch."""
        return self.pop(device_hint)

    def __len__(self) -> int:  # pragma: no cover - informational
        return 0

    # helpers ---------------------------------------------------------------
    def eligible(self, task: HeteroTask) -> List[int]:
        if task.device_type is None:
            return list(self.device_types)
        return [d for d, t in self.device_types.items()
                if t == task.device_type]


class IndexedScheduler(Scheduler):
    """Per-device indexed ready queues + shared overflow deque.

    Subclasses implement ``_place(task) -> Optional[device_id]`` (None →
    overflow) and ``_choose(task) -> device_id`` (device selection for
    overflow tasks popped without a hint). ``steals`` controls whether an
    idle device may take the oldest task indexed to another device — on for
    throughput policies, off for locality (stealing would defeat it).
    """

    steals = True
    # re-score the head of a ready queue at pop time when residency moved
    # since it was placed (ROADMAP follow-up a: placement is decided at
    # push time and can be stale once replicas shifted). Only locality
    # policies opt in — for load-only policies staleness is meaningless.
    rescore_on_pop = False
    # bound work per pop: at most this many stale heads are re-homed
    # before falling through to the normal pop path
    _RESCORE_LIMIT = 4

    def __init__(self, device_types: Dict[int, str],
                 placement: Optional[PlacementPolicy] = None):
        super().__init__(device_types, placement)
        self._ready: Dict[int, Deque[HeteroTask]] = {
            d: collections.deque() for d in device_types}
        self._overflow: Deque[HeteroTask] = collections.deque()
        # tasks indexed per device but not yet popped; policies add it to
        # ``load`` so placement sees queued work, not only running work
        self.queued: Dict[int, int] = {d: 0 for d in device_types}

    # policy hooks ----------------------------------------------------------
    def _place(self, task: HeteroTask) -> Optional[int]:
        return None

    def _choose(self, task: HeteroTask) -> int:
        elig = self.eligible(task) or list(self.device_types)
        return min(elig, key=lambda d: self.load[d] + self.queued[d])

    def _pressure(self, dev: int) -> int:
        return self.load[dev] + self.queued[dev]

    def _ledger_version(self) -> Optional[int]:
        led = self.placement.ledger if self.placement is not None else None
        return led.version if led is not None else None

    # queue mechanics -------------------------------------------------------
    def push(self, task: HeteroTask) -> None:
        with self._lock:
            dev = self._place(task)
            if dev is None:
                self._overflow.append(task)
            else:
                task._placement_version = self._ledger_version()
                self._ready[dev].append(task)
                self.queued[dev] += 1

    def _rescore_head(self, device_hint: int) -> None:
        """Aged-entry repair (ROADMAP follow-up a): if residency changed
        since the head of this device's queue was placed, score it again
        and re-home it to the new best device's queue. Bounded so a pop
        stays O(1)-ish; the re-homed task keeps its FIFO position at the
        tail of the winner's queue (its placement is the freshest)."""
        version = self._ledger_version()
        if version is None:
            return
        q = self._ready[device_hint]
        for _ in range(self._RESCORE_LIMIT):
            if not q:
                return
            head = q[0]
            if getattr(head, "_placement_version", None) == version:
                return
            head._placement_version = version
            best = self._place(head)
            if best is None or best == device_hint:
                return
            q.popleft()
            self.queued[device_hint] -= 1
            self._ready[best].append(head)
            self.queued[best] += 1

    def _take_overflow(self, device_hint: int) -> Optional[HeteroTask]:
        # O(1) when the head is eligible (the common, untyped-task case);
        # the scan only happens while type-restricted tasks sit at the head
        for i, task in enumerate(self._overflow):
            if device_hint in self.eligible(task):
                del self._overflow[i]
                return task
        return None

    def _steal(self, device_hint: int) -> Optional[HeteroTask]:
        victim = max((d for d in self._ready if d != device_hint),
                     key=lambda d: len(self._ready[d]), default=None)
        if victim is None or not self._ready[victim]:
            return None
        # steal the oldest so the victim keeps its freshest placements
        task = self._ready[victim][0]
        if device_hint not in self.eligible(task):
            return None
        self._ready[victim].popleft()
        self.queued[victim] -= 1
        return task

    def pop(self, device_hint: Optional[int] = None
            ) -> Optional[Tuple[HeteroTask, int]]:
        with self._lock:
            if device_hint is not None:
                if self.rescore_on_pop:
                    self._rescore_head(device_hint)
                q = self._ready[device_hint]
                if q:
                    self.queued[device_hint] -= 1
                    return q.popleft(), device_hint
                task = self._take_overflow(device_hint)
                if task is not None:
                    return task, device_hint
                if self.steals:
                    task = self._steal(device_hint)
                    if task is not None:
                        return task, device_hint
                return None
            # hintless worker: own indexed queues first, then overflow
            for d, q in self._ready.items():
                if q:
                    self.queued[d] -= 1
                    return q.popleft(), d
            for i, task in enumerate(self._overflow):
                if self.eligible(task):
                    del self._overflow[i]
                    return task, self._choose(task)
            return None

    def peek(self, device_hint: Optional[int] = None
             ) -> Optional[HeteroTask]:
        with self._lock:
            if device_hint is not None:
                q = self._ready[device_hint]
                if q:
                    return q[0]
                for task in self._overflow:
                    if device_hint in self.eligible(task):
                        return task
                return None
            for q in self._ready.values():
                if q:
                    return q[0]
            return self._overflow[0] if self._overflow else None

    def __len__(self) -> int:
        return sum(len(q) for q in self._ready.values()) + \
            len(self._overflow)


class FifoScheduler(IndexedScheduler):
    """Single shared FIFO (all tasks overflow); device = hint if eligible,
    else least-loaded. Pop from the head is O(1)."""
    # _place -> None inherited: every task goes to the overflow deque


class LeastLoadedScheduler(IndexedScheduler):
    """Place each task, at push time, on the least-pressured eligible device
    (running + queued) — the multi-GPU load-balancing policy behind the
    paper's Fig. 9. Idle devices steal, so imbalance self-corrects."""

    def _place(self, task):
        elig = self.eligible(task)
        if not elig:
            return None
        return min(elig, key=self._pressure)


class LocalityAwareScheduler(IndexedScheduler):
    """The original locality heuristic, kept as the baseline control arm: prefer
    the device already holding the most argument bytes, minus a flat 1 MiB
    load penalty per queued task. The penalty routinely overwhelms the
    residency term for megabyte-scale arguments, so placement degenerates
    to load balancing and resident objects bounce between devices — the
    failure mode ``GravityScheduler`` fixes. No stealing."""

    steals = False

    def __init__(self, device_types, load_penalty_bytes: int = 1 << 20):
        super().__init__(device_types)
        self.load_penalty = load_penalty_bytes

    def _score(self, task: HeteroTask, dev: int) -> float:
        return (task.arg_bytes_on(dev)
                - self.load_penalty * self._pressure(dev))

    def _place(self, task):
        elig = self.eligible(task)
        if not elig:
            return None
        return max(elig, key=lambda d: self._score(task, d))

    def _choose(self, task):
        elig = self.eligible(task) or list(self.device_types)
        return max(elig, key=lambda d: self._score(task, d))


class GravityScheduler(IndexedScheduler):
    """Data-gravity placement (the default): the ready queues are re-keyed
    by the placement cost model's best device — bytes-to-move minus
    bytes-resident plus pressure, answered by the runtime's residency
    ledger. No stealing: a stolen task pays exactly the transfers the
    placement avoided. Aged entries are re-scored at pop time when the
    ledger moved underneath them (push-time placement can be stale)."""

    steals = False
    rescore_on_pop = True

    def __init__(self, device_types,
                 placement: Optional[PlacementPolicy] = None):
        super().__init__(device_types, placement or DataGravityPolicy())

    def _place(self, task):
        elig = self.eligible(task)
        if not elig:
            return None
        return self.placement.choose(task, elig, self._pressure)

    def _choose(self, task):
        elig = self.eligible(task) or list(self.device_types)
        return self.placement.choose(task, elig, self._pressure)


class RoundRobinScheduler(IndexedScheduler):
    def __init__(self, device_types):
        super().__init__(device_types)
        self._next = 0

    def _place(self, task):
        elig = self.eligible(task)
        if not elig:
            return None
        dev = elig[self._next % len(elig)]
        self._next += 1
        return dev


SCHEDULERS = {
    "fifo": FifoScheduler,
    "gravity": GravityScheduler,
    "least_loaded": LeastLoadedScheduler,
    "locality": LocalityAwareScheduler,
    "round_robin": RoundRobinScheduler,
}
