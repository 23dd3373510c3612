"""Lineage ledger: remember how each HeteroObject was produced.

The over-decomposition literature's cheap-recovery argument (and the
paper's own ownership of every data movement) makes lineage replay the
natural last line of defence: when coherence finds an object with *no*
valid replica anywhere — evicted and lost, dropped by a failed rank,
freed too early — the runtime can re-run the task that produced it
instead of handing back zeros or restarting the job.

Correctness hinges on **generation numbers**: every write-rebind of a
HeteroObject bumps ``obj.generation``, and a lineage record is only
valid for the exact generation it produced, with inputs pinned to the
generations it *read*.  In-place write chains (``rw`` args) therefore
self-invalidate — the pre-write version of an input no longer exists
once its generation moved on — which makes replay bounded and
cycle-safe by construction.  Compiled-graph replays and distributed
puts bump generations through the same choke points, so stale records
can never resurrect old bytes.

The ledger holds strong references to the objects in its records (so
``id()`` keys stay unique) and is bounded LRU: recording a new producer
for an object supersedes the old record, and the oldest records fall
off past ``cap``.
"""
from __future__ import annotations

import collections

from repro_torch.core import sanitizer
from typing import Any, List, Optional, Tuple


class LineageRecord:
    """One producing task: kernel + argument versions at launch time.

    ``args`` is a tuple of ``(obj, pre_gen, reads, writes)`` in the
    task's argument order; ``out_gens`` maps ``id(obj)`` of written
    objects to the generation the launch produced.
    """
    __slots__ = ("kernel", "args", "out_gens", "device_id", "epoch")

    def __init__(self, kernel: Any,
                 args: Tuple[Tuple[Any, int, bool, bool], ...],
                 out_gens: dict, device_id: int, epoch: int):
        self.kernel = kernel
        self.args = args
        self.out_gens = out_gens
        self.device_id = device_id
        self.epoch = epoch

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        k = getattr(self.kernel, "__name__", repr(self.kernel))
        return (f"LineageRecord(kernel={k}, nargs={len(self.args)}, "
                f"dev={self.device_id}, epoch={self.epoch})")


class LineageLedger:
    def __init__(self, cap: int = 4096):
        self.cap = int(cap)
        self.epoch = 0
        self._lock = sanitizer.make_lock("LineageLedger._lock")
        # id(written obj) -> its most recent LineageRecord (LRU order)
        self._by_obj: "collections.OrderedDict[int, LineageRecord]" = \
            collections.OrderedDict()

    def record(self, kernel: Any,
               arg_info: List[Tuple[Any, int, bool, bool]],
               out_gens: dict, device_id: int) -> None:
        """Remember that ``kernel(args)`` produced the written objects."""
        rec = LineageRecord(kernel, tuple(arg_info), dict(out_gens),
                            device_id, self.epoch)
        with self._lock:
            for obj, _pre, _r, writes in rec.args:
                if writes:
                    self._by_obj[id(obj)] = rec
                    self._by_obj.move_to_end(id(obj))
            while len(self._by_obj) > self.cap:
                self._by_obj.popitem(last=False)

    def producer(self, obj: Any) -> Optional[LineageRecord]:
        """The record that produced ``obj``'s *current* generation, or
        None — a record for any other generation is stale by definition
        (the object was rewritten since) and must not be replayed."""
        with self._lock:
            rec = self._by_obj.get(id(obj))
        if rec is None:
            return None
        return rec if rec.out_gens.get(id(obj)) == obj.generation else None

    def forget(self, obj: Any) -> None:
        with self._lock:
            self._by_obj.pop(id(obj), None)

    def forget_many(self, objs: Any) -> None:
        """Batched ``forget`` for the replay rebind loop: fused-chain
        outputs drop their stale records under one lock acquisition."""
        with self._lock:
            for obj in objs:
                self._by_obj.pop(id(obj), None)

    def bump_epoch(self) -> None:
        """Elastic epoch bump: records survive (generation checks keep
        them safe) but new records carry the new epoch for forensics."""
        self.epoch += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_obj)
