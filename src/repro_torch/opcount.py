"""Exact operator counts of a step: the dry-run's cost model
(``launch.dryrun``), the counterpart of XLA's ``cost_analysis`` and
``memory_analysis`` of a compiled step.

The port runs eagerly, so every aten operator and every kernel launch of
a step can be counted as it runs. ``Counter`` is a ``TorchDispatchMode``
per thread that records, by operator name:

  * the count of each operator;
  * FLOPs, from ``torch.utils.flop_counter``'s registry (mm, addmm, bmm,
    baddbmm, convolution and their ``out_dtype`` variants);
  * HBM bytes: each tensor input read once, each output that is a new
    tensor written once. View and aliasing operators and bare allocations
    move none; an indexed read (``index``, ``gather``, ``embedding``,
    ``index_select``) reads as many bytes as it writes, and an indexed
    write in place (``index_put_``, ``scatter_``, ...) writes its values,
    not the whole tensor it writes into;
  * the live bytes of the storages the step allocates, and their peak,
    a shard's with the calling thread's and all shards' together
    (storages are told apart by identity, not by address: every ``meta``
    tensor's ``data_ptr()`` is 0).

A kernel wrapper adds its launch and its ``cost(...)`` (``kernel``), on
the card where it launches and on the ``meta`` device where it only
returns empty outputs; each collective of ``distributed.spmd`` adds its
payload bytes under the JAX package's names (``collective``).

Dispatch modes are thread-local, and every shard of a ``spmd.shard_map``
runs in a thread of its own: ``counting(counter)`` makes the counter
active for the whole process and enters it on the calling thread (counts
under shard ``None``); ``spmd`` enters ``shard_scope(i)`` in shard ``i``'s
thread. The counts are the same on a CUDA tensor and on a ``meta`` one
wherever the step takes the card's route, which ``chip_smoke.py``
checks.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the payload names of the JAX package's dry-run (its HLO collectives)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# operators that are bookkeeping on the card only (a stream's use of a
# block), which the meta route does not issue
_IGNORED = {_aten.record_stream.default}
_ALLOCS = {_aten.empty.memory_format, _aten.empty_strided.default,
           _aten.empty_like.default, _aten.new_empty.default,
           _aten.new_empty_strided.default}
_GATHERS = {_aten.index.Tensor, _aten.gather.default,
            _aten.embedding.default, _aten.index_select.default}
# the tensor operands of the products, the only arguments their FLOP
# formulas read (an ``out_dtype`` after them would be taken for the
# output's shape)
_PRODUCTS = {_aten.mm: 2, _aten.bmm: 2, _aten.addmm: 3, _aten.baddbmm: 3}
_SCATTERS = {_aten.index_put_.default, _aten._index_put_impl_.default,
             _aten.scatter_.src, _aten.scatter_.value,
             _aten.scatter_add_.default, _aten.index_add_.default,
             _aten.index_copy_.default, _aten.masked_scatter_.default}


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _storage(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its ``StorageImpl``), the same for
    every view of it, on the card and on ``meta`` alike."""
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class ShardCounts:
    """What one shard (or the calling thread, shard ``None``) did."""
    flops: int = 0
    bytes: int = 0
    ops: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    op_flops: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    op_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    collectives: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {k: 0 for k in COLLECTIVES})
    live: int = 0

    def summary(self) -> Dict:
        """The counts as plain dicts, to compare two runs or write out."""
        return {"flops": self.flops, "bytes": self.bytes,
                "ops": dict(sorted(self.ops.items())),
                "kernels": {k: dict(v) for k, v in
                            sorted(self.kernels.items())},
                "collectives": dict(self.collectives)}


_TLS = threading.local()
_ACTIVE: Optional["Counter"] = None


class _Mode(TorchDispatchMode):
    """The counter as one thread sees it, counting under ``shard``."""

    def __init__(self, counter: "Counter", shard: Optional[int]):
        super().__init__()
        self.counter, self.shard = counter, shard

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func not in _IGNORED:
            self.counter._op(self.shard, func, args, kwargs, out)
        return out


class Counter:
    """Counts of one step, by shard (``shards``: index, or ``None`` for
    the calling thread, to ``ShardCounts``)."""

    def __init__(self):
        self.shards: Dict[Optional[int], ShardCounts] = {}
        self._lock = threading.RLock()
        # storage identity -> [shard, bytes, tensors holding it]
        self._live: Dict[int, list] = {}
        self._watched: set = set()
        # peak over the step of a shard's live bytes plus the caller's
        self.peak_with_caller: Dict[Optional[int], int] = {}
        # peak over the step of every shard's live bytes and the caller's
        # together: a card's, where the shards share it (they take turns,
        # so their work is issued in the same order on any device)
        self.peak_all = 0

    def of(self, shard: Optional[int]) -> ShardCounts:
        with self._lock:
            if shard not in self.shards:
                self.shards[shard] = ShardCounts()
            return self.shards[shard]

    # -- recording -------------------------------------------------------

    def _op(self, shard, func, args, kwargs, out) -> None:
        name = str(func)
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        in_ids = {id(a) for a in ins}
        in_storages = {_storage(a) for a in ins}
        writes = any(a.alias_info is not None and a.alias_info.is_write
                     for a in func._schema.arguments)
        new = [o for o in outs if id(o) not in in_ids]
        aliasing = func.is_view or (
            not writes and all(_storage(o) in in_storages for o in outs))
        if aliasing or func in _ALLOCS:
            nbytes = 0
        elif func in _GATHERS:
            nbytes = 2 * sum(_nbytes(o) for o in outs) + sum(
                _nbytes(a) for a in ins[1:])
        elif func in _SCATTERS:
            nbytes = 2 * sum(_nbytes(a) for a in ins[1:])
        else:
            nbytes = sum(_nbytes(a) for a in ins) + \
                sum(_nbytes(o) for o in new)
        flops = 0
        reg = _flop_registry()
        packet = func.overloadpacket
        if packet in _PRODUCTS:
            flops = reg[packet](*args[:_PRODUCTS[packet]], out_val=out)
        elif packet in reg:
            flops = reg[packet](*args, **kwargs, out_val=out)
        with self._lock:
            c = self.of(shard)
            c.ops[name] += 1
            c.bytes += nbytes
            c.op_bytes[name] += nbytes
            if flops:
                c.flops += flops
                c.op_flops[name] += flops
            for o in outs:
                self._track(shard, o, aliasing or _storage(o) in in_storages)

    def _track(self, shard, t: torch.Tensor, alias: bool) -> None:
        """Follow ``t``'s storage: a storage the step allocated is live
        while any tensor on it is."""
        key = _storage(t)
        rec = self._live.get(key)
        if rec is None:
            if alias:
                return          # a view of an argument
            rec = self._live[key] = [shard, t.untyped_storage().nbytes(), 0]
            self._add(shard, rec[1])
        if id(t) in self._watched:
            return
        rec[2] += 1
        self._watched.add(id(t))
        weakref.finalize(t, self._release, key, id(t))

    def _release(self, key: int, tid: int) -> None:
        with self._lock:
            self._watched.discard(tid)
            rec = self._live.get(key)
            if rec is None:
                return
            rec[2] -= 1
            if rec[2] == 0:
                del self._live[key]
                self._add(rec[0], -rec[1])

    def _add(self, shard, nbytes: int) -> None:
        self.of(shard).live += nbytes
        caller = self.of(None).live
        total = 0
        for s, sc in self.shards.items():
            both = sc.live + (caller if s is not None else 0)
            if both > self.peak_with_caller.get(s, 0):
                self.peak_with_caller[s] = both
            total += sc.live
        self.peak_all = max(self.peak_all, total)

    def kernel(self, shard, name: str, flops: float, nbytes: float) -> None:
        with self._lock:
            c = self.of(shard)
            k = c.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                            "bytes": 0})
            k["launches"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            c.flops += flops
            c.bytes += nbytes

    def collective(self, shard, kind: str, nbytes: int) -> None:
        with self._lock:
            self.of(shard).collectives[kind] += nbytes

    # -- reading -----------------------------------------------------------

    def summary(self) -> Dict:
        """Every shard's counts (``summary`` of each), keyed by shard
        (``"caller"`` for the calling thread)."""
        return {("caller" if s is None else s): c.summary()
                for s, c in sorted(self.shards.items(),
                                   key=lambda kv: -1 if kv[0] is None
                                   else kv[0])}


def active() -> Optional[Counter]:
    return _ACTIVE


def current_shard() -> Optional[int]:
    return getattr(_TLS, "shard", None)


@contextlib.contextmanager
def _entered(counter: Counter, shard: Optional[int]) -> Iterator[None]:
    prev = getattr(_TLS, "shard", None)
    _TLS.shard = shard
    counter.of(shard)
    try:
        with _Mode(counter, shard):
            yield
    finally:
        _TLS.shard = prev


@contextlib.contextmanager
def counting(counter: Counter) -> Iterator[Counter]:
    """Within the block ``counter`` is active: this thread counts under
    shard ``None``, and every ``shard_map`` shard under its index."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("a counter is already active")
    _ACTIVE = counter
    try:
        with _entered(counter, None):
            yield counter
    finally:
        _ACTIVE = None


@contextlib.contextmanager
def shard_scope(index: int) -> Iterator[None]:
    """Entered in shard ``index``'s thread: the active counter (if any)
    counts this thread's work under the shard."""
    counter = _ACTIVE
    if counter is None:
        yield
        return
    with _entered(counter, index):
        yield


def kernel(name: str, flops: float, nbytes: float) -> None:
    """A kernel's launch and its cost, under the active counter (none: a
    no-op), for the calling thread's shard."""
    if _ACTIVE is not None:
        _ACTIVE.kernel(current_shard(), name, flops, nbytes)


def collective(kind: str, nbytes: int) -> None:
    """A collective's payload bytes on the calling thread's shard, under
    the active counter (none: a no-op)."""
    if _ACTIVE is not None:
        _ACTIVE.collective(current_shard(), kind, nbytes)
