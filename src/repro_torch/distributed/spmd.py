"""Single-controller SPMD: the port's stand-in for ``jax.sharding.Mesh``,
``jax.shard_map`` and the ``jax.lax`` collectives (``ppermute``, ``psum``,
``psum_scatter``, ``pmax``, ``pmean``, ``all_to_all``, ``all_gather``,
``axis_index``, ``axis_size``; ``axes_index`` for several axes taken as
one).

A ``Mesh`` names the device of each shard; a device may repeat, so one card
can hold several shards, as the JAX tests hold forced host devices.
``shard_map(fn, mesh, in_specs, out_specs)`` splits each input along the
dims its spec names, runs ``fn`` once per shard and returns the outputs as
``Sharded`` values (one tensor per shard, the global array ``full()``
joins). Each shard's ``fn`` runs in its own thread, with its mesh
coordinates bound thread-locally, so the body calls the collectives with
JAX's signatures (``ppermute(x, axis_name, perm)``). The threads are the
mesh's own, started at its first ``shard_map`` and kept for its life.
They take turns (``_Group``): one issues work at a time, from one
collective to the next, in shard order, so that they never contend for
the interpreter. On CUDA shards the work runs on the devices' streams,
concurrently all the same; CPU shards compute as they issue, so a CPU
mesh runs its shards' work one after another (each op still spread over
the host's cores by torch's own threads).

Ordering on a card. Each shard has one CUDA stream of its own, made with
the mesh, and runs its body on it. A collective is a rendezvous of the
shards' threads: each posts its tensor with an event recorded on its
stream after the tensor's producer, and each receiver's stream waits on the
events of the peers it reads, then copies their tensors onto its device. No
shard waits on the device as a whole, nor on a peer it does not read. A
``Sharded`` output keeps each shard's tensor on its stream with the event
recorded at the end of its body; the next ``shard_map`` over the same mesh
consumes it on the same stream, so consecutive steps synchronise the shards
only where a collective does. ``full()`` waits on the events it copies
from.

Specs. ``P`` stands for ``PartitionSpec``: one entry per leading dim, each
``None`` (replicated), a mesh axis name or a tuple of them (major first).
``in_specs`` is one ``P`` (one argument) or a tuple of them, and likewise
``out_specs`` for the body's results. An output replicated along an axis
is taken from the shard at coordinate 0 of it.

Autograd. A shard posts a collective's tensor detached, so a peer's copy
records no edge into another thread's graph; each differentiable
collective is a ``torch.autograd.Function`` whose backward is its exact
adjoint over the whole mesh, itself a collective (``psum``'s is ``psum``,
``all_gather``'s a ``psum_scatter``, ``psum_scatter``'s the gather of
the slices, ``all_to_all``'s the inverse exchange; ``pmean`` follows
from ``psum``). ``pmax`` carries no gradient, and ``ppermute`` (the halo
exchange's, never differentiated) refuses a tensor that requires grad.
Each shard's backward then gives the gradient of the sum of the shards'
objectives, so a body whose loss is replicated over an axis seeds it
with 1 / its size, and a leaf replicated over an axis sums its shards'
gradients (``train.train_step``). A body runs with autograd's
multithreaded backward off, so that a backward it runs stays on the
shard's thread, where the adjoints meet (on a card the engine would
otherwise run it on a device thread shared by the shards). A
``shard_map`` called outside a body on inputs that require grad is
differentiable as a whole (``_ShardMapFn``).

Placement. ``NamedSharding`` pairs a mesh with a spec; ``place`` puts a
whole tree of tensors onto a mesh by a matching tree of them, leaf by leaf
(``launch.mesh.param_specs`` / ``cache_specs`` build the trees), ``zeros``
makes a laid-out zero value (a cache), ``map_shards`` a value of the same
layout from each block, and ``reshard`` lays a ``Sharded`` value out anew
(``models.sharding.constrain``). ``shard_map`` takes a
placed leaf as it is. ``current_mesh`` tells a body it runs in one.

Counting. Under the dry-run's active counter (``repro_torch.opcount``)
each shard's thread counts its work under its index, and each collective
adds its payload bytes (its operand's) on each shard under the JAX
package's names: ``psum``, ``pmean`` and ``pmax`` (and ``psum``'s
adjoint) ``all-reduce``, ``psum_scatter`` (and ``all_gather``'s adjoint)
``reduce-scatter``, ``all_gather`` ``all-gather``, ``all_to_all``
``all-to-all`` and ``ppermute`` ``collective-permute``. A mesh of
``meta`` devices runs a step's shapes without storage: no streams, no
events, the card's operators otherwise.
"""
from __future__ import annotations

import contextlib
import math
import queue
import threading
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import opcount
from repro_torch.core import sanitizer

AxisNames = Union[None, str, Tuple[str, ...]]

# seconds a shard waits at a collective for its peers
COLLECTIVE_TIMEOUT_S = 300.0


class P(tuple):
    """A partition spec: ``P("data")``, ``P(None, "data")``,
    ``P(("pod", "data"), "model")``."""

    def __new__(cls, *parts: AxisNames):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Mesh:
    """Shards laid out over named axes. ``devices`` lists the device of each
    shard in row-major order of ``shape``; a device may repeat."""

    def __init__(self, devices: Sequence, shape: Sequence[int],
                 axis_names: Sequence[str]):
        self.devices = [torch.device(d) for d in devices]
        shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names) or \
                len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} and axes {self.axis_names} "
                             f"do not match")
        if math.prod(shape) != len(self.devices) or min(shape, default=1) < 1:
            raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                             f"devices, got {len(self.devices)}")
        # insertion-ordered like jax's Mesh.shape
        self.shape: Dict[str, int] = dict(zip(self.axis_names, shape))
        self.size = len(self.devices)
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda"
                        else None for d in self.devices]
        self._workers: Optional[_Workers] = None
        self._lock = sanitizer.make_lock("Mesh._lock")

    def run(self, job: Callable[[int], None]) -> None:
        """``job(i)`` for every shard ``i``, each in the shard's worker
        thread; returns when all have returned. Calls from several threads
        take turns (interleaved, their shards would wait at each other's
        collectives). The workers start at the first call and stop when
        the mesh is collected."""
        with self._lock:
            if self._workers is None:
                self._workers = _Workers(self.size)
                weakref.finalize(self, self._workers.close)
            self._workers.run(job)

    def coords(self, index: int) -> Dict[str, int]:
        """The axis coordinates of shard ``index``."""
        out = {}
        for name in reversed(self.axis_names):
            index, out[name] = divmod(index, self.shape[name])
        return {name: out[name] for name in self.axis_names}

    def index(self, coords: Dict[str, int]) -> int:
        """The shard at ``coords``."""
        i = 0
        for name in self.axis_names:
            i = i * self.shape[name] + coords[name]
        return i

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices]})"


# ---------------------------------------------------------------------------
# Sharded values
# ---------------------------------------------------------------------------

def _axes(entry: AxisNames) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_spec(mesh: Mesh, spec: P, ndim: int) -> None:
    if not isinstance(spec, P):
        raise TypeError(f"a spec is a P(...), got {spec!r}")
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the value's "
                         f"{ndim} dims")
    used = [a for entry in spec for a in _axes(entry)]
    if len(set(used)) != len(used) or any(a not in mesh.shape for a in used):
        raise ValueError(f"spec {spec} names an axis twice or one not in "
                         f"{mesh}")


def _blocks(mesh: Mesh, spec: P, index: int,
            shape: Sequence[int]) -> Tuple[slice, ...]:
    """The region of a global value of ``shape`` that shard ``index``
    holds under ``spec``."""
    coords = mesh.coords(index)
    region = []
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        n = math.prod(mesh.shape[a] for a in axes)
        if shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {axes} ({n} shards)")
        block = 0
        for a in axes:
            block = block * mesh.shape[a] + coords[a]
        size = shape[dim] // n
        region.append(slice(block * size, (block + 1) * size))
    return tuple(region)


class Sharded:
    """A global value held as one tensor per shard of ``mesh`` under
    ``spec`` (a ``jax.Array`` with a ``NamedSharding``). ``events[i]`` is
    recorded on shard ``i``'s stream after its tensor was written (``None``
    on the CPU)."""

    def __init__(self, mesh: Mesh, spec: P, shards: List[torch.Tensor],
                 events: List[Optional[torch.cuda.Event]]):
        self.mesh, self.spec = mesh, spec
        self.shards, self.events = shards, events
        shape = list(shards[0].shape)
        for dim, entry in enumerate(spec):
            shape[dim] *= math.prod(mesh.shape[a] for a in _axes(entry))
        self.shape = tuple(shape)
        self.dtype = shards[0].dtype

    def full(self, device=None) -> torch.Tensor:
        """The global value on ``device`` (shard 0's by default)."""
        device = torch.device(device) if device is not None \
            else self.shards[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        named = {a for entry in self.spec for a in _axes(entry)}
        for i, (t, ev) in enumerate(zip(self.shards, self.events)):
            if any(c for a, c in self.mesh.coords(i).items()
                   if a not in named):
                continue                      # a replica of shard at 0
            if ev is not None:
                stream = torch.cuda.current_stream(t.device)
                stream.wait_event(ev)
                t.record_stream(stream)
            out[_blocks(self.mesh, self.spec, i, self.shape)].copy_(t)
        return out


def _recorded(mesh: Mesh, spec: P, shards: List[torch.Tensor]) -> Sharded:
    """``shards``, written on their devices' current streams, as a
    ``Sharded`` whose events follow those writes."""
    events = []
    for dev, stream, t in zip(mesh.devices, mesh.streams, shards):
        if stream is None:
            events.append(None)
            continue
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        t.record_stream(stream)
        events.append(ev)
    return Sharded(mesh, spec, shards, events)


def device_put(x: torch.Tensor, mesh: Mesh, spec: P) -> Sharded:
    """``x`` split over ``mesh`` under ``spec``, each block on its shard's
    device (a view where ``x`` already lies there)."""
    _check_spec(mesh, spec, x.dim())
    shards = []
    for i, dev in enumerate(mesh.devices):
        shards.append(x[_blocks(mesh, spec, i, x.shape)].to(dev))
    return _recorded(mesh, spec, shards)


class NamedSharding:
    """A mesh and a spec (``jax.sharding.NamedSharding``): how a global
    value of some shape lies over the mesh's shards."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of each shard's block of a value of ``shape``."""
        region = _blocks(self.mesh, self.spec, 0, shape)
        return tuple(r.stop - r.start for r in region) + tuple(
            shape[len(region):])

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and tuple(other.spec) == tuple(self.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _block_of(x: torch.Tensor, region: Tuple[slice, ...], device,
              share: bool) -> torch.Tensor:
    """Shard's block ``x[region]`` on ``device``: ``x`` itself where the
    region is all of it, it lies there and ``share`` allows; else a
    contiguous copy of its own, a stacked block (three dims or more)
    copied one leading slice at a time, so that no temporary is larger
    than one slice."""
    device = torch.device(device)
    whole = all(r.start == 0 and r.stop == n
                for r, n in zip(region, x.shape))
    if whole and share and x.device == device:
        return x
    src = x[region]
    out = torch.empty(src.shape, dtype=x.dtype, device=device)
    for dst, part in ((out, src),) if src.dim() < 3 else zip(out, src):
        dst.copy_(part)
    return out


def place(tree, shardings, *, consume: bool = False, share: bool = True):
    """A nested dict of tensors put on a mesh leaf by leaf, by the
    matching tree of ``NamedSharding`` (``launch.mesh.param_specs``): a
    nested dict of ``Sharded``. A leaf the spec splits gives each shard a
    contiguous copy of its block; a replicated one is shared by the shards
    on its own device (with ``share``; else each has a copy of its own,
    as a state the shards update in place needs) and copied to the
    others. A stacked leaf is copied one leading slice at a time
    (``_block_of``). With ``consume`` each leaf is dropped from ``tree``
    as soon as it is placed, so that the source and the placed tree are
    never both whole on a device. A leaf that is already ``Sharded`` with
    its sharding stays as it is (``unshare``d without ``share``)."""
    out = {}
    for key in list(tree):
        leaf, sh = tree[key], shardings[key]
        if isinstance(leaf, dict):
            out[key] = place(leaf, sh, consume=consume, share=share)
        elif isinstance(leaf, Sharded) and leaf.mesh is sh.mesh \
                and tuple(leaf.spec) == tuple(sh.spec):
            out[key] = leaf if share else unshare(leaf)
        else:
            if isinstance(leaf, Sharded):
                leaf = leaf.full()
            leaf = leaf.detach()
            _check_spec(sh.mesh, sh.spec, leaf.dim())
            out[key] = _recorded(sh.mesh, sh.spec, [
                _block_of(leaf, _blocks(sh.mesh, sh.spec, i, leaf.shape),
                          dev, share=share)
                for i, dev in enumerate(sh.mesh.devices)])
        if consume:
            del tree[key]
        del leaf
    return out


def shares(x: Sharded) -> bool:
    """Whether two shards of ``x`` hold one tensor (``place``'s replicas
    on one device): by storage identity, which a ``meta`` tensor has too
    (its ``data_ptr()`` is 0)."""
    held = [t.untyped_storage()._cdata for t in x.shards if t.numel()]
    return len(set(held)) != len(held)


def unshare(x: Sharded) -> Sharded:
    """``x`` with a tensor of its own for every shard: where shards share
    one (``shares``), a copy for each."""
    return map_shards(torch.clone, x) if shares(x) else x


def zeros(shape: Sequence[int], dtype: torch.dtype,
          sharding: NamedSharding) -> Sharded:
    """A zero value of ``shape`` laid out by ``sharding``, every shard's
    block a tensor of its own (replicas too: each shard writes its own)."""
    mesh, spec = sharding.mesh, sharding.spec
    _check_spec(mesh, spec, len(shape))
    local = sharding.shard_shape(shape)
    return _recorded(mesh, spec, [torch.zeros(local, dtype=dtype, device=d)
                                  for d in mesh.devices])


def map_shards(fn: Callable[[torch.Tensor], torch.Tensor],
               x: Sharded) -> Sharded:
    """``fn`` of each shard's block of ``x`` (on its device, after its
    event), laid out as ``x`` is: a value of the same spec, each block
    ``fn``'s result (a float32 copy of a placed leaf, say)."""
    shards = []
    for t, ev in zip(x.shards, x.events):
        if ev is None:
            shards.append(fn(t))
            continue
        torch.cuda.current_stream(t.device).wait_event(ev)
        with torch.cuda.device(t.device):
            shards.append(fn(t))
    return _recorded(x.mesh, x.spec, shards)


def reshard(x: Sharded, spec: P) -> Sharded:
    """``x`` laid out by ``spec`` over its mesh, its value unchanged. Where
    each shard's new block lies inside its old one (the spec adds an axis,
    or keeps them) the shard slices what it holds; otherwise (the spec
    drops or moves an axis) the value is gathered and split again."""
    mesh = x.mesh
    _check_spec(mesh, spec, len(x.shape))
    if tuple(spec) == tuple(x.spec):
        return x
    shards = []
    for i, t in enumerate(x.shards):
        old = _blocks(mesh, x.spec, i, x.shape)
        new = _blocks(mesh, spec, i, x.shape)
        old = old + tuple(slice(0, n) for n in x.shape[len(old):])
        new = new + tuple(slice(0, n) for n in x.shape[len(new):])
        if any(n.start < o.start or n.stop > o.stop
               for o, n in zip(old, new)):
            return device_put(x.full(), mesh, spec)
        if x.events[i] is not None:
            torch.cuda.current_stream(t.device).wait_event(x.events[i])
        shards.append(t[tuple(slice(n.start - o.start, n.stop - o.start)
                              for o, n in zip(old, new))])
    return _recorded(mesh, spec, shards)


# ---------------------------------------------------------------------------
# shard_map
# ---------------------------------------------------------------------------

class _Workers:
    """One daemon thread per shard, fed jobs by a queue each: a call costs
    a wake-up per shard, not a thread's start and join."""

    def __init__(self, n: int):
        self.queues = [queue.SimpleQueue() for _ in range(n)]
        self.threads = [threading.Thread(target=self._loop, args=(q, i),
                                         daemon=True, name=f"shard{i}")
                        for i, q in enumerate(self.queues)]
        for t in self.threads:
            t.start()

    @staticmethod
    def _loop(q: queue.SimpleQueue, i: int) -> None:
        while True:
            job = q.get()
            if job is None:
                return
            job(i)
            # the finished job holds its call's inputs and the mesh, whose
            # collection stops these threads: let both go
            del job

    def run(self, job: Callable[[int], None]) -> None:
        done = threading.Barrier(len(self.queues) + 1)

        def task(i: int) -> None:
            try:
                job(i)
            finally:
                done.wait()

        for q in self.queues:
            q.put(task)
        done.wait()

    def close(self) -> None:
        """Stop the workers and wait for them: a worker still running when
        the interpreter tears down would abort the process."""
        for q in self.queues:
            q.put(None)
        for t in self.threads:
            if t is not threading.current_thread():
                t.join(timeout=COLLECTIVE_TIMEOUT_S)


class _Group:
    """The rendezvous of one ``shard_map`` call's shards, which take turns:
    one shard's thread runs at a time, from one collective to the next,
    then hands the turn to the next shard in index order (``step``). So the
    shards never contend for the interpreter (each torch call releases and
    retakes it; four threads doing so at once cost several times the
    call), while CUDA shards' streams still run concurrently (CPU shards,
    which compute as they issue, run one after another). When a shard has
    the turn back after posting collective ``k``, every shard
    has posted ``k``. Collective ``k`` posts into ``slots[k % 2]``: a shard
    can post ``k + 2`` only after the others have passed ``k + 1``, hence
    read ``k``."""

    def __init__(self, n: int):
        self.n = n
        self.slots = [[None] * n, [None] * n]
        self.calls = [0] * n          # collectives each shard has posted
        self.done = [False] * n
        self.broken = False
        # only the shard holding the turn changes the state below
        self._go = [threading.Semaphore(0) for _ in range(n)]
        self._go[0].release()

    def wait_turn(self, i: int) -> None:
        # a peer that never hands the turn on fails the others after the
        # timeout instead of hanging them
        if not self._go[i].acquire(timeout=COLLECTIVE_TIMEOUT_S) \
                or self.broken:
            raise threading.BrokenBarrierError

    def _pass(self, i: int) -> None:
        j = (i + 1) % self.n
        while self.done[j] and j != i:
            j = (j + 1) % self.n
        if not self.done[j]:
            self._go[j].release()

    def step(self, i: int) -> None:
        """Shard ``i`` posted a collective: hand the turn on and wait for
        it to come back, when every shard has posted it too."""
        self.calls[i] += 1
        self._pass(i)
        self.wait_turn(i)
        if any(c < self.calls[i] for c in self.calls):
            # a shard returned without making this collective
            raise RuntimeError("a shard_map body skipped a collective its "
                               "peers made")

    def finish(self, i: int) -> None:
        self.done[i] = True
        self._pass(i)

    def abort(self) -> None:
        """Wake every shard waiting for its turn, to fail."""
        self.broken = True
        for go in self._go:
            go.release()


class _Shard(threading.local):
    mesh: Optional[Mesh] = None


_CTX = _Shard()


def current_mesh() -> Optional[Mesh]:
    """The mesh whose ``shard_map`` body runs in this thread (None outside
    a body)."""
    return _CTX.mesh


def _ctx():
    if _CTX.mesh is None:
        raise NameError("unbound axis name: SPMD collectives run inside "
                        "shard_map")
    return _CTX


class _Posted:
    """A tensor a shard posts to a collective, with the event its readers
    wait on. It is posted detached: a peer's copy of it records no
    autograd edge into this shard's graph (the collectives' gradients come
    from their adjoints, module docstring)."""

    def __init__(self, t: torch.Tensor):
        self.t = t.detach()
        self.event = None
        if t.device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))


def _exchange(t: torch.Tensor) -> List[_Posted]:
    """Post ``t``; after every shard of the call has posted, return what
    each posted (indexed by shard)."""
    ctx = _ctx()
    slots = ctx.group.slots[ctx.count % 2]
    ctx.count += 1
    slots[ctx.index] = _Posted(t)
    ctx.group.step(ctx.index)
    return list(slots)


def _copy(posted: _Posted, src: torch.Tensor, out: torch.Tensor) -> None:
    """Copy ``src`` (``posted``'s tensor or a view of it) into ``out``,
    ordered after the peer's producer by its event and before this
    shard's later work."""
    if posted.event is None:
        out.copy_(src)
        return
    torch.cuda.current_stream(out.device).wait_event(posted.event)
    # a copy between cards runs on the source card's current stream, which
    # torch orders after this shard's stream and before its later work
    out.copy_(src, non_blocking=True)
    src.record_stream(torch.cuda.current_stream(src.device))


def _receive(posted: _Posted, device: torch.device) -> torch.Tensor:
    """A copy of a peer's posted tensor on ``device``."""
    out = torch.empty_like(posted.t, device=device)
    _copy(posted, posted.t, out)
    return out


def _peer(axis_name: str, coord: int) -> int:
    """The shard at ``coord`` along ``axis_name`` and this shard's
    coordinates along every other axis."""
    ctx = _ctx()
    coords = dict(ctx.coords)
    coords[axis_name] = coord
    return ctx.mesh.index(coords)


def axis_index(axis_name: str) -> int:
    """This shard's coordinate along ``axis_name``."""
    ctx = _ctx()
    if axis_name not in ctx.coords:
        raise NameError(f"unbound axis name: {axis_name}")
    return ctx.coords[axis_name]


def axis_size(axis_name: str) -> int:
    axis_index(axis_name)
    return _ctx().mesh.shape[axis_name]


def axes_index(axes: Sequence[str]) -> Tuple[int, int]:
    """This shard's coordinate along ``axes`` taken as one (major first,
    as a spec entry names them) and their number of shards."""
    index, size = 0, 1
    for a in axes:
        index = index * axis_size(a) + axis_index(a)
        size *= axis_size(a)
    return index, size


def ppermute(x: torch.Tensor, axis_name: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Shard ``src`` sends ``x`` to ``dst`` along ``axis_name`` for each
    ``(src, dst)`` of ``perm``; a shard that no pair names as its ``dst``
    gets zeros. A source may send to several shards. It has no adjoint:
    a tensor that requires grad is refused, since its copy would carry
    none."""
    if x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("ppermute is not differentiable: its input "
                           "requires grad")
    me = axis_index(axis_name)
    n = axis_size(axis_name)
    src_of: Dict[int, int] = {}
    for s, d in perm:
        if not (0 <= s < n and 0 <= d < n) or d in src_of:
            raise ValueError(f"bad permutation {list(perm)} over {n} shards")
        src_of[d] = s
    opcount.collective("collective-permute", x.numel() * x.element_size())
    posted = _exchange(x)
    if me not in src_of:
        return torch.zeros_like(x)
    return _receive(posted[_peer(axis_name, src_of[me])], x.device)


def _fold(x: torch.Tensor, axis_name: str, op, kind: str,
          dim: Optional[int] = None) -> torch.Tensor:
    """``op`` over the shards along ``axis_name``, folded in coordinate
    order on every shard, so that all get the same bits; counted under
    ``kind``. With ``dim``, only this shard's slice along it (the shard at
    coordinate ``c`` the ``c``-th of as many equal slices as shards): each
    shard copies only that slice of each peer's posted tensor, and gets
    the bits the whole fold gives it."""
    n = axis_size(axis_name)
    me = axis_index(axis_name)
    if dim is not None and x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} shards")

    def mine(t):
        if dim is None:
            return t
        size = t.shape[dim] // n
        return t.narrow(dim, me * size, size)

    opcount.collective(kind, x.numel() * x.element_size())
    posted = _exchange(x)
    acc = None
    for c in range(n):
        if c == me:
            v = mine(x)
        else:
            src = posted[_peer(axis_name, c)]
            part = mine(src.t)
            v = torch.empty_like(part, device=x.device)
            _copy(src, part, v)
        # into the one copy made: a gradient's reduction holds no more
        acc = v.clone() if acc is None else op(acc, v, out=acc)
        del v
    return acc


def _reduce(x: torch.Tensor, axis_name: str, op) -> torch.Tensor:
    return _fold(x, axis_name, op, "all-reduce")


class _PSum(torch.autograd.Function):
    """``psum``; its adjoint is itself."""

    @staticmethod
    def forward(ctx, x, axis_name):
        ctx.axis_name = axis_name
        return _reduce(x, axis_name, torch.add)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g.contiguous(), ctx.axis_name, torch.add), None


def psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    return _PSum.apply(x, axis_name)


def pmean(x: torch.Tensor, axis_name: AxisNames) -> torch.Tensor:
    """``psum`` over ``axis_name`` (one axis or a tuple of them, reduced in
    turn) divided by the number of shards it spans: every shard gets the
    same bits."""
    n = 1
    for a in _axes(axis_name):
        x = psum(x, a)
        n *= axis_size(a)
    return x / n


def _all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    n = axis_size(axis_name)
    me = axis_index(axis_name)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split over {n} shards")
    size = x.shape[split_axis] // n
    shape = list(x.shape)
    shape[split_axis] = size
    width = shape[concat_axis]
    shape[concat_axis] *= n
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    opcount.collective("all-to-all", x.numel() * x.element_size())
    posted = _exchange(x)
    for c in range(n):
        src = posted[_peer(axis_name, c)]
        _copy(src, src.t.narrow(split_axis, me * size, size),
              out.narrow(concat_axis, c * width, width))
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all``; its adjoint is the inverse exchange (split and
    concatenated axes swapped)."""

    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis):
        ctx.args = (axis_name, concat_axis, split_axis)
        return _all_to_all(x, axis_name, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g.contiguous(), *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, *, tiled: bool = False) -> torch.Tensor:
    """``x`` split along ``split_axis`` into one chunk per shard along
    ``axis_name``: chunk ``j`` goes to the shard at coordinate ``j``,
    which concatenates what it receives along ``concat_axis`` in the
    order of the senders' coordinates. Each shard copies only the chunk
    addressed to it, a view of the sender's posted tensor. Only JAX's
    ``tiled=True`` form."""
    if not tiled:
        raise NotImplementedError("all_to_all: only tiled=True is ported")
    return _AllToAll.apply(x, axis_name, split_axis, concat_axis)


def _all_gather(x: torch.Tensor, axis_name: str,
                tiled_dim: Optional[int] = None) -> torch.Tensor:
    n = axis_size(axis_name)
    me = axis_index(axis_name)
    opcount.collective("all-gather", x.numel() * x.element_size())
    posted = _exchange(x)
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    for c in range(n):
        if c == me:
            out[c].copy_(x)
        else:
            src = posted[_peer(axis_name, c)]
            _copy(src, src.t, out[c])
    if tiled_dim is None:
        return out
    return out.movedim(0, tiled_dim).flatten(tiled_dim, tiled_dim + 1)


def _reduce_scatter(x: torch.Tensor, axis_name: str,
                    dim: int) -> torch.Tensor:
    return _fold(x, axis_name, torch.add, "reduce-scatter", dim)


class _AllGather(torch.autograd.Function):
    """``all_gather``; its adjoint sums the gradient over the shards and
    keeps this shard's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, axis_name, tiled_dim):
        ctx.args = (axis_name, tiled_dim)
        return _all_gather(x, axis_name, tiled_dim)

    @staticmethod
    def backward(ctx, g):
        a, dim = ctx.args
        if dim is None:
            return _reduce_scatter(g.contiguous(), a, 0)[0], None, None
        return _reduce_scatter(g.contiguous(), a, dim), None, None


def all_gather(x: torch.Tensor, axis_name: str, *,
               tiled_dim: Optional[int] = None) -> torch.Tensor:
    """Every shard's ``x`` along ``axis_name``, stacked on a new leading
    axis in coordinate order (``jax.lax.all_gather`` untiled): the same
    bits on every shard. With ``tiled_dim``, joined along that dim
    instead (``tiled=True, axis=tiled_dim``)."""
    return _AllGather.apply(x, axis_name, tiled_dim)


class _PSumScatter(torch.autograd.Function):
    """``psum_scatter``; its adjoint gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.args = (axis_name, dim)
        return _reduce_scatter(x, axis_name, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), *ctx.args), None, None


def psum_scatter(x: torch.Tensor, axis_name: str, dim: int) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis_name, scatter_dimension=dim,
    tiled=True)``: the sum of the shards' ``x`` along ``axis_name``, of
    which each shard keeps its slice along ``dim`` (the shard at
    coordinate ``c`` the ``c``-th of as many equal slices as shards)."""
    return _PSumScatter.apply(x, axis_name, dim)


def pmax(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The maximum over the shards along ``axis_name``. It carries no
    gradient: its one use under autograd is the shift of a stable
    logsumexp, which the result does not depend on."""
    return _reduce(x.detach(), axis_name, torch.maximum)


def bulk_barrier(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Every shard's work up to ``xs`` completes before any shard's work
    after the call: each shard's stream waits on every shard's event. The
    bulk-synchronous schedule, where JAX's body uses
    ``optimization_barrier``. Returns ``xs``."""
    ctx = _ctx()
    posted = _exchange(xs[0])
    stream = ctx.mesh.streams[ctx.index]
    if stream is not None:
        for p in posted:
            stream.wait_event(p.event)
    return xs


def _split(arg, spec: P, mesh: Mesh) -> List[torch.Tensor]:
    """Each shard's block of one input, on its device."""
    if isinstance(arg, Sharded):
        if arg.mesh is mesh and tuple(arg.spec) == tuple(spec):
            return list(arg.shards)
        arg = arg.full()
    return device_put(arg, mesh, spec).shards


def _run_shards(mesh: Mesh, job: Callable[[int], tuple],
                blocks: Sequence[List[torch.Tensor]] = ()) -> List[tuple]:
    """``job(i)`` for every shard ``i`` of ``mesh`` in the shard's worker
    thread, with its coordinates bound (the collectives' rendezvous), its
    device and stream current, the shards taking turns (``_Group``), and
    autograd's backward run on the calling thread
    (``set_multithreading_enabled(False)``: on a card the engine would
    otherwise run it on a device thread of its own, shared by the shards
    and outside their bindings). ``blocks`` are the inputs' blocks the job
    reads. Returns (``job(i)``, the event recorded on shard ``i``'s stream
    after it) for each shard."""
    # each shard's stream starts after the caller's work on its device
    for dev, stream in zip(mesh.devices, mesh.streams):
        if stream is not None:
            stream.wait_stream(torch.cuda.current_stream(dev))
    group = _Group(mesh.size)
    results: List = [None] * mesh.size
    errors: List[BaseException] = []

    def body(i: int) -> None:
        dev, stream = mesh.devices[i], mesh.streams[i]
        _CTX.mesh, _CTX.index, _CTX.coords = mesh, i, mesh.coords(i)
        _CTX.group, _CTX.count = group, 0
        try:
            group.wait_turn(i)
            with contextlib.ExitStack() as stack:
                stack.enter_context(
                    torch.autograd.set_multithreading_enabled(False))
                stack.enter_context(opcount.shard_scope(i))
                if stream is not None:
                    stack.enter_context(torch.cuda.device(dev))
                    stack.enter_context(torch.cuda.stream(stream))
                    for b in blocks:
                        b[i].record_stream(stream)
                out = job(i)
                ev = None
                if stream is not None:
                    ev = torch.cuda.Event()
                    ev.record(stream)
                results[i] = (out, ev)
            group.finish(i)
        except BaseException as e:   # re-raised by the caller below
            errors.append(e)
            group.abort()            # wake peers held at a collective
        finally:
            # the group holds the last collectives' posted tensors
            _CTX.mesh = _CTX.group = None

    mesh.run(body)
    if errors:
        raise next((e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return results


def _outputs(fn: Callable, single_out: bool, n_out: int, args) -> tuple:
    out = fn(*args)
    out = (out,) if single_out else tuple(out)
    if len(out) != n_out:
        raise ValueError(f"shard_map body returned {len(out)} values for "
                         f"{n_out} out_specs")
    return out


class _ShardMapFn(torch.autograd.Function):
    """A ``shard_map`` called outside a body on inputs that require grad:
    the forward runs each shard's body recording its own graph (from
    detached leaves of its blocks); the backward runs each shard's
    backward in its own thread (another ``_run_shards``), where the
    collectives' adjoints meet, and adds each shard's gradient into its
    block of the input (the replicas of a replicated input sum). Its
    outputs are the shards' results, output-major."""

    @staticmethod
    def forward(ctx, call, *args):
        mesh, per_arg = call["mesh"], call["per_arg"]
        diff = [j for j, a in enumerate(args)
                if isinstance(a, torch.Tensor) and a.requires_grad]
        leaves: List = [None] * mesh.size
        outs: List = [None] * mesh.size

        def job(i):
            with torch.enable_grad():
                xs = [b[i] for b in per_arg]
                for j in diff:
                    xs[j] = xs[j].detach().requires_grad_()
                leaves[i] = [xs[j] for j in diff]
                outs[i] = _outputs(call["fn"], call["single_out"],
                                   call["n_out"], xs)
            return tuple(o.detach() for o in outs[i])

        results = _run_shards(mesh, job, per_arg)
        ctx.call, ctx.diff, ctx.leaves, ctx.outs = call, diff, leaves, outs
        ctx.shapes = [tuple(a.shape) if isinstance(a, torch.Tensor)
                      else None for a in args]
        ctx.devices = [getattr(a, "device", None) for a in args]
        call["events"] = [ev for _, ev in results]
        return tuple(results[i][0][k] for k in range(call["n_out"])
                     for i in range(mesh.size))

    @staticmethod
    def backward(ctx, *grads):
        call, diff = ctx.call, ctx.diff
        mesh, n = call["mesh"], call["mesh"].size

        def job(i):
            pairs = [(o, grads[k * n + i]) for k, o in enumerate(ctx.outs[i])
                     if o.requires_grad]
            if not pairs:
                return (None,) * len(diff)
            return torch.autograd.grad(
                [o for o, _ in pairs], ctx.leaves[i],
                [g.to(o.device) for o, g in pairs], allow_unused=True)

        results = _run_shards(mesh, job)
        out: List = [None] * len(ctx.shapes)
        for k, j in enumerate(diff):
            dev, shape = ctx.devices[j], ctx.shapes[j]
            total = torch.zeros(shape, dtype=ctx.leaves[0][k].dtype,
                                device=dev)
            for i, (gs, ev) in enumerate(results):
                if gs[k] is None:
                    continue
                if ev is not None:
                    torch.cuda.current_stream(gs[k].device).wait_event(ev)
                total[_blocks(mesh, call["in_specs"][j], i, shape)] += \
                    gs[k].to(dev)
            out[j] = total
        del ctx.leaves, ctx.outs
        return (None, *out)


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``fn`` applied to each shard's blocks of the inputs, in a thread per
    shard; returns a ``Sharded`` per output (one, or a tuple as
    ``out_specs`` is). Where grad mode is on and an input tensor requires
    grad, the call is differentiable (``_ShardMapFn``), as JAX's is."""
    single_in = isinstance(in_specs, P)
    single_out = isinstance(out_specs, P)
    ins = (in_specs,) if single_in else tuple(in_specs)
    outs = (out_specs,) if single_out else tuple(out_specs)

    def run(*args):
        if _CTX.mesh is not None:
            raise RuntimeError("shard_map does not nest")
        if len(args) != len(ins):
            raise TypeError(f"shard_map body takes {len(ins)} arguments, "
                            f"got {len(args)}")
        with torch.no_grad():
            per_arg = [_split(a, s, mesh) for a, s in zip(args, ins)]
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args):
            call = {"mesh": mesh, "fn": fn, "per_arg": per_arg,
                    "single_out": single_out, "n_out": len(outs),
                    "in_specs": ins}
            flat = _ShardMapFn.apply(call, *args)
            shards = [flat[k * mesh.size:(k + 1) * mesh.size]
                      for k in range(len(outs))]
            events = call.pop("events")
            del call["per_arg"]
        else:
            results = _run_shards(
                mesh, lambda i: _outputs(fn, single_out, len(outs),
                                         [b[i] for b in per_arg]), per_arg)
            shards = [[results[i][0][k] for i in range(mesh.size)]
                      for k in range(len(outs))]
            events = [ev for _, ev in results]
        values = []
        for spec, sh in zip(outs, shards):
            _check_spec(mesh, spec, sh[0].dim())
            values.append(Sharded(mesh, spec, list(sh), events))
        return values[0] if single_out else tuple(values)

    return run
