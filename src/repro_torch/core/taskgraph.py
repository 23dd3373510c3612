"""Compiled task-graph fast path: trace → compile → replay
(``repro/core/taskgraph.py`` at the same path).

Per-task runtime overhead — future resolution, ledger lookups, lane hops,
dependency inference, and on a card one launch of Python per kernel —
dominates recurring DAGs of small tasks (Jacobi sweeps, decode steps,
microbatch steps). This module removes it for windows that recur:

  trace    ``GraphTracer`` records each ``Runtime.submit`` between two
           window boundaries (``Runtime.step_boundary()`` or
           ``Runtime.barrier()``) as a canonical node: kernel identity,
           argument topology (object slots by first occurrence), access
           modes, shapes and dtypes, device-type preference. The
           per-window structural key detects recurrence across
           consecutive windows.

  compile  on the ``replay_after``-th identical window the tracer waits
           for that window's (already interpreted) tasks, captures the
           scheduler's placement decisions, and compiles a
           ``TracedGraph``: maximal same-device runs of nodes become one
           chain each (submission order is a topological order, so
           running chains in order is dependency-correct); entry
           transfers are pre-planned once from the residency ledger.

  replay   later submits that match the compiled structure are *parked*
           — no pins, no dependency inference, no scheduler, no per-task
           lane hop. At the window boundary the whole DAG runs as one
           replay: entry copies as a batch, one dispatch per chain,
           outputs rebound to their hetero_objects, every parked future
           resolved at once. Interior futures resolve with ``None``.

  invalidate  anything the trace cannot vouch for falls back to
           interpreted mode and re-traces: a submit that deviates from
           the recorded structure (shape changes appear here, as other
           objects), eviction of a pre-planned replica (detected at
           replay; the window still runs correctly, then drops the
           graph), ``Runtime.invalidate_traces``, or a mid-window host
           access (parked tasks flush through the interpreted path).

The chain, where the JAX package fuses it under ``jax.jit``:

  * on a CUDA device it is captured once, at its first replay, as a
    ``torch.cuda.CUDAGraph`` on the device's compute stream, and every
    later window is one ``graph.replay()``. The compile window ran
    interpreted, so every hand-written kernel is built and configured
    before the capture. A capture that fails raises into the window's
    futures, like a failing task;
  * on a CPU device it runs eagerly.

Static buffers (CUDA). The graph is captured on the window objects' own
tensors, so an input whose object still holds the captured tensor needs
no copy: a cache that the chain writes in place (the tasked decode loop's
K/V cache) is never copied. Outputs the graph allocates live in its
private pool and are rewritten by the next replay; the objects rebound to
them are their only holders (host reads download, device views and DIRECT
sends clone). An object the window writes out of place (a Jacobi chunk:
``u_new = f(u)``) is rebound to the graph's output, so at the next replay
its tensor is not the captured input and is copied into it first — one
device copy of the object per window (a 768³ float32 domain: 1.8 GB read
and written, about 1.1 ms at 3.35 TB/s). That copy writes only tensors the
window itself writes: an argument written by a task is the runtime's to
overwrite (the Device API's donation contract). A read-only input whose
object was rebound elsewhere is never written over: that window runs its
chains without the graph and the graph is dropped, like an evicted
replica.

Kernel launches captured in a graph run at every replay and never at the
capture: each chain records the launches its capture counted
(``kernels.recording_launches``) and adds them to ``kernels.LAUNCHES`` at
each replay.

Nothing here runs unless ``RuntimeConfig.trace_graphs`` is set; drivers
mark step edges with ``runtime.step_boundary()`` (a no-op otherwise).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import device_api, sanitizer
from repro_torch.core.device_api import TorchDevice
from repro_torch.core.hetero_object import HOST
from repro_torch.core.hetero_task import HeteroTask, TaskState

__all__ = ["GraphTracer", "TracedGraph"]

_COMPILE_WAIT_S = 120.0


class _Node:
    """One recorded submit, canonicalized against the window's slot map."""

    __slots__ = ("kernel", "device", "device_type", "arg_slots", "modes",
                 "write_slots")

    def __init__(self, kernel, device, device_type, arg_slots, modes,
                 write_slots):
        self.kernel = kernel
        self.device = device
        self.device_type = device_type
        self.arg_slots = arg_slots        # tuple[slot] in arg order
        self.modes = modes                # tuple[Access] in arg order
        self.write_slots = write_slots    # tuple[slot], write-args in order


class _Chain:
    """A maximal same-device run of nodes run as one dispatch. On a CUDA
    device ``graph`` holds its capture (``None`` until the first replay),
    ``static_in`` the tensors it reads, ``static_out`` those it writes and
    ``launches`` the kernel launches each replay makes."""

    __slots__ = ("device", "fn", "in_slots", "out_slots", "written_in",
                 "graph", "static_in", "static_out", "launches")

    def __init__(self, device, fn, in_slots, out_slots, written_in):
        self.device = device
        self.fn = fn
        self.in_slots = in_slots
        self.out_slots = out_slots
        # per input: does the window write this slot (may a replay copy
        # into its captured tensor)?
        self.written_in = written_in
        self.graph = None
        self.static_in: Tuple[Any, ...] = ()
        self.static_out: Tuple[Any, ...] = ()
        self.launches: Dict[str, int] = {}


def _make_chain_fn(specs, in_slots, out_slots):
    """Compose a window chain into one callable. ``specs`` is
    [(kernel, arg_slots, write_slots, donate)] in submission order; the
    closure threads slot values through an env exactly the way the
    interpreted path threads written tensors through the hetero_objects,
    and each kernel keeps its task's aliasing contract (it may write in
    place only its write-arguments; an output that is a view of another
    argument is copied)."""
    checked = [(device_api._checked(kern, donate), arg_slots, write_slots)
               for kern, arg_slots, write_slots, donate in specs]

    def chain_fn(*xs):
        env = dict(zip(in_slots, xs, strict=True))
        for kern, arg_slots, write_slots in checked:
            res = kern(*(env[s] for s in arg_slots))
            outs = res if isinstance(res, (tuple, list)) else (res,)
            for ws, out in zip(write_slots, outs, strict=False):
                env[ws] = out
        return tuple(env[s] for s in out_slots)

    return chain_fn


class TracedGraph:
    """A compiled recurring window: chains + pre-planned entries.

    ``objects`` holds the window's hetero_objects by slot (strong refs —
    replay matching is by object identity). ``entries`` lists
    ``(slot, device, expected_resident)``: the batch of input copies the
    replay issues up front, with the residency expectation captured once
    from the ledger at compile time. ``chains`` run in submission order;
    cross-chain values travel through the replay env, not through the
    objects, so objects are rebound exactly once per window."""

    __slots__ = ("key", "nodes", "objects", "chains", "entries", "replays")

    def __init__(self, key, nodes, objects, chains, entries):
        self.key = key
        self.nodes = nodes
        self.objects = objects
        self.chains = chains
        self.entries = entries
        self.replays = 0

    def __repr__(self):
        return (f"TracedGraph(tasks={len(self.nodes)}, "
                f"chains={len(self.chains)}, entries={len(self.entries)}, "
                f"replays={self.replays})")


class _Stale(Exception):
    """A captured chain cannot replay this window (a read-only input was
    rebound): the window runs without the graph, which is then dropped."""


class GraphTracer:
    """Records submit windows, detects recurrence, compiles and replays.

    Driven by three runtime hooks: ``on_submit`` (park or record),
    ``on_boundary`` (close a window: replay, compile, or advance the
    recurrence streak), and ``flush`` (a mid-window host access forces
    parked tasks through the interpreted path). All state is guarded by
    one reentrant lock; the expected producer is the driver thread, but
    ``invalidate`` may arrive from another thread."""

    def __init__(self, runtime, replay_after: int = 3):
        self.rt = runtime
        self.replay_after = max(1, int(replay_after))
        self._lock = sanitizer.make_rlock("GraphTracer._lock")
        self._window: List[Tuple[HeteroTask, Callable]] = []
        self._prev_key: Optional[Tuple] = None
        self._streak = 0
        self._graph: Optional[TracedGraph] = None
        self._parked: List[HeteroTask] = []
        self._match_idx = 0
        # set when the current window already diverged from the armed
        # graph for a benign reason (host access flush): skip matching
        # until the next boundary but keep the graph armed
        self._deviated = False

    # -- introspection -------------------------------------------------
    def graph(self) -> Optional[TracedGraph]:
        with self._lock:
            return self._graph

    # -- runtime hooks -------------------------------------------------
    def on_submit(self, task: HeteroTask, kernel: Callable) -> bool:
        """True → the task was parked for replay (caller must not
        schedule it); False → record it and run interpreted."""
        with self._lock:
            g = self._graph
            if g is not None and not self._deviated:
                if (self._match_idx < len(g.nodes)
                        and self._matches(g.nodes[self._match_idx], task,
                                          kernel)):
                    self._parked.append(task)
                    self._match_idx += 1
                    return True
                # structural deviation: drop the graph and fall back to
                # interpreted re-tracing
                self._invalidate_locked()
            self._window.append((task, kernel))
            return False

    def on_boundary(self) -> None:
        """Close the current window: replay a fully-matched one, compile
        on the Nth recurrence, or just advance the streak."""
        with self._lock:
            g = self._graph
            if g is not None and not self._deviated and self._parked:
                if self._match_idx == len(g.nodes):
                    self._replay_locked()
                    return
                # fewer submits than the trace expects: structure changed
                self._invalidate_locked()
            self._deviated = False
            if not self._window:
                return
            key = tuple(self._sig(t, k) for t, k in self._window)
            if key == self._prev_key:
                self._streak += 1
            else:
                self._prev_key = key
                self._streak = 1
            window, self._window = self._window, []
            if self._graph is None and self._streak >= self.replay_after:
                self._compile(window, key)

    def flush(self) -> None:
        """A host access (``request_host`` / device view / rebind) landed
        mid-window: parked tasks must become real tasks so the access
        observes their writes. The graph stays armed — matching resumes
        at the next boundary."""
        with self._lock:
            if not self._parked:
                return
            self._deviated = True
            self._release_parked_locked()

    def invalidate(self) -> None:
        """External invalidation (manual, or an epoch change): drop the
        compiled graph and restart recurrence detection."""
        with self._lock:
            if self._graph is not None or self._parked:
                self._invalidate_locked()
            self._prev_key = None
            self._streak = 0

    # -- internals -----------------------------------------------------
    @staticmethod
    def _sig(task: HeteroTask, kernel: Callable) -> Tuple:
        return (id(kernel), task.device_type,
                tuple((id(r.obj), r.access.name, r.obj.shape,
                       str(r.obj.dtype)) for r in task.args),
                bool(task.explicit_deps))

    def _matches(self, node: _Node, task: HeteroTask,
                 kernel: Callable) -> bool:
        if kernel is not node.kernel or task.explicit_deps:
            return False
        if task.device_type != node.device_type:
            return False
        if len(task.args) != len(node.arg_slots):
            return False
        objects = self._graph.objects
        for ref, slot, mode in zip(task.args, node.arg_slots, node.modes,
                                   strict=False):
            if ref.obj is not objects[slot] or ref.access is not mode:
                return False
        return True

    def _release_parked_locked(self) -> None:
        """Move parked tasks back onto the interpreted path, in order,
        and fold them into the recording window so the re-trace sees the
        true submit sequence."""
        parked, self._parked = self._parked, []
        self._match_idx = 0
        for t in parked:
            self._window.append((t, t.kernel))
            self.rt._enqueue(t)

    def _invalidate_locked(self) -> None:
        if self._graph is not None:
            self._graph = None
            self.rt._stats["graph_invalidations"] += 1
        self._prev_key = None
        self._streak = 0
        self._release_parked_locked()

    def _compile(self, window, key) -> None:
        """Compile the just-executed window into a TracedGraph. The
        window's tasks ran interpreted; waiting on their futures captures
        the scheduler's placement decisions and guarantees the residency
        snapshot below describes the steady state a replayed window
        starts from."""
        rt = self.rt
        tasks = [t for t, _ in window]
        try:
            for t in tasks:
                t.future.get(timeout=_COMPILE_WAIT_S)
        except BaseException:
            self._streak = 0          # failing window: don't compile it
            return
        if any(t.chosen_device is None for t in tasks):
            return
        # slots by first occurrence across the window
        slot_of: Dict[int, int] = {}
        objects: List[Any] = []
        nodes: List[_Node] = []
        for task, kernel in window:
            arg_slots, modes, write_slots = [], [], []
            for ref in task.args:
                s = slot_of.get(id(ref.obj))
                if s is None:
                    s = slot_of[id(ref.obj)] = len(objects)
                    objects.append(ref.obj)
                arg_slots.append(s)
                modes.append(ref.access)
                if ref.access.writes:
                    write_slots.append(s)
            nodes.append(_Node(kernel, task.chosen_device, task.device_type,
                               tuple(arg_slots), tuple(modes),
                               tuple(write_slots)))
        window_written = {s for node in nodes for s in node.write_slots}
        # fuse maximal same-device runs (submission order is topological)
        chains: List[_Chain] = []
        entries: List[Tuple[int, int, bool]] = []
        produced: set = set()      # slots written by earlier chains
        planned: set = set()       # (slot, device) entry pairs planned
        i = 0
        while i < len(nodes):
            dev = nodes[i].device
            j = i
            while j < len(nodes) and nodes[j].device == dev:
                j += 1
            run = nodes[i:j]
            specs, in_slots, written = [], [], set()
            for node in run:
                for s in node.arg_slots:
                    if s not in written and s not in in_slots:
                        in_slots.append(s)
                written.update(node.write_slots)
                specs.append((node.kernel, node.arg_slots,
                              node.write_slots,
                              frozenset(k for k, m in enumerate(node.modes)
                                        if m.writes)))
            out_slots = []
            for node in run:
                for s in node.write_slots:
                    if s not in out_slots:
                        out_slots.append(s)
            for s in in_slots:
                if s not in produced and (s, dev) not in planned:
                    planned.add((s, dev))
                    entries.append(
                        (s, dev,
                         dev in rt.residency.devices_of(objects[s])))
            produced.update(written)
            chains.append(_Chain(
                dev, _make_chain_fn(specs, tuple(in_slots), tuple(out_slots)),
                tuple(in_slots), tuple(out_slots),
                tuple(s in window_written for s in in_slots)))
            i = j
        self._graph = TracedGraph(key, nodes, objects, chains, entries)
        self._match_idx = 0
        rt._stats["graphs_traced"] += 1

    # -- chain dispatch --------------------------------------------------
    def _capture(self, dev: TorchDevice, ch: _Chain, inputs) -> None:
        """Capture ``ch`` on ``inputs`` (the window objects' own tensors)
        as a CUDA graph on the device's compute stream. The capture runs
        no kernel: the caller replays it."""
        graph = torch.cuda.CUDAGraph()
        with kernels.recording_launches() as launches, \
                torch.cuda.device(dev.torch_device), \
                torch.cuda.graph(graph, stream=dev.compute_stream,
                                 capture_error_mode="thread_local"):
            outs = ch.fn(*inputs)
        ch.graph, ch.static_in, ch.static_out = graph, tuple(inputs), outs
        ch.launches = launches

    def _dispatch(self, ch: _Chain, inputs) -> Tuple[Any, ...]:
        """Run one chain on ``inputs``: eagerly on a CPU device; on a CUDA
        device by replaying its graph (captured now if it has none), after
        copying into the captured tensors the inputs that differ from
        them. Raises ``_Stale`` where a read-only input was rebound."""
        dev = self.rt._device(ch.device)
        if not getattr(dev, "is_cuda", False):
            return dev.launch(ch.fn, tuple(inputs),
                              donate=tuple(range(len(inputs))))
        if ch.graph is None:
            self._capture(dev, ch, inputs)
        moved = []
        for static, arr, owned in zip(ch.static_in, inputs, ch.written_in,
                                      strict=True):
            if arr.data_ptr() == static.data_ptr() \
                    and arr.shape == static.shape:
                continue
            if not owned:
                raise _Stale()
            moved.append((static, arr))
        with dev._on(dev.compute_stream):
            for static, arr in moved:
                static.copy_(arr)
            ch.graph.replay()
            dev._record(dev.compute_stream,
                        *device_api._leaves(ch.static_out))
        kernels.add_launches(ch.launches)
        return ch.static_out

    def _replay_locked(self) -> None:
        """Execute the whole parked window as one replay dispatch."""
        rt, g = self.rt, self._graph
        parked, self._parked = self._parked, []
        self._match_idx = 0
        stale = False
        rt.residency.pin_many(g.objects)
        try:
            # pre-planned entry transfers, issued as one batch up front;
            # LRU bumps for already-resident replicas are deferred and
            # applied under a single ledger acquisition
            staged: Dict[Tuple[int, int], Any] = {}
            touched: List[Tuple[int, Any]] = []
            for slot, dev, expected_resident in g.entries:
                obj = g.objects[slot]
                # lock-free replica read: every window object is pinned
                # (no eviction) and every task touching it is parked in
                # this window (no concurrent rebind)
                arr = obj.copies.get(dev)
                if arr is None:
                    if expected_resident:
                        # a replica the plan counted on was evicted: the
                        # coherence walk still makes this window correct,
                        # but the plan is stale — re-trace afterwards
                        stale = True
                    arr = rt._ensure_on_device(obj, dev, will_write=False)
                else:
                    touched.append((dev, obj))
                staged[(slot, dev)] = arr
            if touched:
                rt.residency.touch_many(touched)
            # one dispatch per chain, in submission (= topo) order;
            # cross-chain values travel through env, not the objects
            env: Dict[int, Tuple[int, Any]] = {}
            for ch in g.chains:
                inputs = []
                for s in ch.in_slots:
                    if s in env:
                        src_dev, arr = env[s]
                        if src_dev != ch.device:
                            arr = device_api.transfer(
                                rt._device(src_dev), rt._device(ch.device),
                                arr, observer=rt.topology.observe)
                            rt._stats["transfers_d2d"] += 1
                            rt._stats["bytes_d2d"] += g.objects[s].nbytes
                    else:
                        arr = staged.get((s, ch.device))
                        if arr is None:
                            stale = True
                            arr = rt._ensure_on_device(
                                g.objects[s], ch.device, will_write=False)
                    inputs.append(arr)
                try:
                    outs = self._dispatch(ch, inputs)
                except _Stale:
                    stale = True
                    outs = rt._device(ch.device).launch(
                        ch.fn, tuple(inputs),
                        donate=tuple(range(len(inputs))))
                for s, arr in zip(ch.out_slots, outs, strict=False):
                    env[s] = (ch.device, arr)
            # rebind written objects once, exactly like _launch does:
            # drop every old copy, the chain output becomes the only one,
            # a new generation. Chain outputs have no per-task lineage
            # record, so stale records are dropped: a lost replayed object
            # is not lineage-recoverable.
            written: List[Tuple[int, Any]] = []
            dropped: List[Tuple[int, Any]] = []
            for s, (dev, arr) in env.items():
                obj = g.objects[s]
                with obj.lock:
                    for sp in list(obj.copies):
                        if sp == HOST:
                            # host copies go through _drop_copy so pooled
                            # staging buffers return to the pool
                            rt._drop_copy(obj, sp)
                        else:
                            del obj.copies[sp]
                            dropped.append((sp, obj))
                    obj.copies[dev] = arr
                    obj.generation += 1
                written.append((dev, obj))
            # ledger drops/records and lineage forgets are batched: one
            # lock acquisition each for the whole window
            rt.residency.drop_many(dropped)
            rt.residency.record_many(written)
            if rt.lineage is not None:
                rt.lineage.forget_many(obj for _d, obj in written)
        except BaseException as e:
            self._retire_parked(parked, error=e)
            self._invalidate_locked()
            return
        finally:
            rt.residency.unpin_many(g.objects)
        g.replays += 1
        rt._stats["graph_replays"] += 1
        rt._stats["replayed_tasks"] += len(parked)
        self._retire_parked(parked, error=None)
        if stale:
            self._invalidate_locked()

    def _retire_parked(self, parked, error: Optional[BaseException]) -> None:
        rt = self.rt
        with rt._lock:
            rt._tasks_pending -= len(parked)
            rt._work.notify_all()
        for t in parked:
            if error is not None:
                t.state = TaskState.FAILED
                t.future.set_error(error)
            else:
                t.state = TaskState.DONE
                t.future.set_result(None)
