"""Core Runtime (paper §3.1.3/§3.1.5): the glue between application
preferences, the scheduler, and the Device API.

Execution model (faithful to the paper):
  submit() appends an execution request and returns immediately;
  dependencies are inferred (or explicit); blocked tasks wait for their
  dependencies; runnable tasks go to the scheduler; per-device worker
  threads ("dedicated threads", paper Fig. 9) pop work, stage argument
  copies onto their device, launch asynchronously through the Device API,
  and retire tasks as results become ready.

Transfer engine (paper §3.2.3 + §4.1.3)
---------------------------------------
Data movement is a first-class subsystem with three cooperating parts:

  * Direct device-to-device path (``d2d`` toggle): when a task needs an
    object whose only valid copies live on *other* devices, the coherence
    walk moves it with one Device API ``transfer`` (device→device over the
    interconnect) instead of the generic D2H + H2D bounce through host
    memory — the paper's "device-aware interconnect" path (Fig. 7), worth
    up to 20% over staged MPI+CUDA for large messages.
  * Per-device transfer queues (``transfer_thread`` toggle): one dedicated
    transfer worker per device (paper §4.1.3's dedicated transfer queue,
    generalized), so copies targeting different devices never serialize
    behind each other and always overlap compute.
  * Argument prefetch pipeline (``prefetch`` toggle, depth via
    ``prefetch_depth``): after launching a task, the worker claims up to
    ``prefetch_depth`` next tasks from the scheduler (``Scheduler.assign``)
    and enqueues their argument transfers on the transfer queues — the
    copies run while the current task computes, and ``_launch`` merely
    awaits already-in-flight transfers. The queues are *priority* queues,
    FIFO within a priority level: the immediately-next task's arguments
    (depth 1) are never scheduled behind deeper staging — in the default
    one-producer-per-queue pipeline enqueue order already guarantees
    this, and the explicit priorities keep the invariant for any future
    multi-producer path (e.g. cross-worker staging or queued demand
    transfers). ``stats()["prefetch_hits"]`` counts argument copies that had
    fully completed by launch time (true overlap);
    ``stats()["prefetch_stalls"]`` counts copies that were claimed early
    but still had to be awaited.

Residency & placement (paper §3.1.1 + §3.1.3): a ``ResidencyLedger``
(``core/residency.py``) is the single source of truth for which devices
hold valid replicas of each object, with per-device byte accounting and
LRU eviction. The scheduler's placement cost model scores devices against
the ledger (data-gravity: bytes-to-move minus bytes-resident), and the
distributed layer asks it where payloads with no known consumer should
land.

Large host→device copies are chunked through the ``StagingPool``
(page-locked buffer analogue) in ``staging_chunk_bytes`` pieces, and the
mirrored device→host path stages downloads into pooled buffers the same
way — so host copies never alias device buffers that donation might
recycle. Pool buffers are recycled: staging buffers return to the pool
when a host copy is dropped, transfer futures return to the
``RequestPool`` once consumed.

Configuration toggles map 1:1 to the paper's optimization ladder (Fig. 8)
so the benchmark can reproduce it:
  staging_pool     — §4.1.1 page-locked host memory pool
  cache_jit        — §4.1.2 custom device allocator (jit cache + donation)
  request_pool     — §4.1.4 request pools
  transfer_thread  — §4.1.3 dedicated transfer queues (one per device)
  inflight         — §4.1.3 multiple compute queues (async window)
  dedicated_threads— §4.1.6 one worker per device
  prefetch         — §4.1.3 transfer/compute overlap (argument pipeline)
  prefetch_depth   — §4.1.3 pipeline depth (tasks claimed ahead per worker)
  d2d              — §3.2.3 direct device-to-device transfers
  scheduler        — §3.1.4 placement policy ("gravity" = data-gravity)
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch.convert import numpy_dtype
from repro_torch.core import clock
from repro_torch.core import dependency as dep
from repro_torch.core import device_api
from repro_torch.core import sanitizer, spans
from repro_torch.core.device_api import Device, TorchDevice, discover_devices
from repro_torch.core.futures import HFuture
from repro_torch.core.hetero_object import HOST, HeteroObject
from repro_torch.core.hetero_task import HeteroTask, TaskState
from repro_torch.core.lineage import LineageLedger
from repro_torch.core.memory import RequestPool, StagingPool
from repro_torch.core.progress import ProgressEngine
from repro_torch.core.residency import PLACEMENTS, ResidencyLedger
from repro_torch.core.scheduler import SCHEDULERS, Scheduler
from repro_torch.core.taskgraph import GraphTracer
from repro_torch.core.topology import (InterconnectModel, probe_link,
                                 probe_runtime_links)


class InjectedTaskFault(RuntimeError):
    """Deterministic kernel fault planted by FaultInjector.fail_task."""


def _concat_rows(*pieces):
    """Launch kernel of the chunked upload: reassemble the row pieces."""
    return torch.cat(pieces, dim=0)


@dataclasses.dataclass
class RuntimeConfig:
    # "cuda": one Device per visible card (raises where there is none);
    # "cpu": cpu_devices logical CPU devices
    device: str = "cuda"
    cpu_devices: int = 2
    scheduler: str = "gravity"
    placement: Optional[str] = None   # override the scheduler's cost model
    staging_pool: bool = True
    cache_jit: bool = True
    request_pool: bool = True
    transfer_thread: bool = True
    inflight: int = 4             # async launches in flight per device
    dedicated_threads: bool = True
    sync_dispatch: bool = False   # TF-Baseline: block after every launch
    d2d: bool = True              # direct device→device transfers (§3.2.3)
    prefetch: bool = True         # argument prefetch pipeline (§4.1.3)
    prefetch_depth: int = 1       # tasks claimed ahead per worker
    memory_capacity: Optional[int] = None
    staging_chunk_bytes: int = 8 << 20   # chunk host uploads above this size
    poll_interval_s: float = 0.0005
    # -- interconnect topology (paper §3.2.3) --
    topology_probe: bool = True   # startup micro-probe seeds the model
    topology_probe_bytes: int = 64 << 10
    # device pairs the startup host+ring probe did not cover are probed
    # lazily, once, on their first real transfer (ROADMAP follow-up c)
    lazy_probe: bool = True
    # distributed messages above this size switch from the eager
    # (monolithic) protocol to chunk-streamed rendezvous
    eager_threshold: int = 64 << 10
    # rendezvous chunk size targets this many ms per chunk at the
    # measured link bandwidth (bandwidth-delay-product sizing);
    # chunk_bytes pins an explicit size instead (tests/benchmarks)
    chunk_target_ms: float = 4.0
    chunk_bytes: Optional[int] = None
    # rendezvous sliding window (credit-based flow control): None runs the
    # adaptive controller (starts at the measured bandwidth-delay product,
    # halves under receiver backlog, widens back when the lane drains); an
    # int pins the window (tests/benchmarks)
    net_window: Optional[int] = None
    # strict asynchronous-error mode: errors swallowed by fire-and-forget
    # progress-lane jobs or distributed pump handlers are re-raised at the
    # next barrier instead of only being counted
    # (stats()["progress_errors"] / Rank.stats["handler_errors"])
    strict_errors: bool = False
    # -- distributed layer: heartbeats and the reliability layer --
    # heartbeat cadence: each rank's pump emits a 0-byte control-VC
    # heartbeat to the monitor rank every interval; the elastic
    # controller declares a rank dead after timeout without one
    heartbeat_interval_s: float = 0.05
    heartbeat_timeout_s: float = 0.5
    # reliability layer (engaged by Cluster.fault_injector): eager
    # messages, RTS announcements and stream tails are retransmitted with
    # exponential backoff up to send_retries attempts before the send is
    # counted failed; receivers NACK stalled rendezvous streams on the
    # same backoff schedule
    send_retries: int = 5
    retry_backoff_s: float = 0.05
    retry_backoff_mult: float = 2.0
    retry_tick_s: float = 0.005
    # protocol timeouts: tail-upload wait when a rendezvous stream
    # completes, the peer-removal sweep's net-send rendezvous, and the
    # pump-thread join at shutdown
    rdzv_finish_timeout_s: float = 120.0
    peer_sweep_timeout_s: float = 10.0
    pump_join_timeout_s: float = 5.0
    # -- compiled task-graph fast path (core/taskgraph.py) --
    # trace recurring submit windows (delimited by step_boundary()/
    # barrier()) and, once the same DAG recurred replay_after times,
    # replay it as one dispatch per chain (a CUDA graph on a card) that
    # bypasses per-task scheduling. Opt-in: interior futures of replayed
    # windows resolve with None instead of a device handle.
    trace_graphs: bool = False
    replay_after: int = 3
    # shared progress-engine worker pool width (base threads servicing
    # ALL lanes; overflow workers spawn transiently when every base
    # worker is parked in a blocking job). 0 = legacy thread-per-lane.
    pool_workers: int = 4
    # -- lineage-based recovery (core/lineage.py) --
    # lineage_depth: max producer-chain replay depth when coherence finds
    # an object with no valid replica anywhere (evicted-and-lost). 0
    # disables the lineage ledger entirely.
    lineage_depth: int = 4
    # task_retries: relaunch budget for a task whose kernel launch raised
    # (injected kernel faults, transient device errors) before the error
    # surfaces on the task future / strict barrier
    task_retries: int = 0
    # -- end-to-end integrity (core/integrity.py) --
    # verify_payloads: compute a content digest once at serialization for
    # every host-visible distributed payload/chunk and verify it on
    # receive; a failed check counts in Rank.stats["checksum_fail"] and
    # the bytes are treated as never-arrived (the reliability layer
    # retransmits)
    verify_payloads: bool = True
    # -- runtime collectives (distributed/collectives_rt.py) --
    # algorithm cutover: payloads at or below this many bytes run as
    # eager binomial trees (latency-bound regime), larger ones as
    # pipelined chunked rings (bandwidth-bound). Matches eager_threshold
    # by default — below it every ring hop would be an eager message
    # anyway, so the ring's pipelining buys nothing
    coll_ring_cutover_bytes: int = 64 << 10
    # cap on the credit window of op="reduce" rendezvous streams
    # (Rank.reduce_into): every in-flight reduce chunk is an add pending
    # on the consumer device's transfer lane. 0 = uncapped
    coll_max_inflight_chunks: int = 4
    # collective tag namespace: tags (which scope every stream and
    # handler invocation to one collective op) wrap at this size, so at
    # most this many collectives may be in flight per group at once
    coll_tag_space: int = 1 << 12
    # -- concurrency sanitizer (core/sanitizer.py) --
    # sanitize: install the process-global RuntimeSanitizer before this
    # runtime builds its locks — lock-order tracking, lane-discipline
    # enforcement, wait-graph barrier diagnostics, and gauge-hygiene
    # assertions. Defaults on when REPRO_SANITIZE=1
    # (the CI sanitize shard sets only the env var)
    sanitize: bool = dataclasses.field(default_factory=sanitizer.env_enabled)
    # contended-lock threshold: a tracked-lock acquire that waits at
    # least this long on a strict lane counts as a lane-blocking event
    sanitize_block_s: float = 0.010


class Runtime:
    @spans.spanned("runtime.init")
    def __init__(self, config: Optional[RuntimeConfig] = None,
                 devices: Optional[List[Device]] = None):
        self.cfg = config or RuntimeConfig()
        if self.cfg.sanitize:
            # must precede every lock construction below: the factories
            # consult the global sanitizer at creation time
            sanitizer.install(self.cfg.sanitize_block_s)
        self.devices: List[Device] = devices if devices is not None else \
            discover_devices(self.cfg.memory_capacity, self.cfg.cache_jit,
                             self.cfg.device, self.cfg.cpu_devices)
        for d in self.devices:
            if isinstance(d, TorchDevice):
                d.cache_jit = self.cfg.cache_jit
        self.residency = ResidencyLedger(
            {d.info.device_id: d.info.memory_capacity for d in self.devices})
        # measured per-link bandwidth/latency (paper §3.2.3): seeded by a
        # startup micro-probe, refined by every real transfer below, and
        # consumed by the gravity penalty, the scheduler's transfer-cost
        # estimates, and the distributed message protocol's chunk sizing
        self.topology = InterconnectModel()
        self.scheduler: Scheduler = SCHEDULERS[self.cfg.scheduler](
            {d.info.device_id: d.info.device_type for d in self.devices})
        if self.cfg.placement is not None:
            self.scheduler.placement = PLACEMENTS[self.cfg.placement]()
        self.scheduler.bind_residency(self.residency)
        self.scheduler.bind_topology(self.topology)
        if self.cfg.topology_probe:
            with spans.span("topology.probe"):
                probe_runtime_links(self.topology, self.devices,
                                    self.cfg.topology_probe_bytes)
        # page-locked staging buffers wherever a card does the copies
        self.staging = StagingPool(
            self.cfg.staging_pool,
            pinned=any(getattr(d, "is_cuda", False) for d in self.devices))
        self.futures = RequestPool(HFuture, self.cfg.request_pool)
        self._lock = sanitizer.make_rlock("Runtime._lock")
        self._work = sanitizer.make_condition(self._lock)
        self._tasks_pending = 0
        self._shutdown = False
        self._stats = {"tasks": 0, "transfers_h2d": 0, "transfers_d2h": 0,
                       "transfers_d2d": 0, "bytes_h2d": 0, "bytes_d2h": 0,
                       "bytes_d2d": 0, "prefetch_hits": 0,
                       "prefetch_misses": 0, "prefetch_stalls": 0,
                       "graphs_traced": 0, "graph_replays": 0,
                       "graph_invalidations": 0, "replayed_tasks": 0,
                       "lineage_recomputes": 0, "recompute_depth_peak": 0,
                       "task_retries": 0, "tasks_failed": 0,
                       "graph_captures": 0, "objects_adopted": 0,
                       "bytes_adopted": 0}
        # lineage ledger: producer records for lost-replica recovery
        self.lineage: Optional[LineageLedger] = (
            LineageLedger() if self.cfg.lineage_depth > 0 else None)
        self._lineage_lock = sanitizer.make_rlock("Runtime._lineage_lock")
        self._recovering: set = set()       # cycle guard (object ids)
        self._failed_tasks: List[BaseException] = []
        self._inject_task_faults = 0        # FaultInjector.fail_task budget
        self._threads: List[threading.Thread] = []
        # unified progress engine (core/progress.py): one reactor owns
        # every asynchronous context this runtime needs — per-device
        # transfer lanes (paper §4.1.3, priority queues: the next task's
        # arguments outrank deeper prefetch staging), per-device launch
        # completion lanes (in-flight retire without the old block_one
        # polling loop), and — when a distributed Rank wraps this runtime
        # — its net-send / net-recv lanes
        self.engine = ProgressEngine(name="rt",
                                     strict=self.cfg.strict_errors,
                                     pool_workers=self.cfg.pool_workers)
        # compiled task-graph fast path (core/taskgraph.py): opt-in
        # tracer that turns recurring submit windows into replays
        self._tracer: Optional[GraphTracer] = (
            GraphTracer(self, self.cfg.replay_after)
            if self.cfg.trace_graphs else None)
        self._start_workers()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def hetero_object(self, value=None, shape=None, dtype=None,
                      name: str = "") -> HeteroObject:
        return HeteroObject(self, value=value, shape=shape, dtype=dtype,
                            name=name)

    def adopt_device_array(self, dev_array: Any, device_id: int = 0,
                           name: str = "") -> HeteroObject:
        """Wrap an array already resident on ``device_id`` into a
        HeteroObject without a host bounce — the receiver half of the
        distributed DIRECT payload path (paper §3.2.3)."""
        obj = HeteroObject(self, shape=tuple(dev_array.shape),
                           dtype=dev_array.dtype, name=name)
        self.residency.ensure_capacity(device_id, obj.nbytes, self._evict)
        with obj.lock:
            obj.copies[device_id] = dev_array
            self.residency.record(device_id, obj)
        self._stats["objects_adopted"] += 1
        self._stats["bytes_adopted"] += obj.nbytes
        return obj

    def rebind_device_copy(self, obj: HeteroObject, dev_array: Any,
                           device_id: int,
                           timeout: Optional[float] = 120.0) -> None:
        """Overwrite ``obj`` with an array already resident on
        ``device_id`` — the device half of the distributed put (paper
        §4.2.4): once conflicting writers retire, every existing copy is
        invalidated and the new device array becomes the only valid one.
        No host staging on either side."""
        if self._tracer is not None:
            self._tracer.flush()   # parked writes must be observable
        with self._lock:
            lw = obj.last_writer
        if lw is not None and not lw.done():
            lw.future.get(timeout)
        self.residency.ensure_capacity(device_id, obj.nbytes, self._evict)
        with obj.lock:
            for sp in list(obj.copies):
                self._drop_copy(obj, sp)
            obj.copies[device_id] = dev_array
            obj.generation += 1     # externally-written version
            self.residency.record(device_id, obj)

    def pick_landing_device(self, preferred: Optional[int] = None,
                            device_type: Optional[str] = None) -> int:
        """Where should externally-arriving data (a distributed DIRECT
        payload) land? The consumer task's device when the sender named
        one, else the residency ledger's least-loaded device (optionally
        restricted to ``device_type``) — never a hardwired device 0."""
        ids = {d.info.device_id for d in self.devices}
        if preferred is not None and preferred in ids:
            return preferred
        if device_type is not None:
            typed = {d.info.device_id for d in self.devices
                     if d.info.device_type == device_type}
            ids = typed or ids
        queued = getattr(self.scheduler, "queued", {})

        def pressure(d: int) -> int:
            return self.scheduler.load.get(d, 0) + queued.get(d, 0)

        return self.residency.least_loaded_device(pressure, among=ids)

    def submit(self, task: HeteroTask, kernel: Callable) -> HFuture:
        """Enqueue an execution request; returns the task's future. The
        task carries the request open on this thread to its worker."""
        task.kernel = kernel
        task.request = spans.current_request()
        tracer = self._tracer
        if tracer is not None:
            with self._lock:
                task.state = TaskState.SUBMITTED
                self._tasks_pending += 1
                self._stats["tasks"] += 1
            # the tracer either parks the task for a compiled replay
            # (skipping pins / dependency inference / scheduling) or
            # tells us to run it interpreted while it records the window
            if not tracer.on_submit(task, kernel):
                with spans.span("runtime.submit", task=task.id):
                    self._enqueue(task)
            return task.future
        with spans.span("runtime.submit", task=task.id), self._lock:
            task.state = TaskState.SUBMITTED
            self._tasks_pending += 1
            self._stats["tasks"] += 1
            self._pin_and_schedule_locked(task)
        return task.future

    def _pin_and_schedule_locked(self, task: HeteroTask) -> None:
        # ledger-owned pins: every argument is protected from
        # eviction for the task's whole submitted→finished window
        # (the busy() object-lock walk the eviction path used to do)
        for obj in {id(r.obj): r.obj for r in task.args}.values():
            self.residency.pin(obj)
        n = dep.infer_dependencies(task)
        if n > 0:
            task.state = TaskState.BLOCKED
        else:
            task.state = TaskState.READY
            self.scheduler.push(task)
        self._work.notify_all()

    def _enqueue(self, task: HeteroTask) -> None:
        """Interpreted-path scheduling for an already-accounted task
        (normal submits under tracing, and parked tasks the tracer
        flushes back when a window deviates from its compiled graph)."""
        with self._lock:
            self._pin_and_schedule_locked(task)

    def step_boundary(self) -> None:
        """Declare the edge between two application steps — the window
        delimiter the task-graph tracer keys recurrence detection on
        (Jacobi iterations, serve steps, microbatch train steps). A
        no-op unless ``trace_graphs`` is enabled; ``barrier()`` is also
        a boundary, so drivers that barrier every step need no change."""
        if self._tracer is not None:
            self._tracer.on_boundary()

    def invalidate_traces(self) -> None:
        """Drop any compiled task graph and restart recurrence detection
        (placements captured before may name devices that went away)."""
        if self._tracer is not None:
            self._tracer.invalidate()

    def run(self, kernel: Callable, args: Sequence[Tuple[HeteroObject, str]],
            device_type: Optional[str] = None, name: str = "") -> HeteroTask:
        """Convenience: build + submit in one call.
        args: [(obj, 'r'|'w'|'rw'), ...]."""
        t = HeteroTask(name=name)
        for obj, mode in args:
            getattr(t.arg(obj), {"r": "read", "w": "write",
                                 "rw": "rw"}[mode])()
        t.device(device_type)
        self.submit(t, kernel)
        return t

    @spans.spanned("runtime.barrier")
    def barrier(self, timeout: Optional[float] = 120.0) -> None:
        """Wait until every submitted task has retired."""
        if self._tracer is not None:
            # a barrier is a window boundary: replay a fully-matched
            # window (synchronously, so the wait below sees it retired)
            # or advance recurrence detection
            self._tracer.on_boundary()
        deadline = None if timeout is None else clock.now() + timeout
        with self._lock:
            while self._tasks_pending > 0:
                remaining = None if deadline is None else \
                    max(deadline - clock.now(), 0.0)
                if not self._work.wait(timeout=remaining):
                    raise TimeoutError(
                        f"barrier: {self._tasks_pending} tasks pending")
        # strict mode: a swallowed fire-and-forget progress error fails
        # the barrier instead of leaving a silently-dead continuation
        self.engine.check()
        if self.cfg.strict_errors:
            with self._lock:
                failed, self._failed_tasks = self._failed_tasks, []
            if failed:
                raise RuntimeError(
                    f"{len(failed)} task(s) failed since last barrier: "
                    f"{failed[0]!r}") from failed[0]

    def stats(self) -> Dict[str, Any]:
        s = dict(self._stats)
        s["staging_hits"] = self.staging.hits
        s["staging_misses"] = self.staging.misses
        s["request_pool_hits"] = self.futures.hits
        s["request_pool_misses"] = self.futures.misses
        s.update(self.residency.gauges())
        s["topology"] = self.topology.snapshot()
        s["progress_lanes"] = self.engine.lanes_snapshot()
        s["progress_errors"] = self.engine.error_count()
        san = sanitizer.current()
        if san is not None:
            s["sanitizer"] = san.stats_snapshot()
        return s

    @spans.spanned("runtime.shutdown")
    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._work.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self.engine.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # ------------------------------------------------------------------
    # host access protocol
    # ------------------------------------------------------------------
    def _request_host(self, obj: HeteroObject, write: bool) -> HFuture:
        if self._tracer is not None:
            # a mid-window host access must observe parked writes: the
            # tracer flushes parked tasks through the interpreted path
            self._tracer.flush()
        self.residency.pin(obj)      # until _release_host
        fut = self.futures.acquire()

        def deliver():
            try:
                arr = self._stage_to_host(obj)
            except TypeError as e:
                # no host dtype for the object (a bfloat16 where numpy has
                # none registered): fail the request, drop its pin
                self.residency.unpin(obj)
                fut.set_error(e)
                return
            with obj.lock:
                if write and not arr.flags.writeable:
                    # downloads can be read-only zero-copy views of device
                    # buffers; a write pin must hand out a writable copy
                    arr = np.array(arr)
                    obj.copies[HOST] = arr
                    obj._pooled_host = False
                obj.host_pins += 1
                if write:
                    # invalidate device copies: host becomes the only valid
                    # one — a new generation (stale lineage records must
                    # not be able to resurrect the pre-write bytes)
                    obj.generation += 1
                    for sp in [s for s in obj.copies if s != HOST]:
                        self._drop_copy(obj, sp)
            fut.set_result(arr)

        with self._lock:
            lw = obj.last_writer
        if lw is not None and not lw.done():
            lw.future.add_done_callback(lambda _: deliver())
        else:
            deliver()
        return fut

    def _request_device_view(self, obj: HeteroObject) -> HFuture:
        """Async view of an object's freshest copy WITHOUT host staging:
        resolves (after conflicting writers retire) to ``(space, array)``
        where space is a device id (a private ``clone`` — snapshot-safe
        because no task writes into it) or HOST (defensive np copy). The distributed
        DIRECT send path uses this so the payload never bounces via host.

        The view takes a *device pin* at request time (program order, like
        the paper's read-access request): while pinned, launches won't
        donate this object's buffers. Under that protection the deliver
        step snapshots a private on-device ``clone`` of the copy, then
        drops the pin — the clone is referenced by nothing else, so no
        later donation can delete the payload mid-flight."""
        if self._tracer is not None:
            self._tracer.flush()   # parked writes must be observable
        with obj.lock:
            obj.device_pins += 1
        self.residency.pin(obj)      # until _release_device_view
        fut = self.futures.acquire()

        def deliver():
            try:
                with obj.lock:
                    dev_sp = next((s for s in obj.copies if s != HOST), None)
                    if dev_sp is not None:
                        snap = self._device(dev_sp).clone(obj.copies[dev_sp])
                    elif HOST in obj.copies:
                        snap = np.array(obj.copies[HOST])
                    else:
                        snap = np.zeros(obj.shape, numpy_dtype(obj.dtype))
                if dev_sp is not None:
                    # clone must finish reading
                    self._device(dev_sp).synchronize(snap)
                fut.set_result((dev_sp if dev_sp is not None else HOST,
                                snap))
            finally:
                self._release_device_view(obj)

        with self._lock:
            lw = obj.last_writer
        if lw is not None and not lw.done():
            lw.future.add_done_callback(lambda _: deliver())
        else:
            deliver()
        return fut

    def _release_host(self, obj: HeteroObject) -> None:
        self.residency.unpin(obj)
        with obj.lock:
            obj.host_pins = max(0, obj.host_pins - 1)
            # a pooled buffer whose HOST copy was dropped while pinned
            # (e.g. free() between request and release) is handed back to
            # the pool once the last pin goes away
            orphan = getattr(obj, "_orphan_host", None)
            if obj.host_pins == 0 and orphan is not None:
                self.staging.release(orphan)
                obj._orphan_host = None

    def _release_device_view(self, obj: HeteroObject) -> None:
        self.residency.unpin(obj)
        with obj.lock:
            obj.device_pins = max(0, obj.device_pins - 1)

    def _free_object(self, obj: HeteroObject) -> None:
        with obj.lock:
            for sp in list(obj.copies):
                self._drop_copy(obj, sp)

    # ------------------------------------------------------------------
    # data movement / coherence
    # ------------------------------------------------------------------
    def _device(self, device_id: int) -> Device:
        return self.devices[device_id]

    def _drop_copy(self, obj: HeteroObject, space: int) -> None:
        if space in obj.copies:
            arr = obj.copies.pop(space)
            if space != HOST:
                self.residency.drop(space, obj)
            elif getattr(obj, "_pooled_host", False):
                # recycle the staging buffer (paper §4.1.1: the page-locked
                # pool only pays off if buffers actually return to it); if
                # a pin still hands the buffer out, park it as an orphan —
                # _release_host returns it to the pool with the last pin
                if obj.host_pins == 0:
                    self.staging.release(arr)
                else:
                    obj._orphan_host = arr
                obj._pooled_host = False

    def _stage_to_host(self, obj: HeteroObject) -> np.ndarray:
        with obj.lock:
            if HOST in obj.copies:
                return obj.copies[HOST]
            src = next(iter(obj.copies), None)
        if src is None and self.lineage is not None:
            # no valid replica anywhere: before conjuring zeros, try to
            # replay the recorded producer chain (bounded, cycle-safe)
            if self._lineage_recover(obj):
                with obj.lock:
                    if HOST in obj.copies:
                        return obj.copies[HOST]
                    src = next(iter(obj.copies), None)
        if src is None:
            arr = self.staging.acquire(obj.shape, obj.dtype)
            arr[...] = 0
            pooled = True
        else:
            dev_arr = obj.copies[src]
            t0 = time.perf_counter()
            arr, pooled = self._download_device(self._device(src), dev_arr)
            self.topology.observe(src, HOST, obj.nbytes,
                                  time.perf_counter() - t0)
            self._stats["transfers_d2h"] += 1
            self._stats["bytes_d2h"] += obj.nbytes
        with obj.lock:
            obj.copies[HOST] = arr
            obj._pooled_host = pooled
        return arr

    def _download_device(self, device: Device,
                         dev_arr: Any) -> Tuple[np.ndarray, bool]:
        """Device→host staging mirroring ``_upload_host``: the host copy
        lands in a pooled StagingPool buffer (chunked above
        ``staging_chunk_bytes``) and NEVER aliases the device buffer —
        a donated device buffer may be written in place under any view
        of it. Returns
        (host array, is_pooled)."""
        if not self.staging.enabled:
            # no pool: still a private copy, never an aliasing view
            return np.array(device.download(dev_arr)), False
        shape = tuple(dev_arr.shape)
        buf = self.staging.acquire(shape, dev_arr.dtype)
        chunk = self.cfg.staging_chunk_bytes
        nbytes = buf.nbytes
        if (chunk <= 0 or nbytes <= chunk or buf.ndim == 0
                or shape[0] < 2):
            device.download_into(dev_arr, buf)
            return buf, True
        # chunked: slice on device, download piecewise into the pool
        # buffer so no full-size intermediate host array materializes
        row_bytes = max(1, nbytes // shape[0])
        rows_per = max(1, chunk // row_bytes)
        for i in range(0, shape[0], rows_per):
            device.download_into(dev_arr[i:i + rows_per],
                                 buf[i:i + rows_per])
        return buf, True

    def _upload_host(self, device: Device, host_arr: np.ndarray) -> Any:
        """Host→device copy; large arrays stream through pooled staging
        buffers in ``staging_chunk_bytes`` pieces (page-locked pool
        analogue) so one giant transfer can't monopolize host memory.
        Every upload is timed into the interconnect model (the chunked
        path blocks, so its sample is honest; the simple path measures
        dispatch+copy, which the EWMA smooths)."""
        t0 = time.perf_counter()
        arr = self._upload_host_inner(device, host_arr)
        self.topology.observe(HOST, device.info.device_id,
                              host_arr.nbytes, time.perf_counter() - t0)
        return arr

    def _upload_host_inner(self, device: Device, host_arr: np.ndarray) -> Any:
        chunk = self.cfg.staging_chunk_bytes
        if (not self.staging.enabled or chunk <= 0
                or host_arr.nbytes <= chunk or host_arr.ndim == 0
                or host_arr.shape[0] < 2):
            return device.upload(host_arr)
        row_bytes = max(1, host_arr.nbytes // host_arr.shape[0])
        rows_per = max(1, chunk // row_bytes)
        handles, bufs = [], []
        for i in range(0, host_arr.shape[0], rows_per):
            part = host_arr[i:i + rows_per]
            buf = self.staging.acquire(part.shape, part.dtype)
            np.copyto(buf, part)
            # the copy reads the pooled buffer itself: filling the next
            # buffer overlaps this one's DMA
            handles.append(device.upload_async(buf))
            bufs.append(buf)
        # one wait for the whole batch; buffers may only return to the
        # pool once their DMA completed
        pieces = [h.result() for h in handles]
        for buf in bufs:
            self.staging.release(buf)
        return device.launch(_concat_rows, tuple(pieces))

    # -- lineage-based recovery ----------------------------------------
    def _lineage_recover(self, obj: HeteroObject,
                         depth: Optional[int] = None) -> bool:
        """Rebuild a lost object by replaying its recorded producer task.

        Bounded by ``cfg.lineage_depth`` and cycle-safe: a record is only
        replayable when every input it *read* still sits at the exact
        generation it read (in-place ``rw`` chains therefore refuse to
        replay past their own overwrite), and a per-object guard set
        breaks any residual recursion. Serialised under one recursive
        lock so concurrent coherence walks don't double-recompute."""
        if self.lineage is None:
            return False
        if depth is None:
            depth = self.cfg.lineage_depth
        if depth <= 0:
            return False
        with self._lineage_lock:
            return self._lineage_recover_locked(obj, depth)

    def _lineage_recover_locked(self, obj: HeteroObject, depth: int) -> bool:
        with obj.lock:
            if obj.copies:
                return True          # raced: already restored
        if id(obj) in self._recovering:
            return False             # cycle guard
        rec = self.lineage.producer(obj)
        if rec is None:
            return False
        self._recovering.add(id(obj))
        try:
            for iobj, pre_gen, reads, _writes in rec.args:
                if not reads:
                    continue         # pure write: placeholder below
                if iobj.generation != pre_gen:
                    return False     # input moved on: chain broken
                with iobj.lock:
                    have = bool(iobj.copies)
                if not have and (depth <= 1 or not
                                 self._lineage_recover_locked(iobj,
                                                              depth - 1)):
                    return False
            dev = rec.device_id if 0 <= rec.device_id < len(self.devices) \
                else self.pick_landing_device()
            device = self._device(dev)
            dev_args = []
            for iobj, _pre, reads, _writes in rec.args:
                if reads:
                    dev_args.append(self._ensure_on_device(iobj, dev,
                                                           will_write=False))
                else:
                    # write-only slot: content never read by the kernel,
                    # any correctly-shaped array will do (and avoids
                    # recursing into the object we are recovering)
                    dev_args.append(device.upload(
                        np.zeros(iobj.shape, numpy_dtype(iobj.dtype))))
            handle = device.launch(rec.kernel, tuple(dev_args), donate=())
            device.synchronize(handle)
            outs = handle if isinstance(handle, (tuple, list)) else (handle,)
            wi = 0
            for oobj, _pre, _reads, writes in rec.args:
                if not writes:
                    continue
                if wi < len(outs):
                    new_arr = outs[wi]
                    self.residency.ensure_capacity(dev, oobj.nbytes,
                                                   self._evict)
                    with oobj.lock:
                        restore = (oobj is obj) or (
                            not oobj.copies and self.lineage.producer(oobj)
                            is rec)
                        if restore and dev not in oobj.copies:
                            # restoring the SAME logical version: do NOT
                            # bump the generation
                            oobj.copies[dev] = new_arr
                            self.residency.record(dev, oobj)
                wi += 1
            self._stats["lineage_recomputes"] += 1
            used = self.cfg.lineage_depth - depth + 1
            if used > self._stats["recompute_depth_peak"]:
                self._stats["recompute_depth_peak"] = used
            with obj.lock:
                return bool(obj.copies)
        finally:
            self._recovering.discard(id(obj))

    def _evict(self, obj: HeteroObject, device_id: int) -> bool:
        """LRU eviction callback: spill to host unless pinned (paper
        §3.1.1). Pin state is the ledger's — no obj.busy() lock walk;
        ``ensure_capacity`` already filters pinned candidates, this check
        only covers direct callers and pins taken mid-eviction."""
        if self.residency.pinned(obj):
            return False
        with obj.lock:
            if device_id not in obj.copies:
                return False
            if len(obj.copies) == 1:      # device holds the only valid copy
                pass                       # must stage out first
        self._stage_to_host(obj)
        with obj.lock:
            self._drop_copy(obj, device_id)
        return True

    def _ensure_on_device(self, obj: HeteroObject, device_id: int,
                          will_write: bool) -> Any:
        """Coherence walk: make a VALID copy resident on device_id.

        Source preference (paper §3.2.3): (1) already resident — no copy;
        (2) the residency ledger knows another device holding a replica and
        d2d is on — one direct device→device transfer; (3) generic path —
        stage through host."""
        with obj.lock:
            if device_id in obj.copies:
                arr = obj.copies[device_id]
                self.residency.touch(device_id, obj)
                if will_write:
                    for sp in [s for s in obj.copies if s != device_id]:
                        self._drop_copy(obj, sp)
                return arr
            src_dev = None
            src_arr = None
            if self.cfg.d2d:
                for cand in sorted(self.residency.devices_of(obj)):
                    if cand != device_id and cand in obj.copies:
                        src_dev, src_arr = cand, obj.copies[cand]
                        break
        if src_dev is not None:
            # direct D2D: never materializes a host copy (the array taken
            # above stays valid even if the source copy is concurrently
            # evicted: no task writes in place into an object's only copy
            # while this walk holds its pin)
            if (self.cfg.lazy_probe
                    and not self.topology.measured(src_dev, device_id)):
                # first use of a pair the startup host+ring probe skipped
                # (ROADMAP follow-up c): seed from the measured two-hop
                # path over host, then time one small real transfer so
                # the estimate is link-local before the payload's own
                # sample refines it
                self.topology.seed_from_path(src_dev, device_id)
                try:
                    probe_link(self._device(src_dev),
                               self._device(device_id), self.topology,
                               self.cfg.topology_probe_bytes)
                except Exception:   # probe failure must never block data
                    pass
            self.residency.ensure_capacity(device_id, obj.nbytes,
                                           self._evict)
            dev_arr = device_api.transfer(self._device(src_dev),
                                          self._device(device_id), src_arr,
                                          observer=self.topology.observe)
            self._stats["transfers_d2d"] += 1
            self._stats["bytes_d2d"] += obj.nbytes
        else:
            host_arr = self._stage_to_host(obj)
            # the chunked path transiently holds pieces + their concatenated
            # result on device, so reserve double before choosing it
            chunked = (self.staging.enabled
                       and 0 < self.cfg.staging_chunk_bytes < obj.nbytes)
            self.residency.ensure_capacity(
                device_id, obj.nbytes * (2 if chunked else 1), self._evict)
            dev_arr = self._upload_host(self._device(device_id), host_arr)
            self._stats["transfers_h2d"] += 1
            self._stats["bytes_h2d"] += obj.nbytes
        with obj.lock:
            if device_id in obj.copies:        # raced with another walker
                dev_arr = obj.copies[device_id]
            else:
                obj.copies[device_id] = dev_arr
                self.residency.record(device_id, obj)
            if will_write:
                for sp in [s for s in obj.copies if s != device_id]:
                    self._drop_copy(obj, sp)
        return dev_arr

    # ------------------------------------------------------------------
    # workers
    # ------------------------------------------------------------------
    def _start_workers(self):
        n = len(self.devices) if self.cfg.dedicated_threads else 1
        for i in range(n):
            hint = self.devices[i].info.device_id \
                if self.cfg.dedicated_threads else None
            th = threading.Thread(target=self._worker, args=(hint,),
                                  daemon=True, name=f"repro-worker-{i}")
            th.start()
            self._threads.append(th)
        if self.cfg.transfer_thread:
            # materialize the transfer lanes up front so a burst of first
            # transfers never races lane creation with heavy traffic
            for d in self.devices:
                self.engine.lane("transfer", d.info.device_id)

    def _async_transfer(self, device_id: int, fn: Callable,
                        priority: int = 0) -> HFuture:
        """Run ``fn`` on ``device_id``'s transfer lane (or inline when the
        transfer lanes are disabled). Lower ``priority`` runs first —
        deep prefetch staging (priority 2+) never delays the next task's
        arguments (priority 1). Returns a pooled future; the completion
        event fires through the future's done-callbacks."""
        fut = self.futures.acquire()
        if self.cfg.transfer_thread:
            self.engine.submit("transfer", device_id, fn, fut,
                               priority=priority)
        else:
            try:
                fut.set_result(fn())
            except BaseException as e:   # pragma: no cover
                fut.set_error(e)
        return fut

    # -- argument prefetch pipeline ------------------------------------
    def _try_prefetch(self, device_hint: Optional[int], depth: int = 1):
        """Claim the next task early (Scheduler.assign) and enqueue its
        argument transfers so they overlap the current task's compute.
        ``depth`` is the task's position in the pipeline (1 = runs next)
        and doubles as the transfer priority. Returns (task, dev,
        transfer-future-or-None); the future resolves to
        ({obj_id: device array}, needed-ids). All of a task's arguments
        stage as ONE transfer-queue item (per-argument handoffs cost more
        than they overlap), and fully-resident tasks skip the queue
        entirely."""
        with self._lock:
            if self._shutdown:
                return None
            item = self.scheduler.assign(device_hint)
            if item is None:
                return None
            task, dev = item
            task.state = TaskState.RUNNING
            task.chosen_device = dev
            self.scheduler.load[dev] += 1
        objs = []
        seen = set()
        for ref in task.args:
            if id(ref.obj) not in seen:
                seen.add(id(ref.obj))
                objs.append(ref.obj)
        need = frozenset(id(o) for o in objs if not o.has_copy(dev))
        if not need:
            return task, dev, None          # nothing to move
        fut = self._async_transfer(dev, lambda: (
            {id(o): self._ensure_on_device(o, dev, False) for o in objs},
            need), priority=depth)
        return task, dev, fut

    def _worker(self, device_hint: Optional[int]):
        """Per-device compute lane. Launches are asynchronous; their
        retirement is a progress-engine completion event on the device's
        ``("complete", dev)`` lane — the worker never polls in-flight
        handles (the old block_one loop). ``gate`` counts this worker's
        un-retired launches; at ``cfg.inflight`` the worker parks on the
        runtime condition until a completion event frees a slot."""
        staged: "collections.deque" = collections.deque()  # prefetched tasks
        depth = max(1, self.cfg.prefetch_depth)
        gate = {"n": 0}
        async_mode = not self.cfg.sync_dispatch and self.cfg.inflight > 1

        def retire(task, handle):
            # runs on the completion lane: free the window slot first so
            # the notify inside _finish wakes a worker that can launch
            with self._lock:
                gate["n"] -= 1
            self._finish(task, result=handle)

        while True:
            pmap = None
            item = None
            with self._lock:
                if self._shutdown:
                    return
                if async_mode and gate["n"] >= self.cfg.inflight:
                    self._work.wait(timeout=self.cfg.poll_interval_s * 20)
                    continue
            if staged:
                task, dev, pmap = staged.popleft()
                item = (task, dev)
            else:
                with self._lock:
                    if self._shutdown:
                        return
                    item = self.scheduler.pop(device_hint)
                    if item is not None:
                        task, dev = item
                        task.state = TaskState.RUNNING
                        task.chosen_device = dev
                        self.scheduler.load[dev] += 1
            if item is None:
                # nothing runnable: park until a push or a completion
                # event (retire → _finish) notifies the condition
                with self._lock:
                    if self._shutdown:
                        return
                    self._work.wait(timeout=self.cfg.poll_interval_s * 20)
                continue
            task, dev = item
            try:
                # timed on the card's compute stream, where the kernel runs
                with spans.span("runtime.launch", request=task.request,
                                stream=getattr(self._device(dev),
                                               "compute_stream", None),
                                task=task.id):
                    handle = self._launch(task, dev, pmap)
            except BaseException as e:
                # bounded relaunch (cfg.task_retries) before the error
                # surfaces: injected kernel faults / transient device
                # errors retry with pins intact — _finish unpins exactly
                # once at the final retirement
                attempts = getattr(task, "attempts", 0)
                if attempts < self.cfg.task_retries and not self._shutdown:
                    task.attempts = attempts + 1
                    with self._lock:
                        self._stats["task_retries"] += 1
                        self.scheduler.load[dev] -= 1
                        task.state = TaskState.READY
                        task.chosen_device = None
                        self.scheduler.push(task)
                        self._work.notify_all()
                    continue
                self._finish(task, error=e)
                continue
            # pipeline: claim the next prefetch_depth tasks + start their
            # transfers while the launch above computes; deeper positions
            # stage at lower transfer-queue priority
            if self.cfg.prefetch:
                while len(staged) < depth:
                    nxt = self._try_prefetch(device_hint,
                                             depth=1 + len(staged))
                    if nxt is None:
                        break
                    staged.append(nxt)
            if not async_mode:
                self._device(dev).synchronize(handle)
                self._finish(task, result=handle)
            else:
                with self._lock:
                    gate["n"] += 1
                self.engine.complete(
                    "complete", dev,
                    waiter=self._device(dev).completion_waiter(handle),
                    callback=lambda _r, _e, task=task, handle=handle:
                    retire(task, handle))

    def _launch(self, task: HeteroTask, device_id: int,
                prefetched: Optional[HFuture] = None):
        """Await prefetched argument copies (or stage synchronously), then
        launch asynchronously via the Device API."""
        staged: Dict[int, Any] = {}
        needed: frozenset = frozenset()
        overlapped = False
        # argument versions at launch time — the lineage record must pin
        # inputs to the generations this launch actually read
        pre_gens = [ref.obj.generation for ref in task.args] \
            if self.lineage is not None else None
        if prefetched is not None:
            # transfers were issued when the task was assigned; when they
            # completed during the previous task's compute the copy was
            # truly overlapped (a hit), otherwise the pipeline still had
            # to wait here (a stall) — the distinction the paper's
            # transfer-queue depth trades on (§4.1.3)
            overlapped = prefetched.done()
            staged, needed = prefetched.get()
            self.futures.release(prefetched)
        dev_args = []
        donate = []
        for i, ref in enumerate(task.args):
            arr = staged.get(id(ref.obj))
            if arr is not None:
                if id(ref.obj) in needed:
                    key = "prefetch_hits" if overlapped else \
                        "prefetch_stalls"
                    self._stats[key] += 1
            else:
                if self.cfg.prefetch and prefetched is None \
                        and not ref.obj.has_copy(device_id):
                    # popped directly (pipeline empty): the copy could not
                    # be overlapped with compute
                    self._stats["prefetch_misses"] += 1
                arr = self._ensure_on_device(ref.obj, device_id,
                                             will_write=False)
            dev_args.append(arr)
            if (ref.access.writes and self.cfg.cache_jit
                    and ref.obj.device_pins == 0):
                donate.append(i)
        if self._inject_task_faults > 0:
            # FaultInjector.fail_task planted a deterministic kernel fault
            with self._lock:
                if self._inject_task_faults > 0:
                    self._inject_task_faults -= 1
                    raise InjectedTaskFault(
                        f"injected kernel fault (task {task.name!r})")
        handle = self._device(device_id).launch(
            task.kernel, tuple(dev_args), donate=tuple(donate))
        # bind outputs back onto the written hetero_objects
        outs = handle if isinstance(handle, (tuple, list)) else (handle,)
        wi = 0
        for ref in task.args:
            if ref.access.writes:
                if wi < len(outs):
                    new_arr = outs[wi]
                    with ref.obj.lock:
                        for sp in list(ref.obj.copies):
                            self._drop_copy(ref.obj, sp)
                        ref.obj.copies[device_id] = new_arr
                        # every write-rebind is a new generation: lineage
                        # records are valid for exactly one version
                        ref.obj.generation += 1
                        self.residency.record(device_id, ref.obj)
                wi += 1
        if self.lineage is not None and wi:
            seen_w: set = set()
            out_gens = {}
            for ref in task.args:
                if ref.access.writes and id(ref.obj) not in seen_w:
                    seen_w.add(id(ref.obj))
                    out_gens[id(ref.obj)] = ref.obj.generation
            self.lineage.record(
                task.kernel,
                [(ref.obj, g, ref.access.reads, ref.access.writes)
                 for ref, g in zip(task.args, pre_gens, strict=True)],
                out_gens, device_id)
        return handle

    def _finish(self, task: HeteroTask, result=None, error=None):
        for obj in {id(r.obj): r.obj for r in task.args}.values():
            self.residency.unpin(obj)
        with self._lock:
            if error is not None:
                task.state = TaskState.FAILED
                self._stats["tasks_failed"] += 1
                if self.cfg.strict_errors and len(self._failed_tasks) < 64:
                    self._failed_tasks.append(error)
            else:
                task.state = TaskState.DONE
            if task.chosen_device is not None:
                self.scheduler.load[task.chosen_device] -= 1
            ready = dep.retire(task)
            for r in ready:
                r.state = TaskState.READY
                self.scheduler.push(r)
            self._tasks_pending -= 1
            self._work.notify_all()
        if error is not None:
            task.future.set_error(error)
        else:
            task.future.set_result(result)
