"""Unified asynchronous progress engine (paper §3.2.1 + §4.1.3).

The paper keeps communication progress decoupled from compute: control
messages stay cheap even while large payloads stream, because nothing
that makes progress ever blocks inside somebody else's loop. HPX and
DiOMP attribute the same overlap wins to a dedicated progress/completion
engine. This module is that engine, shared by every layer that used to
run its own ad-hoc loop:

  * the Runtime's per-device transfer queues  → ``("transfer", dev)`` lanes
  * the Runtime's in-flight launch polling    → ``("complete", dev)`` lanes
  * the distributed Rank's rendezvous stream  → ``("net-send", rank)`` lane
  * the distributed Rank's stream completion  → ``("net-recv", rank)`` lane
  * the simulated Cluster's per-link wires    → ``("link", src, dst)`` lanes

A ``Lane`` is a serial execution context draining a priority queue of
jobs (FIFO within a priority level). Jobs post their result into an
``HFuture`` — the completion event — instead of making the producer
wait. Because every lane is serial, state owned by a lane needs no
locks: post a job to mutate it.

Lanes no longer own a thread each. All of an engine's lanes are serviced
by one shared worker pool (``pool_workers`` threads) with lane affinity:

  * a lane with queued work holds a *run token* — exactly one worker may
    drain it at a time, so per-lane serial ordering is preserved;
  * a worker that drains a lane dry keeps it *sticky* for a short grace
    window (one timed queue read) so a hot lane's next job lands on the
    same warm worker without a handoff through the pool;
  * when every pool worker is parked inside a blocking job (completion
    waits, simulated wire time) and more lanes become runnable, the pool
    spawns short-lived *overflow* workers that retire after a brief idle
    TTL — forward progress never waits on a blocked sibling lane;
  * idle lanes cost nothing: creating a lane spawns no thread, so the
    hundreds of lanes a large topology implies no longer mean hundreds
    of idle threads. ``pool_workers=0`` restores the legacy
    thread-per-lane mode.

Completion events for device work use ``Lane.submit`` with a job that
performs the (cheap, already-dispatched) blocking wait and then runs the
continuation — a serial completion lane per device, never a poll loop in
the compute worker. Device launches complete in FIFO order per device,
which matches the per-device execution streams underneath.

Errors from fire-and-forget jobs (no future to carry them) are routed to
the engine's error sink instead of vanishing on stderr: the owning
``ProgressEngine`` records them, surfaces the count through
``Runtime.stats()["progress_errors"]``, and in strict mode re-raises the
first one from ``check()`` (called by ``Runtime.barrier``) so tests fail
loudly instead of hanging on a silently-dead continuation.
"""
from __future__ import annotations

import collections
import itertools
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import sanitizer
from repro_torch.core.futures import HFuture

LaneKey = Tuple[Any, ...]

# error sink keeps a bounded trace of swallowed asynchronous errors
_MAX_SINK_ERRORS = 100

# default shared-pool width per engine (0 = legacy thread-per-lane)
DEFAULT_POOL_WORKERS = 4

# how long a worker lingers on a drained lane before releasing its run
# token (hot-lane wake locality: a back-to-back submit skips the pool)
_STICKY_S = 100e-6

# idle TTL for overflow workers spawned past the base pool width
_OVERFLOW_TTL_S = 0.05


class _LanePool:
    """Shared worker pool servicing every lane of one engine.

    Runnable lanes sit in a ready deque; a lane enters it at most once
    (its ``_scheduled`` run token). ``_unclaimed`` counts notifies handed
    to idle workers that have not yet claimed a lane — a wake only rides
    an existing notify when one more idle worker remains to consume it,
    otherwise it spawns (base worker up to ``base``, overflow past it).
    That accounting closes the coalescing hole where two wakes share one
    notify, the single woken worker blocks inside the first lane's job,
    and the second lane starves."""

    def __init__(self, name: str, workers: int):
        self.name = name
        self.base = max(1, int(workers))
        self._lock = sanitizer.make_lock("LanePool._lock")
        self._cond = sanitizer.make_condition(self._lock)
        self._ready: "collections.deque" = collections.deque()
        self._idle = 0
        self._unclaimed = 0
        self._n_workers = 0
        self._n_base = 0
        self._shutdown = False
        self._wid = itertools.count()

    def worker_count(self) -> int:
        with self._lock:
            return self._n_workers

    def wake(self, lane: "Lane") -> None:
        """Make ``lane`` runnable. No-op if it already holds its run
        token (a worker is draining it, or it is queued)."""
        with self._lock:
            if lane._scheduled:
                return
            lane._scheduled = True
            self._ready.append(lane)
            if self._unclaimed < self._idle:
                self._unclaimed += 1
                self._cond.notify()
            elif self._n_base < self.base:
                self._n_base += 1
                self._spawn(base=True)
            else:
                self._spawn(base=False)

    def _spawn(self, base: bool) -> None:
        self._n_workers += 1
        threading.Thread(target=self._worker, args=(base,), daemon=True,
                         name=f"{self.name}-w{next(self._wid)}").start()

    def _worker(self, base: bool) -> None:
        while True:
            with self._lock:
                while not self._ready:
                    if self._shutdown:
                        self._retire(base)
                        return
                    self._idle += 1
                    got = self._cond.wait(None if base else _OVERFLOW_TTL_S)
                    self._idle -= 1
                    if not base and not got and not self._ready:
                        self._retire(base)  # overflow worker idled out
                        return
                lane = self._ready.popleft()
                if self._unclaimed:
                    self._unclaimed -= 1
            self._drain(lane)

    def _retire(self, base: bool) -> None:
        # caller holds self._lock
        self._n_workers -= 1
        if base:
            self._n_base -= 1

    def _drain(self, lane: "Lane") -> None:
        """Drain one lane while holding its run token. The final
        empty-check happens under the pool lock, serialized against
        ``wake``: a submit that lands after the check finds the token
        cleared and re-schedules the lane — no lost wakeup."""
        while True:
            try:
                item = lane._q.get(block=False)
            except queue.Empty:
                item = None
            if item is None:
                try:  # sticky grace: hot lanes keep their warm worker
                    item = lane._q.get(timeout=_STICKY_S)
                except queue.Empty:
                    item = None
            if item is None:
                with self._lock:
                    if lane._q.empty():
                        lane._scheduled = False
                        return
                continue
            _prio, _seq, fn, fut = item
            if fn is None:  # stop sentinel — sorts behind every real job
                with self._lock:
                    lane._scheduled = False
                lane._dead.set()
                return
            lane._run_job(fn, fut)

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            self._cond.notify_all()


class Lane:
    """One serial execution context: a named priority queue drained by
    the owning engine's worker pool (or, in legacy mode, a dedicated
    daemon thread). ``submit`` returns immediately; the job's completion
    is posted to the returned future. Lower priority runs first, FIFO
    within a priority level."""

    __slots__ = ("name", "kind", "_q", "_seq", "_pending", "_pending_lock",
                 "_executing", "_thread", "_stopped", "jobs_done",
                 "on_error", "_pool", "_scheduled", "_dead")

    def __init__(self, name: str,
                 on_error: Optional[Callable[[str, BaseException], None]]
                 = None, pool: Optional[_LanePool] = None,
                 kind: str = ""):
        self.name = name
        # lane type ("net-send", "transfer", ...) — the sanitizer's
        # lane-discipline policy is keyed on it (LANE_BLOCKING_OK)
        self.kind = kind
        self._q: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = itertools.count()
        # jobs accepted but not yet finished (queued + executing). The
        # counter moves at submit time and in the job's finally clause,
        # so there is no popped-but-unmarked window in which a mid-job
        # lane looks idle (the old `_executing`-only accounting was set
        # AFTER PriorityQueue.get() returned, and Cluster.barrier's
        # all-idle sweep could slip through that gap).
        self._pending = 0
        self._pending_lock = sanitizer.make_lock("Lane._pending_lock")
        self._executing = False
        self._stopped = False
        self.jobs_done = 0
        self.on_error = on_error
        self._pool = pool
        self._scheduled = False      # run token, guarded by pool lock
        self._dead = threading.Event()
        if pool is None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=name)
            self._thread.start()
        else:
            self._thread = None

    def submit(self, fn: Callable[[], Any], fut: Optional[HFuture] = None,
               priority: int = 0) -> Optional[HFuture]:
        """Enqueue ``fn``; its result (or error) lands in ``fut`` when the
        lane reaches it. ``fut=None`` posts fire-and-forget work.
        Submitting to a stopped lane raises ``RuntimeError`` (and resolves
        ``fut`` with that error first) — the old behaviour enqueued the
        job behind the infinite-priority stop sentinel, so it never ran
        and its future never resolved (a silent hang). The check and the
        enqueue share ``stop()``'s lock: a submit that wins the race
        lands its job BEFORE the sentinel (which sorts behind every
        queued job), so an accepted job always runs — identically in
        pooled and thread-per-lane modes."""
        with self._pending_lock:
            if self._stopped:
                err = RuntimeError(f"lane {self.name} is stopped")
                if fut is not None:
                    fut.set_error(err)
                raise err
            self._pending += 1
            self._q.put((priority, next(self._seq), fn, fut))
        if self._pool is not None:
            self._pool.wake(self)
        return fut

    def busy(self) -> bool:
        """True while the lane holds accepted-but-unfinished work. Backed
        by the pending counter (moved at submit / job-finally), so a job
        that has been popped off the queue but not yet started still
        counts — no idle-looking window mid-handoff."""
        return self._pending > 0

    def pending(self) -> int:
        """Accepted-but-unfinished jobs (queued + executing)."""
        return self._pending

    def backlog(self) -> int:
        """Jobs waiting behind the currently-executing one — the queue
        depth the adaptive flow controller feeds on (a lane with one
        in-service job and nothing queued is draining at line rate; a
        positive backlog means arrivals outpace the drain)."""
        return max(self._pending - (1 if self._executing else 0), 0)

    def _run_job(self, fn: Callable[[], Any], fut: Optional[HFuture]) -> None:
        # publish the lane context so the sanitizer can flag blocking
        # operations executed on strict serial lanes (no-op when off)
        san = sanitizer.current()
        tok = san.enter_lane(self.name, self.kind) if san is not None \
            else None
        self._executing = True
        try:
            result = fn()
        except BaseException as e:
            if fut is not None:
                fut.set_error(e)
            elif self.on_error is not None:
                self.on_error(self.name, e)
            else:                      # pragma: no cover - diagnostics
                import traceback
                traceback.print_exc()
        else:
            if fut is not None:
                fut.set_result(result)
        finally:
            self.jobs_done += 1
            self._executing = False
            if san is not None:
                san.exit_lane(tok)
            with self._pending_lock:
                self._pending -= 1

    def _run(self):
        # legacy thread-per-lane drain loop (pool_workers=0)
        while True:
            _prio, _seq, fn, fut = self._q.get()
            if fn is None:
                self._dead.set()
                return
            self._run_job(fn, fut)

    def stop(self, join_timeout: float = 5.0) -> None:
        with self._pending_lock:     # atomic with submit's check+enqueue
            if self._stopped:
                return
            self._stopped = True
            # inf priority: the sentinel sorts behind every queued job
            self._q.put((float("inf"), next(self._seq), None, None))
        if self._pool is not None:
            self._pool.wake(self)    # a worker must consume the sentinel
            self._dead.wait(timeout=join_timeout)
        else:
            self._thread.join(timeout=join_timeout)


class ProgressEngine:
    """Reactor over typed lanes. Layers ask for a lane by ``(kind, key)``
    — ``("transfer", device_id)``, ``("net-send", rank)``, ``("link",
    src, dst)`` — and get the same serial context every time; lanes are
    created on first use and serviced by the engine's shared worker pool
    (``pool_workers`` base threads + transient overflow; ``0`` restores
    one dedicated thread per lane). ``submit`` is the one-call sugar;
    ``complete`` posts a completion event: run ``waiter`` (a blocking
    ready-wait for work that was already dispatched asynchronously) on
    the kind's completion lane, then hand the result to ``callback``.

    ``strict=True`` turns the error sink into a tripwire: ``check()``
    re-raises the first swallowed fire-and-forget error (tests call it
    through ``Runtime.barrier``)."""

    def __init__(self, name: str = "progress", strict: bool = False,
                 pool_workers: int = DEFAULT_POOL_WORKERS):
        self.name = name
        self.strict = strict
        self._lanes: Dict[LaneKey, Lane] = {}
        self._lock = sanitizer.make_lock("ProgressEngine._lock")
        self._shutdown = False
        self._errors: List[Tuple[str, BaseException]] = []
        self._pool = (_LanePool(name, pool_workers)
                      if pool_workers > 0 else None)

    # -- error sink ----------------------------------------------------
    def _record_error(self, lane_name: str, exc: BaseException) -> None:
        with self._lock:
            self._errors.append((lane_name, exc))
            del self._errors[:-_MAX_SINK_ERRORS]
        if not self.strict:                # keep the stderr trace too
            import traceback
            traceback.print_exception(type(exc), exc, exc.__traceback__)

    def error_count(self) -> int:
        with self._lock:
            return len(self._errors)

    def errors_snapshot(self) -> List[str]:
        with self._lock:
            return [f"{lane}: {type(exc).__name__}: {exc}"
                    for lane, exc in self._errors]

    def check(self) -> None:
        """Strict mode: re-raise the first swallowed asynchronous error.
        A no-op when not strict (the sink still counts them)."""
        if not self.strict:
            return
        with self._lock:
            first = self._errors[0] if self._errors else None
        if first is not None:
            lane, exc = first
            raise RuntimeError(
                f"progress engine {self.name}: swallowed error on lane "
                f"{lane}") from exc

    # -- lanes ---------------------------------------------------------
    def lane(self, kind: str, *key: Any) -> Lane:
        k = (kind,) + key
        with self._lock:
            ln = self._lanes.get(k)
            if ln is None:
                if self._shutdown:
                    raise RuntimeError("progress engine is shut down")
                tag = "-".join(str(p) for p in k)
                ln = Lane(f"{self.name}-{tag}", on_error=self._record_error,
                          pool=self._pool, kind=kind)
                self._lanes[k] = ln
            return ln

    def peek(self, kind: str, *key: Any) -> Optional[Lane]:
        """The ``(kind, key)`` lane if it already exists — without
        spawning one (introspection / fast-path checks)."""
        with self._lock:
            return self._lanes.get((kind,) + key)

    def worker_threads(self) -> int:
        """Live worker threads servicing this engine's lanes. Pool mode:
        the pool's current width (base + overflow). Legacy mode: one per
        lane."""
        if self._pool is not None:
            return self._pool.worker_count()
        with self._lock:
            return len(self._lanes)

    def backlogs(self) -> Dict[str, int]:
        """Queue depth of every lane that currently has work backed up —
        the diagnostic attached to barrier timeouts and the lane-pressure
        signal straggler detection reads. Busy-but-draining lanes with an
        empty queue report 0 and are omitted."""
        with self._lock:
            lanes = list(self._lanes.items())
        out: Dict[str, int] = {}
        for key, ln in lanes:
            b = ln.backlog()
            if b:
                out["-".join(str(p) for p in key)] = b
        return out

    def submit(self, kind: str, key: Any, fn: Callable[[], Any],
               fut: Optional[HFuture] = None,
               priority: int = 0) -> Optional[HFuture]:
        return self.lane(kind, key).submit(fn, fut, priority)

    # -- completion events ---------------------------------------------
    def complete(self, kind: str, key: Any, waiter: Callable[[], Any],
                 callback: Callable[[Any, Optional[BaseException]], None]
                 ) -> None:
        """Post a completion event: the ``(kind, key)`` completion lane
        runs ``waiter()`` (blocking until the already-dispatched work is
        done) and then ``callback(result, error)``. The producer never
        blocks — this is the dedicated completion thread the paper's
        progress engine trades the per-call poll loop for. Events on one
        lane fire in submission order (FIFO per device stream)."""

        def job():
            result, error = None, None
            try:
                result = waiter()
            except BaseException as e:
                error = e
            callback(result, error)

        self.lane(kind, key).submit(job)

    # -- introspection / teardown --------------------------------------
    def busy(self) -> bool:
        with self._lock:
            lanes = list(self._lanes.values())
        return any(ln.busy() for ln in lanes)

    def lanes_snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            lanes = dict(self._lanes)
        return {
            "-".join(str(p) for p in k): {
                "jobs_done": ln.jobs_done, "busy": ln.busy(),
            }
            for k, ln in sorted(lanes.items(), key=lambda kv: str(kv[0]))
        }

    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            lanes = list(self._lanes.values())
        for ln in lanes:
            ln.stop()
        if self._pool is not None:
            self._pool.shutdown()
