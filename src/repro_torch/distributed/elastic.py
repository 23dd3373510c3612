"""Elastic scaling + fault handling (large-scale runnability layer;
``repro/distributed/elastic.py`` at the same path).

A pod/rank loss is handled as: detect (missed heartbeat) → shrink the worker
set → replay the owner map against the new world → restore chunk data from
the last checkpoint (or from surviving replicas) → continue. Growth is the
same flow without restore. Straggler mitigation reuses the same machinery
with fractional "slowdown" loads feeding the greedy rebalancer — the
over-decomposed chunks are the unit of migration, exactly the paper's
argument for over-decomposition.

Two layers live here:

``ElasticController`` — pure control logic (no I/O, no transport). Health
bookkeeping runs on an **injectable monotonic clock** (``clock=``, default
``time.monotonic``): wall-clock NTP jumps can never mass-declare failures,
and tests drive detection with a fake clock.

``ElasticRuntime`` — binds the controller to a live ``Cluster``: heartbeats
ride the billed control VC as periodic 0-byte control messages
(``Rank.enable_heartbeat``), ``poll()`` fuses three straggler/failure
signals (heartbeat gap, ``InterconnectModel`` EWMA latency outliers,
net-lane backlog), and detection executes plans FOR REAL — survivors sweep
the dead peer (``Rank.remove_peer``), lost chunks are restored from the
checkpoint (or a surviving replica) into consumer-routed rendezvous
streams, stragglers have chunks live-migrated off them while they keep
computing, and the owner map / residency ledgers are replayed against the
new world. ``epoch`` increments after every world change so callers can
re-plan mid-iteration.

A chunk that leaves a rank (migrated, replaced by a newer replica, stale on
a rank that rejoined) is dropped with ``forget``: its copies are released
as well as its residency, so on a card the memory is freed even where a
lineage record still references the object.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import sanitizer
from repro_torch.distributed import handlers as H
from repro_torch.distributed.mobile_object import OwnerMap, rebalance_greedy


def forget(rank, obj) -> None:
    """``obj`` left ``rank`` for good: release its copies (a card's memory
    with them) and drop its residency and pins."""
    obj.free()
    rank.runtime.residency.forget(obj)


@dataclasses.dataclass
class WorkerHealth:
    last_heartbeat: float
    slowdown: float = 1.0        # >1 = straggler
    alive: bool = True


class ElasticController:
    """Tracks worker health; emits migration/remap plans. Pure control logic
    (no I/O) so it is unit-testable and reusable by the launcher. All
    timestamps come from the injected monotonic ``clock`` — never from
    wall-clock ``time.time()``, which jumps under NTP adjustment."""

    def __init__(self, workers: Sequence[int], heartbeat_timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.health: Dict[int, WorkerHealth] = {
            w: WorkerHealth(self.clock()) for w in workers}
        self.timeout = heartbeat_timeout

    # -- health -------------------------------------------------------------
    def heartbeat(self, worker: int, slowdown: float = 1.0,
                  now: Optional[float] = None) -> None:
        h = self.health[worker]
        h.last_heartbeat = now if now is not None else self.clock()
        h.slowdown = slowdown
        h.alive = True

    def detect_failures(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else self.clock()
        dead = []
        for w, h in self.health.items():
            if h.alive and now - h.last_heartbeat > self.timeout:
                h.alive = False
                dead.append(w)
        return dead

    def alive_workers(self) -> List[int]:
        return [w for w, h in self.health.items() if h.alive]

    # -- plans ----------------------------------------------------------
    def shrink_plan(self, owner: OwnerMap, dead: Sequence[int]
                    ) -> List[Tuple[int, int, int]]:
        """Reassign every chunk owned by dead workers round-robin over the
        survivors. Returns [(oid, old, new)]; data for these chunks must be
        restored from checkpoint (the old rank is gone)."""
        alive = self.alive_workers()
        if not alive:
            raise RuntimeError("no surviving workers")
        plan = []
        i = 0
        for d in dead:
            for oid in owner.owned_by(d):
                dst = alive[i % len(alive)]
                owner.migrate(oid, dst)
                plan.append((oid, d, dst))
                i += 1
        return plan

    def grow_plan(self, owner: OwnerMap, new_workers: Sequence[int],
                  chunk_load: Optional[Dict[int, float]] = None
                  ) -> List[Tuple[int, int, int]]:
        for w in new_workers:
            self.health[w] = WorkerHealth(self.clock())
        loads = self.effective_loads(owner, chunk_load)
        cl = chunk_load or {}
        return rebalance_greedy(loads, owner, cl,
                                max_moves=max(8, len(owner) // 4))

    def straggler_plan(self, owner: OwnerMap,
                       chunk_load: Optional[Dict[int, float]] = None,
                       max_moves: Optional[int] = None
                       ) -> List[Tuple[int, int, int]]:
        loads = self.effective_loads(owner, chunk_load)
        if max_moves is None:
            max_moves = len(owner) // 4 or 1
        return rebalance_greedy(loads, owner, chunk_load or {},
                                max_moves=max_moves)

    def effective_loads(self, owner: OwnerMap,
                        chunk_load: Optional[Dict[int, float]] = None
                        ) -> Dict[int, float]:
        cl = chunk_load or {}
        loads: Dict[int, float] = {w: 0.0 for w in self.alive_workers()}
        for oid, rank in owner.items():
            if rank in loads:
                loads[rank] += cl.get(oid, 1.0) * self.health[rank].slowdown
        return loads


# ---------------------------------------------------------------------------
# transport bindings: heartbeat sink + chunk-restore landing
# ---------------------------------------------------------------------------

@H.handler(name="elastic_heartbeat")
def _elastic_heartbeat(ctx, obj):
    """Monitor-side heartbeat sink: a 0-byte control-VC message from a
    worker's pump loop arrived. Timestamped with the ElasticRuntime's own
    injectable clock at arrival (the controller never sees send-side
    wall-clock)."""
    er = getattr(ctx.rank.cluster, "_elastic", None)
    if er is not None:
        er._on_heartbeat(ctx.message.user["worker"])


@H.handler(name="elastic_restore")
def _elastic_restore(ctx, obj):
    """Landing half of a chunk migration/restore: register the payload
    under its global key on the new owner and notify the coordinator.
    Payloads arrive consumer-routed (device hint from the owner map) and —
    above the eager threshold — as credit-windowed rendezvous streams."""
    u = ctx.message.user or {}
    key = u.get("key")
    if key is not None and obj is not None:
        ctx.rank.register_object(key, obj)
    ctx.rank.stats["chunks_migrated"] += 1
    er = getattr(ctx.rank.cluster, "_elastic", None)
    if er is not None:
        er._on_restore(u.get("token"),
                       obj.nbytes if obj is not None else 0)


class ElasticRuntime:
    """The detect → drain → migrate → resume loop on a live ``Cluster``.

    ``owner`` maps chunk oid → rank; ``key_fn(oid)`` names the chunk in
    each rank's object registry; ``restore_fn(oid)`` produces the chunk's
    last committed bytes (checkpoint read) when no surviving replica
    exists, and ``recompute_fn(oid)`` is the last line of defence when
    the checkpoint read itself fails (corrupted/missing leaf) — e.g. a
    lineage replay or an application-level recompute. ``poll()`` is the
    whole loop body — callable inline for deterministic tests, or from
    the background monitor (``start()``).

    World changes (``recover``/``drain``/``grow``) run under ``_lock``,
    finish all data movement (``quiesce``) and only then bump ``epoch`` —
    a caller that plans an iteration under ``hold()`` sees a consistent
    owner map with no migration in flight."""

    def __init__(self, cluster, owner: OwnerMap, *,
                 key_fn: Optional[Callable[[int], Any]] = None,
                 restore_fn: Optional[Callable[[int], np.ndarray]] = None,
                 recompute_fn: Optional[Callable[[int], np.ndarray]] = None,
                 chunk_load: Optional[Dict[int, float]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 monitor: int = 0,
                 heartbeat_interval_s: Optional[float] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 straggler_factor: float = 25.0,
                 drain_cooldown_s: float = 1.0,
                 quiesce_timeout_s: float = 60.0):
        cfg = cluster.ranks[monitor].runtime.cfg
        self.cluster = cluster
        self.owner = owner
        self.key_fn = key_fn or (lambda oid: ("chunk", oid))
        self.restore_fn = restore_fn
        self.recompute_fn = recompute_fn
        self.chunk_load = chunk_load
        self.clock = clock
        self.monitor = monitor
        self.interval = heartbeat_interval_s or cfg.heartbeat_interval_s
        self.timeout = heartbeat_timeout_s or cfg.heartbeat_timeout_s
        self.straggler_factor = straggler_factor
        self.drain_cooldown_s = drain_cooldown_s
        self.quiesce_timeout_s = quiesce_timeout_s
        self.controller = ElasticController(
            [r.rank for r in cluster.ranks],
            heartbeat_timeout=self.timeout, clock=clock)
        self.epoch = 0
        self._lock = sanitizer.make_rlock("ElasticRuntime._lock")
        self._beats: List[Tuple[int, float]] = []
        self._beats_lock = sanitizer.make_lock("ElasticRuntime._beats_lock")
        self._tokens = itertools.count()
        self._landings: Dict[int, threading.Event] = {}
        self._pending: List[Tuple[threading.Event, Any, Any, bool]] = []
        self._last_drain: Dict[int, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.stats: Dict[str, Any] = {
            "recoveries": 0, "drains": 0, "grows": 0,
            "chunks_migrated": 0, "bytes_migrated": 0,
            "recovery_stall_s": 0.0, "dead": [], "stragglers": [],
            "straggler_signals": {}, "poll_errors": 0,
            "restore_fallbacks": 0,
            # the longest heartbeat gap a poll saw (worker ranks while
            # alive): what a heartbeat timeout must stay above
            "heartbeat_gap_max_s": 0.0,
        }
        cluster._elastic = self
        for r in cluster.ranks:
            r.enable_heartbeat(monitor, self.interval)

    # -- transport callbacks (pump threads) ----------------------------
    def _on_heartbeat(self, worker: int) -> None:
        with self._beats_lock:
            self._beats.append((worker, self.clock()))

    def _on_restore(self, token: Optional[int], nbytes: int) -> None:
        self.stats["bytes_migrated"] += nbytes
        ev = self._landings.pop(token, None) if token is not None else None
        if ev is not None:
            ev.set()

    # -- monitor loop --------------------------------------------------
    def start(self, period: Optional[float] = None) -> None:
        """Run ``poll()`` on a background monitor thread every ``period``
        seconds (default: the heartbeat interval)."""
        if self._thread is not None:
            return
        self._stop_evt.clear()
        period = period or self.interval

        def loop():
            while not self._stop_evt.wait(period):
                try:
                    self.poll()
                except Exception:
                    self.stats["poll_errors"] += 1

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="elastic-monitor")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=10)
        self._thread = None

    def close(self) -> None:
        """Stop monitoring and detach from the cluster: heartbeats off,
        backref cleared. The cluster itself stays usable."""
        self.stop()
        for r in self.cluster.ranks:
            r._hb_dst = None
        if getattr(self.cluster, "_elastic", None) is self:
            self.cluster._elastic = None

    def hold(self):
        """Context: block world changes while a caller plans/executes an
        iteration phase against the current owner map."""
        return self._lock

    def quiesce(self, timeout: Optional[float] = None) -> None:
        """Wait until every initiated migration landed at its new owner,
        then replay the residency ledger on each source rank (the chunk
        left; its replicas must not count against that rank)."""
        timeout = timeout or self.quiesce_timeout_s
        with self._lock:
            pending, self._pending = self._pending, []
            for ev, src_rank, key, drop_src in pending:
                if not ev.wait(timeout):
                    raise TimeoutError(
                        f"elastic migration of {key!r} from rank "
                        f"{src_rank.rank} did not land within {timeout:.0f}s")
                if drop_src:
                    obj = src_rank.objects.pop(key, None)
                    if obj is not None:
                        forget(src_rank, obj)

    # -- detection -----------------------------------------------------
    def _slowdown(self, w: int, gap: float) -> Tuple[float, Dict[str, float]]:
        """Fuse the three straggler signals into one slowdown factor:
        heartbeat gap (liveness), EWMA latency outlier ratio on the
        worker's links toward the monitor (the interconnect model sees a
        frozen rank's delayed traffic), and the worker's net-lane backlog
        (work piling up behind a slow pump)."""
        gap_ratio = gap / self.interval if self.interval > 0 else 1.0
        alive = [x for x in self.controller.alive_workers()
                 if x != self.monitor]
        ratios = self.cluster.topology.latency_outliers(alive, self.monitor)
        lat_ratio = ratios.get(w, 1.0)
        r = self.cluster.ranks[w]
        backlog = r._net_send.backlog() + r._net_recv.backlog()
        score = max(1.0, gap_ratio, lat_ratio * (1.0 + backlog))
        return score, {"gap_ratio": gap_ratio, "latency_ratio": lat_ratio,
                       "backlog": float(backlog)}

    def poll(self) -> Dict[str, Any]:
        """One monitor sweep: drain heartbeat arrivals into the
        controller, score stragglers, detect failures, and execute
        recovery / straggler drains. Returns what happened."""
        with self._lock:
            with self._beats_lock:
                beats, self._beats = self._beats, []
            for worker, t in beats:
                if worker in self.controller.health:
                    self.controller.heartbeat(worker, now=t)
            now = self.clock()
            mon = self.cluster.ranks[self.monitor]
            stragglers = []
            for w in self.controller.alive_workers():
                if w == self.monitor:
                    continue
                h = self.controller.health[w]
                gap = now - h.last_heartbeat
                self.stats["heartbeat_gap_max_s"] = max(
                    self.stats["heartbeat_gap_max_s"], gap)
                if gap > 1.5 * self.interval:
                    mon.stats["heartbeats_missed"] += 1
                score, signals = self._slowdown(w, gap)
                h.slowdown = score
                if score >= self.straggler_factor and gap <= self.timeout:
                    cool = self._last_drain.get(w, -1e9)
                    if now - cool >= self.drain_cooldown_s:
                        stragglers.append((w, score, signals))
            dead = self.controller.detect_failures(now)
            events: Dict[str, Any] = {"dead": dead, "drained": []}
            if dead:
                self.recover(dead)
                return events
            for w, score, signals in stragglers:
                moved = self.drain(w)
                if moved:
                    self._last_drain[w] = now
                    self.stats["stragglers"].append(w)
                    self.stats["straggler_signals"][w] = signals
                    events["drained"].append((w, moved))
            return events

    # -- world changes -------------------------------------------------
    def _bump_epoch(self) -> None:
        """Commit a world change: bump the epoch AND drop every rank's
        compiled task graph — replay plans captured placements and
        residency under the old world, and a migrated/restored chunk
        invalidates both (callers' epoch-redo loops re-trace on the new
        topology)."""
        self.epoch += 1
        for r in self.cluster.ranks:
            r.runtime.invalidate_traces()
            if r.runtime.lineage is not None:
                # records stay (generation checks keep them safe); new
                # ones carry the new epoch for forensics
                r.runtime.lineage.bump_epoch()

    @contextlib.contextmanager
    def _world_change(self, dead: Sequence[int] = ()):
        """A world change commits whole or not at all. Where it raises, the
        owner map and the workers' health go back to what they were
        (``dead``, the workers a failed recovery declared dead, count as
        alive again, so that the next poll retries), and the epoch stays.
        The monitor thread swallows a poll's exception: without this, a
        recovery that found no copy of a lost chunk (a worker declared dead
        before its first replica or checkpoint) left the owner map pointing
        at a rank that never received the chunk under an unchanged epoch,
        and the caller's next phase looked for the chunk there."""
        owners = self.owner.snapshot()
        health = dict(self.controller.health)
        alive = {w: h.alive for w, h in health.items()}
        try:
            yield
        except BaseException:
            self.owner.restore(owners)
            self.controller.health = health
            for w, h in health.items():
                h.alive = alive[w] or w in dead
            raise

    def _alive_ranks(self, exclude: Sequence[int] = ()) -> List[Any]:
        alive = set(self.controller.alive_workers()) - set(exclude)
        return [r for r in self.cluster.ranks if r.rank in alive]

    def _migrate(self, src_rank, dst: int, key: Any, obj, oid: int,
                 drop_src: bool = True) -> None:
        token = next(self._tokens)
        ev = threading.Event()
        self._landings[token] = ev
        self._pending.append((ev, src_rank, key, drop_src))
        src_rank.send(dst, "elastic_restore", obj,
                      user={"key": key, "token": token, "oid": oid},
                      consumer_device=self.owner.device_hint(oid))

    def recover(self, dead: Sequence[int]) -> List[Tuple[int, int, int]]:
        """Execute the shrink: survivors sweep the dead peers' rendezvous
        state, the owner map is replayed over the survivors, and each lost
        chunk is restored — from a surviving replica when one exists
        (another rank already registered the key), else from
        ``restore_fn`` (checkpoint) — streamed to its new owner. The
        monitor rank's ``recovery_stall_s`` records the full detect-side
        stall; ``epoch`` bumps once everything landed. Every lost chunk's
        source is found before anything moves; where one has none, the
        world stays as it was (``_world_change``) and this raises."""
        with self._lock, self._world_change(dead):
            t0 = self.clock()
            for d in dead:
                if d in self.controller.health:
                    self.controller.health[d].alive = False
            survivors = self._alive_ranks()
            plan = self.controller.shrink_plan(self.owner, dead)
            mon = self.cluster.ranks[self.monitor]
            moves = []      # (src rank, new owner, key, object, oid, drop)
            for oid, old, new in plan:
                key = self.key_fn(oid)
                replica = next((r for r in survivors if key in r.objects),
                               None)
                if replica is not None:
                    if replica.rank != new:
                        moves.append((replica, new, key,
                                      replica.objects[key], oid, True))
                    continue
                # no surviving replica: checkpoint first, then lineage
                # recompute (the checkpoint itself may be corrupted or
                # missing — integrity validation raises rather than
                # restoring garbage), then give up loudly
                arr = None
                restore_err: Optional[BaseException] = None
                if self.restore_fn is not None:
                    try:
                        arr = np.asarray(self.restore_fn(oid))
                    except Exception as e:
                        restore_err = e
                if arr is None and self.recompute_fn is not None:
                    arr = np.asarray(self.recompute_fn(oid))
                    self.stats["restore_fallbacks"] += 1
                if arr is None:
                    raise RuntimeError(
                        f"chunk {oid} lost with rank {old}: no surviving "
                        "replica, no restorable checkpoint "
                        f"({restore_err!r}), and no recompute_fn "
                        "configured") from restore_err
                moves.append((mon, new, key, mon.runtime.hetero_object(arr),
                              oid, False))
            for d in dead:
                for r in survivors:
                    r.remove_peer(d)
            for src, new, key, obj, oid, drop in moves:
                self._migrate(src, new, key, obj, oid, drop_src=drop)
            self.quiesce()
            stall = self.clock() - t0
            mon.stats["recovery_stall_s"] += stall
            self.stats["recoveries"] += 1
            self.stats["recovery_stall_s"] += stall
            self.stats["dead"].extend(int(d) for d in dead)
            self._bump_epoch()
            return plan

    def drain(self, straggler: int,
              max_moves: Optional[int] = None) -> List[Tuple[int, int, int]]:
        """Live-migrate chunks off a slow-but-alive rank: the controller's
        slowdown-inflated loads feed the greedy rebalancer, and each moved
        chunk streams from the straggler to its new owner as a rendezvous
        stream WHILE the straggler keeps computing its remaining chunks —
        the paper's over-decomposition argument made operational."""
        with self._lock, self._world_change():
            if max_moves is None:
                owned = len(self.owner.owned_by(straggler))
                max_moves = max(1, owned // 2)
            plan = self.controller.straggler_plan(
                self.owner, self.chunk_load, max_moves=max_moves)
            # straggler_plan already remapped the owner map for every
            # planned move; only the straggler's moves are executed here,
            # so roll the others back or the map would point at ranks
            # that never received the data
            keep = []
            for oid, src, dst in plan:
                if src == straggler:
                    keep.append((oid, src, dst))
                else:
                    self.owner.migrate(oid, src)
            plan = keep
            for oid, src, dst in plan:
                key = self.key_fn(oid)
                src_rank = self.cluster.ranks[src]
                obj = src_rank.objects.get(key)
                if obj is None:      # data not registered: undo the remap
                    self.owner.migrate(oid, src)
                    continue
                self._migrate(src_rank, dst, key, obj, oid)
            self.quiesce()
            if plan:
                self.stats["drains"] += 1
                self.stats["chunks_migrated"] += len(plan)
                self._bump_epoch()
            return plan

    def grow(self, new_workers: Sequence[int]
             ) -> List[Tuple[int, int, int]]:
        """A rank (re)joined: sweep its stale protocol state, fold it back
        into the health set, and rebalance chunks onto it with live
        migrations from their current owners."""
        with self._lock, self._world_change():
            for w in new_workers:
                r = self.cluster.ranks[w]
                r.reset_peer_state()
                # Chunks registered before the rank left are stale: the
                # survivors restored them elsewhere and kept computing. If
                # they stayed registered, a later recovery could mistake
                # them for live replicas and resurrect old data.
                for oid, own in list(self.owner.items()):
                    if own != w:
                        obj = r.objects.pop(self.key_fn(oid), None)
                        if obj is not None:
                            forget(r, obj)
            plan = self.controller.grow_plan(self.owner, new_workers,
                                             self.chunk_load)
            for oid, src, dst in plan:
                key = self.key_fn(oid)
                src_rank = self.cluster.ranks[src]
                obj = src_rank.objects.get(key)
                if obj is None:
                    self.owner.migrate(oid, src)
                    continue
                self._migrate(src_rank, dst, key, obj, oid)
            self.quiesce()
            if plan:
                self.stats["grows"] += 1
                self.stats["chunks_migrated"] += len(plan)
                self._bump_epoch()
            return plan

    def report(self) -> Dict[str, Any]:
        mon = self.cluster.ranks[self.monitor]
        rep = {
            "elastic": dict(self.stats),
            "monitor_stats": {k: mon.stats[k] for k in
                              ("heartbeats_missed", "recovery_stall_s",
                               "retries", "chunks_migrated")},
        }
        san = sanitizer.current()
        if san is not None:
            rep["sanitizer"] = san.stats_snapshot()
        return rep
