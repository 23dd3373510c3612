"""Concurrency sanitizer: dynamic lock-order, lane-discipline, wait-graph
and gauge-hygiene analysis for the runtime (enabled via
``RuntimeConfig.sanitize`` / ``REPRO_SANITIZE=1``).

The runtime's failure mode is the silent deadlock or leak, not the
crash: continuation-driven protocols (credit-windowed rendezvous
streams, collective phase hops, the shared lane worker pool) hang or
strand state instead of raising. Each such bug used to be fixed by
hand; this module turns the bug classes into machine-checked properties:

* **Lock-order analysis** (TSan lockset style): runtime locks are built
  through ``make_lock``/``make_rlock``/``make_condition`` — with the
  sanitizer off these return plain ``threading`` primitives (zero
  overhead); with it on they return order-tracking proxies feeding a
  global *may-precede* graph at lock-NAME granularity. A cycle in that
  graph is a potential deadlock even on runs that happen not to hang.
  Same-name edges are excluded (two ``HeteroObject.lock`` instances
  never nest in this codebase; a name-granularity self-edge would be
  pure noise) and non-blocking (try-)acquires add no edges — a trylock
  cannot deadlock.

* **Lane discipline**: ``Lane._run_job`` publishes the executing lane
  into a thread-local; blocking operations observed there — an
  ``HFuture.get`` that actually waited, a contended tracked-lock acquire
  above ``block_threshold_s``, a simulated-wire sleep — are flagged when
  the lane's kind is not in ``LANE_BLOCKING_OK``. This is a bug class
  once fixed by hand (a blocking wait on the net-send lane stalls every
  stream multiplexed onto it).

* **Distributed wait-for graph**: built on demand from live protocol
  state (stalled ``_rdzv_out`` windows awaiting credits, incomplete
  ``_rdzv_in`` streams awaiting chunks, unacked reliable sends, metas
  without payload halves, pending collective ops). A cycle names a root
  cause; ``Cluster.barrier`` timeout diagnostics attach the verdict. A
  cycle only counts when its edges span >= 2 distinct streams — the two
  complementary halves of ONE healthy in-flight stream always form a
  trivial 2-cycle (sender waits on credits from the receiver that is
  still uploading its chunks) and must not be reported.

* **Gauge hygiene**: at ``Rank.shutdown`` every ``state_gauges()`` leak
  gauge must have drained to zero, or the sanitizer raises naming the
  owning stream/peer. The assertion applies to clean runs only (no
  ``FaultInjector`` attached): faulted runs legitimately strand state
  that the shutdown sweep reclaims.

The sanitizer is process-global (``install()``/``current()``): lock
identity crosses Runtime/Rank/Cluster boundaries, so a per-instance
graph would miss exactly the cross-component inversions it exists to
find. Counters surface as ``Runtime.stats()["sanitizer"]``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

__all__ = [
    "SanitizerError", "RuntimeSanitizer", "WaitGraph",
    "install", "uninstall", "current", "env_enabled",
    "make_lock", "make_rlock", "make_condition",
    "LANE_BLOCKING_OK", "lane_blocking_ok",
    "build_wait_graph", "waitgraph_verdict", "gauge_leak_report",
]


class SanitizerError(RuntimeError):
    """A sanitizer assertion failed (lock-order cycle, gauge leak)."""


# Lane kinds whose jobs are ALLOWED to block. These lanes exist to
# absorb a wait (completion events, simulated wire time) or perform
# documented tail waits that cannot feed back into their own drain
# (net-recv finish waits on transfer-lane uploads; transfer-lane reduce
# steps wait on a prior upload of the same stream — see the
# `# lint: allow-blocking` sites in messaging.py). Every other kind —
# most importantly "net-send", which multiplexes ALL of a rank's
# outbound streams — is serial control flow and must never block.
LANE_BLOCKING_OK = frozenset({
    "complete", "transfer", "net-recv",
    "link", "linkprop", "linkctl", "fault",
})

# leak gauges: the Rank.state_gauges() keys that must drain to zero by
# shutdown on a clean (fault-free) run
_LEAK_GAUGES = ("rdzv_out", "rdzv_in", "rdzv_bufs",
                "pending_meta", "rdzv_sent", "unacked")

_MAX_EVENTS = 100        # bounded lane-blocking event trace


def lane_blocking_ok(kind: str) -> bool:
    return kind in LANE_BLOCKING_OK


def env_enabled() -> bool:
    """CI switch: ``REPRO_SANITIZE=1`` turns ``RuntimeConfig.sanitize``
    on by default for every runtime in the process."""
    return os.environ.get("REPRO_SANITIZE", "") == "1"


# ---------------------------------------------------------------------------
# tracked lock proxies
# ---------------------------------------------------------------------------

class _TrackedLock:
    """Order-tracking proxy around ``threading.Lock``. Delegates the
    full lock protocol so ``threading.Condition`` can wrap it."""

    __slots__ = ("_inner", "name", "_san")
    _reentrant = False

    def __init__(self, name: str, san: "RuntimeSanitizer"):
        # constructed per future/object on the task hot path: one inner
        # primitive, no factory-method hop
        self._inner = threading.Lock()
        self.name = name
        self._san = san

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Hot path: an uncontended trylock first skips BOTH
        # perf_counter reads; bookkeeping is inlined (no helper-call
        # chain) — the replay fast path takes these locks per task and
        # the sanitize-on overhead budget is 10%.
        san = self._san
        inner = self._inner
        if not blocking:
            if inner.acquire(False):
                # trylocks cannot deadlock: track held-ness (for release
                # symmetry) but add no may-precede edges
                san._local.held.append(self)
                return True
            return False
        if not inner.acquire(False):
            t0 = time.perf_counter()
            if not inner.acquire(True, timeout):
                return False
            waited = time.perf_counter() - t0
            if waited >= san.block_threshold_s:
                san._note_blocking("lock-acquire", waited, self.name)
        # may-precede edges record ORDER, not contention: a blocking
        # acquire contributes them even when it happened not to wait
        st = san._local
        held = st.held
        if held:
            nm = self.name
            cache = st.edge_cache
            for h in held:
                hn = h.name
                if hn != nm:                 # same-name nesting: excluded
                    pair = (hn, nm)
                    if pair not in cache:
                        cache.add(pair)
                        with san._glock:
                            if pair not in san._edges:
                                san._edges[pair] = \
                                    threading.current_thread().name
        held.append(self)
        return True

    def release(self) -> None:
        held = self._san._local.held
        if held and held[-1] is self:        # LIFO release: common case
            held.pop()
        else:
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
            # not found: acquired before install — ignore
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # match threading.Lock semantics: __enter__ IS acquire (returns True)
    __enter__ = acquire

    def __exit__(self, *exc):
        # release() inlined: one Python frame per with-block, not two —
        # the tracked cycle is on the per-task hot path
        held = self._san._local.held
        if held and held[-1] is self:        # LIFO release: common case
            held.pop()
        else:
            for i in range(len(held) - 1, -1, -1):
                if held[i] is self:
                    del held[i]
                    break
        self._inner.release()
        return False

    def __repr__(self):  # pragma: no cover - diagnostics
        return f"<tracked {type(self).__name__} {self.name!r}>"


class _TrackedRLock(_TrackedLock):
    """Order-tracking proxy around ``threading.RLock``. Exposes the
    private ``Condition`` protocol (``_release_save`` etc.) by
    delegation: ``Condition.wait`` releases/reacquires the INNER lock
    directly, which is bookkeeping-safe — the waiting thread is blocked
    for exactly the window in which our held-stack is stale, so it can
    acquire nothing and no false edges form."""

    __slots__ = ()
    _reentrant = True

    def __init__(self, name: str, san: "RuntimeSanitizer"):
        self._inner = threading.RLock()
        self.name = name
        self._san = san

    # Condition protocol ------------------------------------------------
    def _release_save(self):
        return self._inner._release_save()

    def _acquire_restore(self, state):
        self._inner._acquire_restore(state)

    def _is_owned(self):
        return self._inner._is_owned()


class _ThreadState(threading.local):
    """Per-thread sanitizer state: held-lock stack, an edge cache so the
    steady state never touches the global graph lock, and the lane
    context published by ``Lane._run_job``."""

    def __init__(self):
        self.held: List[_TrackedLock] = []
        self.edge_cache: Set[Tuple[str, str]] = set()
        self.lane: Optional[Tuple[str, str, bool]] = None  # (name, kind, ok)


# ---------------------------------------------------------------------------
# RuntimeSanitizer
# ---------------------------------------------------------------------------

class RuntimeSanitizer:
    """One analysis domain: a may-precede lock graph, a lane-discipline
    event trace, and counters. Usable standalone in tests; the
    process-global instance is managed by ``install()``."""

    def __init__(self, block_threshold_s: float = 0.010):
        self.block_threshold_s = block_threshold_s
        self._glock = threading.Lock()          # guards graph + events
        # (held_name, acquired_name) -> thread name of first observation
        self._edges: Dict[Tuple[str, str], str] = {}
        self._lane_events: List[Dict[str, Any]] = []
        self._lane_event_count = 0
        self._waitgraph_probes = 0
        self._gauge_leaks = 0
        self._local = _ThreadState()

    # -- lock factories -------------------------------------------------
    def tracked_lock(self, name: str) -> _TrackedLock:
        return _TrackedLock(name, self)

    def tracked_rlock(self, name: str) -> _TrackedRLock:
        return _TrackedRLock(name, self)

    # lock bookkeeping lives inlined in _TrackedLock.acquire/release —
    # it is the sanitize-on hot path and must stay call-free

    # -- lane discipline ------------------------------------------------
    def enter_lane(self, name: str, kind: str):
        st = self._local
        prev = st.lane
        st.lane = (name, kind, kind in LANE_BLOCKING_OK)
        return prev

    def exit_lane(self, prev) -> None:
        self._local.lane = prev

    def current_lane(self) -> Optional[Tuple[str, str, bool]]:
        return self._local.lane

    def _note_blocking(self, op: str, waited_s: float, detail: str) -> None:
        lane = self._local.lane
        if lane is None or lane[2]:
            return                       # not on a lane / blocking allowed
        with self._glock:
            self._lane_event_count += 1
            self._lane_events.append({
                "lane": lane[0], "kind": lane[1], "op": op,
                "waited_s": waited_s, "detail": detail})
            del self._lane_events[:-_MAX_EVENTS]

    def note_future_wait(self, waited_s: float) -> None:
        """An ``HFuture.get`` that found the event unset and actually
        entered the wait path (any duration: a near-resolved future
        could just as well have waited forever)."""
        self._note_blocking("future-wait", waited_s, "HFuture.get")

    def note_sleep(self, duration_s: float, where: str = "sleep") -> None:
        self._note_blocking("sleep", duration_s, where)

    # -- analyses -------------------------------------------------------
    def lock_order_edges(self) -> Dict[Tuple[str, str], str]:
        with self._glock:
            return dict(self._edges)

    def lock_order_cycles(self) -> List[List[str]]:
        """Cycles in the may-precede graph: each is a name path
        ``[A, B, ..., A]`` meaning some thread acquires B under A while
        another acquires A under (eventually) B — a potential deadlock
        even if this run never interleaved into the hang."""
        with self._glock:
            adj: Dict[str, List[str]] = {}
            for a, b in self._edges:
                adj.setdefault(a, []).append(b)
        return _find_cycles(adj)

    def check_lock_order(self) -> None:
        cycles = self.lock_order_cycles()
        if cycles:
            edges = self.lock_order_edges()
            cyc = cycles[0]
            samples = [
                f"{a}->{b} (first seen on thread "
                f"{edges.get((a, b), '?')})"
                for a, b in zip(cyc, cyc[1:], strict=False)]
            raise SanitizerError(
                "potential deadlock: lock-order cycle "
                + " -> ".join(cyc) + "; " + "; ".join(samples))

    def lane_blocking_report(self) -> List[Dict[str, Any]]:
        with self._glock:
            return [dict(e) for e in self._lane_events]

    # -- counters -------------------------------------------------------
    def note_waitgraph_probe(self) -> None:
        with self._glock:
            self._waitgraph_probes += 1

    def note_gauge_leaks(self, n: int) -> None:
        with self._glock:
            self._gauge_leaks += n

    def stats_snapshot(self) -> Dict[str, int]:
        cycles = len(self.lock_order_cycles())
        with self._glock:
            return {
                "lock_order_edges": len(self._edges),
                "potential_deadlocks": cycles,
                "lane_blocking_events": self._lane_event_count,
                "waitgraph_probes": self._waitgraph_probes,
                "gauge_leaks": self._gauge_leaks,
            }


def _find_cycles(adj: Dict[str, List[str]]) -> List[List[str]]:
    """Simple cycles via DFS with an on-stack set; one representative
    per distinct cycle head. Graphs here are tiny (tens of names)."""
    cycles: List[List[str]] = []
    seen_heads: Set[str] = set()
    for start in sorted(adj):
        stack: List[Tuple[str, int]] = [(start, 0)]
        path = [start]
        on_path = {start}
        while stack:
            node, idx = stack[-1]
            succs = adj.get(node, ())
            if idx < len(succs):
                stack[-1] = (node, idx + 1)
                nxt = succs[idx]
                if nxt == start and len(path) > 1:
                    head = min(path)
                    if head not in seen_heads:
                        seen_heads.add(head)
                        k = path.index(head)
                        cycles.append(path[k:] + path[:k] + [head])
                elif nxt not in on_path and nxt > start:
                    # only explore nodes > start: each cycle is found
                    # from its smallest member exactly once
                    stack.append((nxt, 0))
                    path.append(nxt)
                    on_path.add(nxt)
            else:
                stack.pop()
                on_path.discard(path.pop())
    return cycles


# ---------------------------------------------------------------------------
# process-global install + factories
# ---------------------------------------------------------------------------

_SAN: Optional[RuntimeSanitizer] = None
_install_lock = threading.Lock()


def install(block_threshold_s: Optional[float] = None) -> RuntimeSanitizer:
    """Install (or return) the process-global sanitizer. Idempotent:
    lock identity must be stable across every Runtime/Rank in the
    process, so the first install wins."""
    global _SAN
    with _install_lock:
        if _SAN is None:
            _SAN = RuntimeSanitizer(
                block_threshold_s if block_threshold_s is not None
                else 0.010)
        elif block_threshold_s is not None:
            _SAN.block_threshold_s = min(_SAN.block_threshold_s,
                                         block_threshold_s)
        return _SAN


def uninstall() -> None:
    """Tests only: drop the global sanitizer. Locks already created stay
    tracked against the old instance (harmless); new ones are plain."""
    global _SAN
    with _install_lock:
        _SAN = None


def current() -> Optional[RuntimeSanitizer]:
    return _SAN


def make_lock(name: str):
    """Runtime lock factory: a plain ``threading.Lock`` when the
    sanitizer is off (zero overhead), an order-tracking proxy when on.
    ``name`` is the lock CLASS for the may-precede graph (one name per
    role, e.g. ``"HeteroObject.lock"`` for every object's lock)."""
    san = _SAN
    if san is None:
        return threading.Lock()
    return _TrackedLock(name, san)


def make_rlock(name: str):
    san = _SAN
    if san is None:
        return threading.RLock()
    return _TrackedRLock(name, san)


def make_condition(lock):
    """Condition over a factory-made lock. For a tracked proxy the
    Condition wraps the INNER primitive: every runtime call site
    acquires the lock itself (``with self._lock:``) before wait/notify,
    so mutual exclusion still flows through the tracked proxy and keeps
    its may-precede edges — while ``Condition``'s internals
    (``_is_owned`` on every wait/notify, ``_release_save`` /
    ``_acquire_restore`` around every wait) run on the raw lock at zero
    sanitizer cost. The held-stack is stale for exactly the window the
    waiting thread is blocked, so no false edges can form."""
    inner = getattr(lock, "_inner", None)
    return threading.Condition(inner if inner is not None else lock)


# ---------------------------------------------------------------------------
# distributed wait-for graph
# ---------------------------------------------------------------------------

class WaitGraph:
    """Rank-level wait-for graph. Nodes are rank ids; each edge carries
    the stream (msg) id it stems from and a human-readable reason."""

    def __init__(self):
        self.edges: List[Tuple[int, int, Any, str]] = []

    def add(self, src: int, dst: int, stream: Any, reason: str) -> None:
        if src != dst:
            self.edges.append((src, dst, stream, reason))

    def find_cycle(self) -> Optional[List[Tuple[int, int, Any, str]]]:
        """A cycle whose edges span >= 2 distinct streams (the two
        halves of one healthy in-flight stream form a trivial 2-cycle
        that must not be reported). Returns the edge list of the cycle,
        or None."""
        adj: Dict[int, List[Tuple[int, int, Any, str]]] = {}
        for e in self.edges:
            adj.setdefault(e[0], []).append(e)
        for start in sorted(adj):
            found = self._cycle_from(start, adj)
            if found is not None:
                return found
        return None

    def _cycle_from(self, start, adj):
        # DFS over edges, tracking the path; accept the first cycle back
        # to `start` with >= 2 distinct stream ids
        stack = [(start, iter(adj.get(start, ())))]
        path_edges: List[Tuple[int, int, Any, str]] = []
        on_path = {start}
        while stack:
            node, it = stack[-1]
            edge = next(it, None)
            if edge is None:
                stack.pop()
                if path_edges:
                    on_path.discard(path_edges.pop()[1])
                continue
            _, dst, _, _ = edge
            if dst == start:
                cyc = path_edges + [edge]
                if len({e[2] for e in cyc}) >= 2:
                    return cyc
            elif dst not in on_path:
                on_path.add(dst)
                path_edges.append(edge)
                stack.append((dst, iter(adj.get(dst, ()))))
        return None


def build_wait_graph(cluster) -> WaitGraph:
    """Snapshot the live protocol state of every (alive) rank into a
    wait-for graph. Reads are unlocked dict snapshots — entries may
    race away mid-walk; this is a diagnostic, not a barrier."""
    g = WaitGraph()
    faults = getattr(cluster, "faults", None)
    dead = set(getattr(faults, "dead", ()) or ()) if faults else set()
    for r in cluster.ranks:
        if r.rank in dead:
            continue
        for mid, st in list(r._rdzv_out.items()):
            meta = st.get("meta")
            if meta is None:
                continue
            sent, total = st.get("next_seq", 0), meta.nchunks
            if sent < total and st.get("credits", 0) <= 0:
                g.add(r.rank, meta.dst, mid,
                      f"stream {mid}: sent {sent}/{total} chunks, window "
                      f"stalled awaiting credits from rank {meta.dst}")
        for mid, st in list(r._rdzv_in.items()):
            meta = st.get("meta")
            if meta is None:
                continue
            arrived, total = st.get("arrived", 0), meta.nchunks
            if arrived < total:
                g.add(r.rank, meta.src, mid,
                      f"stream {mid}: {arrived}/{total} chunks arrived "
                      f"from rank {meta.src}")
        with r._unacked_lock:
            unacked = [(mid, st.get("dst"), st.get("attempts", 0))
                       for mid, st in r._unacked.items()]
        for mid, dst, attempts in unacked:
            if dst is not None:
                g.add(r.rank, dst, mid,
                      f"msg {mid}: unacked after {attempts} retries")
        for mid, st in list(r._rdzv_sent.items()):
            dst = st.get("dst")
            if dst is not None:
                g.add(r.rank, dst, mid,
                      f"stream {mid}: tail awaiting completion ack "
                      f"from rank {dst}")
        for mid, msg in list(r._pending_meta.items()):
            g.add(r.rank, msg.src, mid,
                  f"msg {mid}: meta without payload half from "
                  f"rank {msg.src}")
    # pending collective ops: every member of an unfinished op is waiting
    # on its ring neighbour. All hops of one op share a stream id, so a
    # healthy in-flight collective never forms a reportable cycle alone.
    for grp in list(getattr(cluster, "_coll_groups", {}).values()):
        with grp._lock:
            pending = [(tag, op["kind"]) for tag, op in grp._ops.items()
                       if not op["done"].is_set()]
        ring = grp.ring_m
        for tag, kind in pending:
            for i, m in enumerate(ring):
                nxt = ring[(i + 1) % len(ring)]
                if m not in dead and nxt not in dead:
                    g.add(m, nxt, f"coll-{grp.gid}-{tag}",
                          f"collective {kind} tag {tag} pending")
    return g


def waitgraph_verdict(cluster) -> str:
    """One-line root cause for a stuck (or slow) cluster: the named
    deadlock cycle if the wait-for graph has one, else the slowest lane
    by backlog, else "all quiet"."""
    san = _SAN
    if san is not None:
        san.note_waitgraph_probe()
    g = build_wait_graph(cluster)
    cyc = g.find_cycle()
    if cyc is not None:
        hops = " -> ".join(
            f"rank {src} -[{reason}]-> rank {dst}"
            for src, dst, _stream, reason in cyc)
        return f"potential deadlock cycle: {hops}"
    # no cycle: name the slowest lane so a timeout still has a suspect
    worst_name, worst_depth = None, 0
    engines = [("net", getattr(cluster, "net", None))]
    engines += [(f"rank{r.rank}", r.runtime.engine) for r in cluster.ranks]
    for tag, eng in engines:
        if eng is None:
            continue
        for lane, depth in eng.backlogs().items():
            if depth > worst_depth:
                worst_name, worst_depth = f"{tag}:{lane}", depth
    if worst_name is not None:
        return f"no cycle: slowest lane {worst_name} (backlog {worst_depth})"
    return "no cycle: all lanes idle"


# ---------------------------------------------------------------------------
# gauge hygiene
# ---------------------------------------------------------------------------

def gauge_leak_report(rank) -> Optional[str]:
    """Nonzero leak gauges on a rank at shutdown, with the owning
    streams/peers named. Returns None when everything drained."""
    gauges = rank.state_gauges()
    bad = {k: gauges.get(k, 0) for k in _LEAK_GAUGES if gauges.get(k, 0)}
    if not bad:
        return None
    owners: List[str] = []
    for mid, st in list(rank._rdzv_out.items())[:4]:
        meta = st.get("meta")
        if meta is not None:
            owners.append(f"rdzv_out stream {mid} -> rank {meta.dst}")
    for mid, st in list(rank._rdzv_in.items())[:4]:
        meta = st.get("meta")
        if meta is not None:
            owners.append(f"rdzv_in stream {mid} <- rank {meta.src}")
    for mid, (peer, _buf) in list(rank._rdzv_bufs.items())[:4]:
        owners.append(f"rdzv_buf stream {mid} (peer rank {peer})")
    with rank._unacked_lock:
        unacked = list(rank._unacked.items())[:4]
    for mid, st in unacked:
        owners.append(f"unacked msg {mid} -> rank {st.get('dst')}")
    for mid, msg in list(rank._pending_meta.items())[:4]:
        owners.append(f"pending meta {mid} <- rank {msg.src}")
    for mid, st in list(rank._rdzv_sent.items())[:4]:
        owners.append(f"rdzv tail {mid} -> rank {st.get('dst')}")
    return (f"rank {rank.rank} leaked protocol state at shutdown: "
            f"{bad}; owners: {'; '.join(owners) or 'unknown'}")
