"""Runtime collectives over rendezvous streams (paper §4.2;
``repro/distributed/collectives_rt.py`` at the same path).

The paper's distributed claim — pipelined chunk streaming beating
monolithic transfers on large messages while small-message overhead
stays under 10% — is a point-to-point property. ``CollectiveGroup``
extends it to multi-party reductions by COMPOSING the existing
machinery instead of bypassing it:

* **Large payloads** (above ``RuntimeConfig.coll_ring_cutover_bytes``)
  run as pipelined chunked rings: a reduce-scatter phase of chained
  ``Rank.reduce_into`` rendezvous streams (each hop's per-chunk adds are
  fused on the consumer device's transfer lane, so chunk k+1's network
  receive overlaps chunk k's reduction) followed by an allgather phase
  of chained ``Rank.put`` streams. With R parties each of the R segment
  chains runs concurrently at a different ring offset, so every link
  carries traffic the whole time — the classic bandwidth-optimal ring,
  built from credit-windowed streams.
* **Small payloads** run as eager binomial trees (latency-bound regime):
  contributions combine up the tree, the result fans back down.
* **Topology**: the ring neighbor order and tree shape come from the
  ``InterconnectModel`` EWMA link estimates (``ring_order`` /
  ``tree_order``), hierarchically — members sharing a node first chain-
  reduce onto one leader per node, only leaders run the inter-node ring,
  then leaders fan the result back out. Shapes are FROZEN at group
  creation: a drifting estimate must not re-order reductions between two
  identical calls.
* **Determinism**: every reduction order is fixed by the schedule, never
  by arrival order — tree combines wait for ALL children and fold them
  in ascending position order; ring chains are sequenced hop-by-hop by
  completion handlers. ``oracle_allreduce`` replays the exact schedule
  single-threaded in numpy; results are bitwise-identical to it.
* **Elasticity**: ops are tag-scoped and epoch-stamped. The caller polls
  ``epoch_fn`` while waiting; an ``ElasticRuntime`` epoch bump
  mid-collective aborts cleanly (``CollectiveAborted``, accumulator keys
  unregistered so straggling streams land in the void, per-rank
  ``coll_aborts`` counted) and the caller re-runs after recovery.

Hop sequencing is continuation-driven: each hop's ``on_done`` handler
fires on the RECEIVING rank and issues the next hop from there — no
caller round-trips mid-chain, and since every chain is a linear sequence
of independent streams there is no waits-for cycle to deadlock under the
AIMD credit controller.

Inputs are numpy arrays or torch tensors. A tensor on a card stays there:
its ring segments and accumulators are objects on that member's device, so
every hop's add is the ``add_`` that ``Rank.reduce_into`` issues on the
consumer's transfer stream. The tree arm combines on the host in numpy,
and results are numpy arrays, as in the JAX package.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.convert import to_numpy, torch_dtype
from repro_torch.core import sanitizer
from repro_torch.core.device_api import TorchDevice
from repro_torch.distributed.handlers import handler

__all__ = ["CollectiveGroup", "CollectiveAborted"]


class CollectiveAborted(RuntimeError):
    """An in-flight collective was aborted by an elastic epoch bump; the
    caller re-runs it (same group, fresh tag) after recovery."""


def _segment_bounds(n: int, parts: int) -> List[tuple]:
    """Contiguous near-equal split of ``n`` elements (uneven-friendly:
    the same convention jacobi uses for slab bounds)."""
    return [(p * n // parts, (p + 1) * n // parts) for p in range(parts)]


def _tree_parent(p: int) -> int:
    """Binomial-tree parent of position ``p`` (> 0): clear the lowest
    set bit — the standard MPI binomial shape."""
    return p & (p - 1)


def _tree_children(p: int, size: int) -> List[int]:
    """Binomial-tree children of position ``p`` in a ``size``-wide tree,
    ascending. Position 0 fans to 1, 2, 4, …; an internal position p
    fans to p+1, p+2, … below its own lowest set bit."""
    out, bit = [], 1
    lim = (p & -p) if p else size
    while bit < lim:
        c = p + bit
        if c < size:
            out.append(c)
        bit <<= 1
    return out


def _as_input(x: Any) -> Any:
    """A member's contribution: a tensor on a card as itself (no host round
    trip), anything else as a numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.contiguous() if x.device.type == "cuda" else to_numpy(x)
    return np.asarray(x)


def _host(x: Any) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else x


def _zeros_like(x: Any, n: int) -> Any:
    if isinstance(x, torch.Tensor):
        return torch.zeros(n, dtype=x.dtype, device=x.device)
    return np.zeros(n, x.dtype)


def _new_object(rank, x: Any):
    """A private hetero_object of ``x`` on ``rank``: on the host for a numpy
    array, on the runtime's device that holds a card tensor."""
    rt = rank.runtime
    if not isinstance(x, torch.Tensor):
        return rt.hetero_object(np.array(x))
    dev = next((i for i, d in enumerate(rt.devices)
                if isinstance(d, TorchDevice) and d.torch_device == x.device),
               None)
    if dev is None:
        raise ValueError(f"rank {rank.rank}'s runtime has no device "
                         f"{x.device}")
    copy = x.clone()
    # the messaging layer reads it on the device's own streams
    torch.cuda.current_stream(x.device).synchronize()
    return rt.adopt_device_array(copy, dev)


def _host_value(obj) -> np.ndarray:
    """Private host copy of a hetero_object's current value."""
    fut = obj.request_host(write=False)
    arr = np.array(fut.get())
    obj.release()
    return arr


def _engine_for(ctx, user) -> Optional["CollectiveGroup"]:
    reg = getattr(ctx.rank.cluster, "_coll_groups", None)
    if reg is None or not user:
        return None
    return reg.get(user.get("gid"))


@handler(name="coll_hop")
def _coll_hop(ctx, obj):
    """Completion continuation of one ring/chain hop (``on_done`` of a
    collective put / reduce_into): runs on the receiving rank, hands the
    hop back to the group engine, which issues the next hop from here."""
    eng = _engine_for(ctx, ctx.user)
    if eng is not None:
        eng._on_hop(ctx.rank, ctx.user)


@handler(name="coll_tree_up")
def _coll_tree_up(ctx, obj):
    """One child's contribution arriving at its binomial-tree parent."""
    eng = _engine_for(ctx, ctx.user)
    if eng is not None:
        eng._on_tree_up(ctx.rank, ctx.user, obj)


@handler(name="coll_tree_down")
def _coll_tree_down(ctx, obj):
    """Reduced result fanning back down the binomial tree."""
    eng = _engine_for(ctx, ctx.user)
    if eng is not None:
        eng._on_tree_down(ctx.rank, ctx.user, obj)


class CollectiveGroup:
    """Collective communicator over a set of cluster ranks.

    ``members`` — participating rank ids (default: all ranks).
    ``nodes`` — optional ``{rank: node_id}`` placement; members sharing a
    node reduce locally onto one leader before the inter-node ring.
    ``epoch_fn`` — elastic epoch source (e.g. ``lambda: elastic.epoch``);
    a bump observed mid-collective raises ``CollectiveAborted``.

    All ops take one caller-side array per member (aligned with
    ``group.members``) and return one result per member; ``reduce``
    returns the result only at ``root`` (None elsewhere)."""

    def __init__(self, cluster, members: Optional[Sequence[int]] = None,
                 nodes: Optional[Dict[int, Any]] = None,
                 epoch_fn=None, timeout_s: float = 120.0):
        self.cluster = cluster
        self.members: List[int] = sorted(
            members if members is not None else range(len(cluster.ranks)))
        if not self.members:
            raise ValueError("collective group needs at least one member")
        self.nodes = {m: (nodes.get(m, m) if nodes else m)
                      for m in self.members}
        self.epoch_fn = epoch_fn if epoch_fn is not None else (lambda: 0)
        self.timeout_s = timeout_s
        cfg = cluster.ranks[self.members[0]].runtime.cfg
        self.cutover_bytes = cfg.coll_ring_cutover_bytes
        self.tag_space = cfg.coll_tag_space
        by_node: Dict[Any, List[int]] = {}
        for m in self.members:
            by_node.setdefault(self.nodes[m], []).append(m)
        # leader = smallest member of each node (deterministic)
        self._node_members = {k: sorted(v) for k, v in by_node.items()}
        self.leaders = sorted(v[0] for v in self._node_members.values())
        # ring/tree shapes FROZEN at group creation from the current EWMA
        # table (see module docstring: determinism beats freshness here)
        self.ring: List[int] = cluster.topology.ring_order(self.leaders)
        self.ring_m: List[int] = cluster.topology.ring_order(self.members)
        self._tree_cache: Dict[int, List[int]] = {}
        self._tag_counter = itertools.count()
        self._lock = sanitizer.make_lock("CollectiveGroup._lock")
        self._ops: Dict[int, Dict[str, Any]] = {}
        reg = getattr(cluster, "_coll_groups", None)
        if reg is None:
            reg = cluster._coll_groups = {}
        self.gid = len(reg)
        reg[self.gid] = self

    # -- plumbing ------------------------------------------------------
    def _tree(self, root: int) -> List[int]:
        order = self._tree_cache.get(root)
        if order is None:
            order = self.cluster.topology.tree_order(root, self.members)
            self._tree_cache[root] = order
        return order

    def _new_op(self, kind: str) -> Dict[str, Any]:
        with self._lock:
            tag = next(self._tag_counter) % self.tag_space
            if tag in self._ops:
                raise RuntimeError(
                    f"collective tag space exhausted: {len(self._ops)} "
                    f"ops in flight with coll_tag_space={self.tag_space}")
            op = {"tag": tag, "kind": kind, "epoch": self.epoch_fn(),
                  "done": threading.Event(), "err": None, "aborted": False,
                  "lock": sanitizer.make_lock("CollectiveGroup.op_lock"),
                  "keys": {m: [] for m in self.members}}
            self._ops[tag] = op
        return op

    def _op_for(self, user) -> Optional[Dict[str, Any]]:
        """Resolve a handler invocation to its live op — stale tags (op
        finished/aborted) and stale epochs drop silently."""
        if not user:
            return None
        with self._lock:
            op = self._ops.get(user.get("tag"))
        if op is None or op["aborted"] or op["epoch"] != user.get("e"):
            return None
        return op

    def _user(self, op: Dict[str, Any], ph: str, **kw) -> Dict[str, Any]:
        u = {"gid": self.gid, "tag": op["tag"], "e": op["epoch"], "ph": ph}
        u.update(kw)
        return u

    def _key(self, op: Dict[str, Any], sfx: Any):
        return ("coll", self.gid, op["tag"], sfx)

    def _register(self, op: Dict[str, Any], member: int, sfx: Any,
                  arr: np.ndarray) -> None:
        rank = self.cluster.ranks[member]
        key = self._key(op, sfx)
        rank.register_object(key, _new_object(rank, arr))
        op["keys"][member].append(key)

    def _obj(self, member: int, op: Dict[str, Any], sfx: Any):
        return self.cluster.ranks[member].objects[self._key(op, sfx)]

    def _cleanup(self, op: Dict[str, Any]) -> None:
        for m, keys in op["keys"].items():
            rank = self.cluster.ranks[m]
            for key in keys:
                rank.objects.pop(key, None)
        with self._lock:
            self._ops.pop(op["tag"], None)

    def _abort(self, op: Dict[str, Any]) -> None:
        """Epoch bump / timeout mid-collective: mark the op dead so late
        handler continuations drop, unregister every accumulator key so
        straggling streams land in the void (the messaging layer no-ops
        a put/reduce against an unregistered key), and count the abort
        on every member."""
        with op["lock"]:
            op["aborted"] = True
        self._cleanup(op)
        for m in self.members:
            self.cluster.ranks[m].stats["coll_aborts"] += 1

    def _fail(self, op: Dict[str, Any], exc: BaseException) -> None:
        op["err"] = exc
        op["done"].set()

    def _await(self, op: Dict[str, Any]) -> None:
        deadline = time.perf_counter() + self.timeout_s
        try:
            while not op["done"].wait(0.005):
                if self.epoch_fn() != op["epoch"]:
                    raise CollectiveAborted(
                        f"{op['kind']} (tag {op['tag']}) aborted: epoch "
                        f"moved {op['epoch']} -> {self.epoch_fn()} "
                        "mid-collective")
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"collective {op['kind']} (tag {op['tag']}) did "
                        f"not complete within {self.timeout_s:.0f}s")
        except (CollectiveAborted, TimeoutError):
            self._abort(op)
            raise
        if op["err"] is not None:
            err, op["err"] = op["err"], None
            self._cleanup(op)
            raise RuntimeError(
                f"collective {op['kind']} (tag {op['tag']}) failed") \
                from err

    def _check_inputs(self, inputs: Sequence[Any], host: bool = False
                      ) -> List[Any]:
        """One array per member, numpy or (unless ``host``) a card tensor,
        all of one shape and dtype."""
        if len(inputs) != len(self.members):
            raise ValueError(
                f"expected {len(self.members)} inputs (one per member "
                f"{self.members}), got {len(inputs)}")
        arrs = [_as_input(x) for x in inputs]
        if host:
            arrs = [_host(a) for a in arrs]
        s0, d0 = tuple(arrs[0].shape), torch_dtype(arrs[0].dtype)
        for a in arrs[1:]:
            if tuple(a.shape) != s0 or torch_dtype(a.dtype) != d0:
                raise ValueError(
                    f"collective inputs must agree on shape/dtype: "
                    f"{(s0, d0)} vs {(a.shape, a.dtype)}")
        return arrs

    # -- handler continuations -----------------------------------------
    def _on_hop(self, rank, user) -> None:
        op = self._op_for(user)
        if op is None:
            return
        try:
            ph = user["ph"]
            if ph == "intra":
                self._intra_done(op, user)
            elif ph == "rs":
                self._rs_done(op, user)
            elif ph == "ag":
                self._ag_done(op, user)
            elif ph == "chain":
                self._chain_done(op, user)
            else:                      # "bcast" | "gather": count-only
                self._count_done(op)
        except BaseException as e:     # surface on the caller, not pump
            self._fail(op, e)

    def _count_done(self, op: Dict[str, Any], ring_part: bool = False
                    ) -> None:
        st = op["ring_st"]
        with op["lock"]:
            st["left"] -= 1
            left = st["left"]
            if ring_part:
                st["ring_left"] -= 1
                ring_left = st["ring_left"]
            else:
                ring_left = None
        if ring_left == 0 and st.get("bcast", False):
            self._start_bcast(op)
        if left == 0:
            op["done"].set()

    # intra-node chain: members of one node fold into the leader, one
    # segment chain at a time, ascending member order (deterministic)
    def _issue_intra(self, op: Dict[str, Any], node: Any, g: int) -> None:
        st = op["ring_st"]
        mems = self._node_members[node]
        m = mems[st["intra_cursor"][(node, g)]]
        self.cluster.ranks[m].reduce_into(
            mems[0], self._key(op, g), st["src"][(m, g)],
            on_done="coll_hop",
            user=self._user(op, "intra", node=node, seg=g))

    def _intra_done(self, op: Dict[str, Any], user) -> None:
        st = op["ring_st"]
        node, g = user["node"], user["seg"]
        mems = self._node_members[node]
        with op["lock"]:
            st["intra_cursor"][(node, g)] += 1
            nxt = st["intra_cursor"][(node, g)]
            st["intra_left"] -= 1
            st["left"] -= 1
            barrier_clear = st["intra_left"] == 0
            left = st["left"]
        if nxt < len(mems):
            self._issue_intra(op, node, g)
        if barrier_clear:
            # ring hops must not land on a leader whose intra chain is
            # still folding (the add order would depend on arrival):
            # the ring phase starts only once EVERY node's chains are in
            if st["ring_left"]:
                self._start_ring(op)
            elif st.get("bcast", False):
                self._start_bcast(op)
        if left == 0:
            op["done"].set()

    # ring reduce-scatter: segment g's chain starts at position g+1 and
    # closes at position g, which then owns the fully reduced segment
    def _issue_rs(self, op: Dict[str, Any], g: int, h: int) -> None:
        st = op["ring_st"]
        ring = st["ring"]
        R = len(ring)
        sp, rp = ring[(g + 1 + h) % R], ring[(g + 2 + h) % R]
        self.cluster.ranks[sp].reduce_into(
            rp, self._key(op, g), self._obj(sp, op, g),
            on_done="coll_hop", user=self._user(op, "rs", seg=g, h=h))

    def _start_ring(self, op: Dict[str, Any]) -> None:
        for g in range(len(op["ring_st"]["bounds"])):
            self._issue_rs(op, g, 0)

    def _rs_done(self, op: Dict[str, Any], user) -> None:
        st = op["ring_st"]
        R = len(st["ring"])
        g, h = user["seg"], user["h"]
        if h < R - 2:
            self._issue_rs(op, g, h + 1)
        else:
            kind = op["kind"]
            if kind == "ring_allreduce":
                self._issue_ag(op, g, 0)   # seg g final here: gather it
            elif kind == "ring_reduce":
                root = st["root"]
                if st["ring"][g] != root:
                    self.cluster.ranks[st["ring"][g]].put(
                        root, self._key(op, g),
                        self._obj(st["ring"][g], op, g),
                        on_done="coll_hop",
                        user=self._user(op, "gather", seg=g))
        self._count_done(op, ring_part=True)

    # ring allgather: position g's final segment travels g→g+1→…,
    # overwriting (put) every accumulator it passes through
    def _issue_ag(self, op: Dict[str, Any], g: int, h: int) -> None:
        st = op["ring_st"]
        ring = st["ring"]
        R = len(ring)
        sp, rp = ring[(g + h) % R], ring[(g + 1 + h) % R]
        self.cluster.ranks[sp].put(
            rp, self._key(op, g), self._obj(sp, op, g),
            on_done="coll_hop", user=self._user(op, "ag", seg=g, h=h))

    def _ag_done(self, op: Dict[str, Any], user) -> None:
        R = len(op["ring_st"]["ring"])
        g, h = user["seg"], user["h"]
        if h < R - 2:
            self._issue_ag(op, g, h + 1)
        self._count_done(op, ring_part=True)

    # put chains for broadcast/allgather: block b originates at ring
    # position start and travels R-1 hops around
    def _issue_chain(self, op: Dict[str, Any], b: int, h: int) -> None:
        st = op["ring_st"]
        ring = st["ring"]
        R = len(ring)
        blk = st["blocks"][b]
        sp = ring[(blk["start"] + h) % R]
        rp = ring[(blk["start"] + h + 1) % R]
        self.cluster.ranks[sp].put(
            rp, self._key(op, blk["sfx"]), self._obj(sp, op, blk["sfx"]),
            on_done="coll_hop", user=self._user(op, "chain", b=b, h=h))

    def _chain_done(self, op: Dict[str, Any], user) -> None:
        R = len(op["ring_st"]["ring"])
        b, h = user["b"], user["h"]
        if h < R - 2:
            self._issue_chain(op, b, h + 1)
        self._count_done(op)

    # leaders fan the finished vector out to their node's members
    def _start_bcast(self, op: Dict[str, Any]) -> None:
        st = op["ring_st"]
        nseg = len(st["bounds"])
        for mems in self._node_members.values():
            leader = mems[0]
            for m in mems[1:]:
                for g in range(nseg):
                    self.cluster.ranks[leader].put(
                        m, self._key(op, g), self._obj(leader, op, g),
                        on_done="coll_hop",
                        user=self._user(op, "bcast", seg=g))

    # -- binomial tree (small-payload path) ----------------------------
    def _send_up(self, op: Dict[str, Any], p: int,
                 acc: Optional[np.ndarray] = None) -> None:
        st = op["tree"]
        order = st["order"]
        arr = st["local"][p] if acc is None else acc
        rank = self.cluster.ranks[order[p]]
        rank.send(order[_tree_parent(p)], "coll_tree_up",
                  rank.runtime.hetero_object(arr),
                  user=self._user(op, "up", cpos=p, pos=_tree_parent(p)))

    def _on_tree_up(self, rank, user, obj) -> None:
        op = self._op_for(user)
        if op is None:
            return
        try:
            arr = _host_value(obj)
            st = op["tree"]
            p = user["pos"]
            with op["lock"]:
                st["contrib"][p][user["cpos"]] = arr
                ready = len(st["contrib"][p]) == st["need"][p]
            if not ready:
                return
            # deterministic combine: local value first, then children in
            # ascending position order — arrival order is irrelevant
            acc = st["local"][p]
            for c in sorted(st["contrib"][p]):
                acc = acc + st["contrib"][p][c]
                rank.stats["coll_bytes_reduced"] += int(arr.nbytes)
            if p == 0:
                st["res"][0] = acc
                if st["down_left"] == 0:
                    op["done"].set()
                else:
                    self._send_down(op, 0, acc)
            else:
                self._send_up(op, p, acc)
        except BaseException as e:
            self._fail(op, e)

    def _send_down(self, op: Dict[str, Any], p: int,
                   arr: np.ndarray) -> None:
        st = op["tree"]
        order = st["order"]
        rank = self.cluster.ranks[order[p]]
        for c in _tree_children(p, len(order)):
            rank.send(order[c], "coll_tree_down",
                      rank.runtime.hetero_object(arr),
                      user=self._user(op, "down", pos=c))

    def _on_tree_down(self, rank, user, obj) -> None:
        op = self._op_for(user)
        if op is None:
            return
        try:
            arr = _host_value(obj)
            st = op["tree"]
            p = user["pos"]
            self._send_down(op, p, arr)
            with op["lock"]:
                st["res"][p] = arr
                st["down_left"] -= 1
                last = st["down_left"] == 0
            if last:
                op["done"].set()
        except BaseException as e:
            self._fail(op, e)

    def _run_tree(self, arrs: List[np.ndarray], root: int,
                  kind: str, down: bool,
                  seed: Optional[np.ndarray] = None) -> Dict[int, Any]:
        """Shared binomial-tree engine. ``down=False`` reduces to the
        root only; ``seed`` (broadcast) skips the up phase entirely and
        fans ``seed`` down from the root. Returns ``{position: array}``."""
        order = self._tree(root)
        R = len(order)
        op = self._new_op(kind)
        idx = {m: i for i, m in enumerate(self.members)}
        st = {
            "order": order,
            "local": {p: arrs[idx[order[p]]] for p in range(R)}
            if arrs else {},
            "contrib": {p: {} for p in range(R)},
            "need": {p: len(_tree_children(p, R)) for p in range(R)},
            "res": {},
            "down_left": (R - 1) if down else 0,
        }
        op["tree"] = st
        if seed is not None:
            st["res"][0] = seed
            self._send_down(op, 0, seed)
        else:
            for p in range(1, R):
                if st["need"][p] == 0:
                    self._send_up(op, p)
            if st["need"][0] == 0:     # degenerate: can't happen, R >= 2
                st["res"][0] = st["local"][0]
                op["done"].set()
        self._await(op)
        res = dict(st["res"])
        self._cleanup(op)
        return {order[p]: v for p, v in res.items()}

    # -- public ops ----------------------------------------------------
    def allreduce(self, inputs: Sequence[Any],
                  average: bool = False) -> List[np.ndarray]:
        """Every member contributes one array, every member receives the
        (identically grouped, bit-deterministic) sum — binomial tree at
        or below the cutover, hierarchical pipelined ring above it.
        ``average=True`` divides the result by the member count
        (caller-side, after the deterministic sum)."""
        arrs = self._check_inputs(inputs)
        shape = tuple(arrs[0].shape)
        n = len(self.members)
        if n == 1:
            outs = [np.array(_host(arrs[0]))]
        elif arrs[0].nbytes <= self.cutover_bytes:
            by_member = self._run_tree([_host(a) for a in arrs],
                                       self.members[0],
                                       "tree_allreduce", down=True)
            outs = [by_member[m] for m in self.members]
        else:
            outs = self._ring_allreduce(arrs)
        outs = [o.reshape(shape) for o in outs]
        if average:
            outs = [(o / n).astype(o.dtype, copy=False) for o in outs]
        return outs

    def _ring_allreduce(self, arrs: List[Any]) -> List[np.ndarray]:
        flats = {m: arrs[i].reshape(-1)
                 for i, m in enumerate(self.members)}
        ring = self.ring
        R = len(ring)
        leaders = set(ring)
        N = flats[self.members[0]].shape[0]
        bounds = _segment_bounds(N, R)
        op = self._new_op("ring_allreduce")
        intra_total = sum(
            (len(v) - 1) * R for v in self._node_members.values())
        bcast_total = sum(
            (len(v) - 1) * R for v in self._node_members.values())
        ring_total = 2 * R * (R - 1)
        st = {
            "ring": ring, "bounds": bounds,
            "intra_cursor": {}, "src": {},
            "intra_left": intra_total,
            "ring_left": ring_total,
            "left": intra_total + ring_total + bcast_total,
            "bcast": bcast_total > 0,
        }
        op["ring_st"] = st
        # one accumulator object per (member, segment): leaders start at
        # their own slice, non-leaders at zeros (the bcast landing slot)
        for m in self.members:
            for g, (lo, hi) in enumerate(bounds):
                init = flats[m][lo:hi] if m in leaders \
                    else _zeros_like(flats[m], hi - lo)
                self._register(op, m, g, init)
        # non-leader contributions travel as plain source objects
        for node, mems in self._node_members.items():
            for m in mems[1:]:
                rank = self.cluster.ranks[m]
                for g, (lo, hi) in enumerate(bounds):
                    st["src"][(m, g)] = _new_object(rank, flats[m][lo:hi])
                for g in range(R):
                    st["intra_cursor"][(node, g)] = 1
        if intra_total:
            for node, mems in self._node_members.items():
                if len(mems) > 1:
                    for g in range(R):
                        self._issue_intra(op, node, g)
        else:
            self._start_ring(op)
        self._await(op)
        outs = []
        for m in self.members:
            segs = [_host_value(self._obj(m, op, g)) for g in range(R)]
            outs.append(np.concatenate(segs) if R > 1 else segs[0])
        self._cleanup(op)
        return outs

    def reduce(self, inputs: Sequence[Any],
               root: int) -> List[Optional[np.ndarray]]:
        """Sum every member's array at ``root`` (None elsewhere): tree-up
        below the cutover, ring reduce-scatter + segment gather above."""
        arrs = self._check_inputs(inputs)
        if root not in self.members:
            raise ValueError(f"root {root} not in members {self.members}")
        shape = tuple(arrs[0].shape)
        if len(self.members) == 1:
            return [np.array(_host(arrs[0]))]
        if arrs[0].nbytes <= self.cutover_bytes:
            by_member = self._run_tree([_host(a) for a in arrs], root,
                                       "tree_reduce", down=False)
            return [by_member[root].reshape(shape) if m == root else None
                    for m in self.members]
        flats = {m: arrs[i].reshape(-1)
                 for i, m in enumerate(self.members)}
        ring = self.ring_m
        R = len(ring)
        N = flats[root].shape[0]
        bounds = _segment_bounds(N, R)
        op = self._new_op("ring_reduce")
        st = {"ring": ring, "bounds": bounds, "root": root,
              "intra_left": 0,
              "ring_left": R * (R - 1) + (R - 1),
              "left": R * (R - 1) + (R - 1),
              "bcast": False}
        op["ring_st"] = st
        for m in self.members:
            for g, (lo, hi) in enumerate(bounds):
                self._register(op, m, g, flats[m][lo:hi])
        self._start_ring(op)
        self._await(op)
        segs = [_host_value(self._obj(root, op, g)) for g in range(R)]
        out = (np.concatenate(segs) if R > 1 else segs[0]).reshape(shape)
        self._cleanup(op)
        return [out if m == root else None for m in self.members]

    def broadcast(self, x: Any, root: int) -> List[np.ndarray]:
        """Every member receives ``root``'s array: binomial tree below
        the cutover, segmented pipelined ring of put chains above."""
        arr = _as_input(x)
        if root not in self.members:
            raise ValueError(f"root {root} not in members {self.members}")
        if len(self.members) == 1:
            return [np.array(_host(arr))]
        if arr.nbytes <= self.cutover_bytes:
            by_member = self._run_tree([], root, "tree_bcast", down=True,
                                       seed=_host(arr))
            return [np.array(by_member[m]) for m in self.members]
        flat = arr.reshape(-1)
        ring = self.ring_m
        i = ring.index(root)
        ring = ring[i:] + ring[:i]      # root leads the chain
        R = len(ring)
        bounds = _segment_bounds(flat.shape[0], R)
        op = self._new_op("ring_bcast")
        st = {"ring": ring, "bounds": bounds,
              "blocks": [{"sfx": g, "start": 0} for g in range(R)],
              "left": R * (R - 1)}
        op["ring_st"] = st
        for m in self.members:
            for g, (lo, hi) in enumerate(bounds):
                init = flat[lo:hi] if m == root \
                    else _zeros_like(flat, hi - lo)
                self._register(op, m, g, init)
        for b in range(R):
            self._issue_chain(op, b, 0)
        self._await(op)
        outs = []
        for m in self.members:
            segs = [_host_value(self._obj(m, op, g)) for g in range(R)]
            outs.append((np.concatenate(segs) if R > 1 else segs[0])
                        .reshape(tuple(arr.shape)))
        self._cleanup(op)
        return outs

    def allgather(self, blocks: Sequence[Any]) -> List[np.ndarray]:
        """Every member contributes a (possibly different-length) 1-D
        block; every member receives the concatenation in member order.
        Ring of put chains: member q's block enters at q's ring position
        and travels R-1 hops."""
        arrs = [_as_input(b).reshape(-1) for b in blocks]
        if len(arrs) != len(self.members):
            raise ValueError(
                f"expected {len(self.members)} blocks, got {len(arrs)}")
        if len(self.members) == 1:
            return [np.array(_host(arrs[0]))]
        ring = self.ring_m
        R = len(ring)
        pos = {m: i for i, m in enumerate(ring)}
        op = self._new_op("allgather")
        st = {"ring": ring, "blocks": [], "left": R * (R - 1)}
        op["ring_st"] = st
        for q_i, q in enumerate(self.members):
            for m in self.members:
                init = arrs[q_i] if m == q \
                    else _zeros_like(arrs[q_i], arrs[q_i].shape[0])
                self._register(op, m, ("b", q), init)
            st["blocks"].append({"sfx": ("b", q), "start": pos[q]})
        for b in range(len(st["blocks"])):
            self._issue_chain(op, b, 0)
        self._await(op)
        outs = []
        for m in self.members:
            outs.append(np.concatenate(
                [_host_value(self._obj(m, op, ("b", q)))
                 for q in self.members]))
        self._cleanup(op)
        return outs

    def reduce_scatter(self, inputs: Sequence[Any]) -> List[np.ndarray]:
        """Sum across members, scatter the segments: member at ring
        position g receives segment g of the reduced vector (flattened;
        the ring reduce-scatter phase alone)."""
        arrs = self._check_inputs(inputs)
        flats = {m: arrs[i].reshape(-1)
                 for i, m in enumerate(self.members)}
        if len(self.members) == 1:
            return [np.array(_host(flats[self.members[0]]))]
        ring = self.ring_m
        R = len(ring)
        N = flats[self.members[0]].shape[0]
        bounds = _segment_bounds(N, R)
        op = self._new_op("reduce_scatter")
        st = {"ring": ring, "bounds": bounds, "intra_left": 0,
              "ring_left": R * (R - 1), "left": R * (R - 1),
              "bcast": False}
        op["ring_st"] = st
        for m in self.members:
            for g, (lo, hi) in enumerate(bounds):
                self._register(op, m, g, flats[m][lo:hi])
        self._start_ring(op)
        self._await(op)
        pos = {m: i for i, m in enumerate(ring)}
        outs = [_host_value(self._obj(m, op, pos[m]))
                for m in self.members]
        self._cleanup(op)
        return outs

    # -- single-rank oracles (bit-determinism contract) ----------------
    def oracle_allreduce(self, inputs: Sequence[Any],
                         average: bool = False) -> List[np.ndarray]:
        """Replay allreduce's exact reduction schedule single-threaded in
        numpy — the reference the runtime result is bitwise-identical
        to. Same cutover, same tree shape, same ring order, same operand
        order per add."""
        arrs = self._check_inputs(inputs, host=True)
        shape = arrs[0].shape
        n = len(self.members)
        if n == 1:
            out = arrs[0].copy()
        elif arrs[0].nbytes <= self.cutover_bytes:
            out = self._oracle_tree(arrs, self.members[0])
        else:
            out = self._oracle_ring(
                {m: arrs[i].reshape(-1) for i, m in
                 enumerate(self.members)}, hierarchical=True)
        out = out.reshape(shape)
        if average:
            out = (out / n).astype(out.dtype, copy=False)
        return [out.copy() for _ in self.members]

    def oracle_reduce(self, inputs: Sequence[Any], root: int
                      ) -> np.ndarray:
        arrs = self._check_inputs(inputs, host=True)
        shape = arrs[0].shape
        if len(self.members) == 1:
            return arrs[0].copy()
        if arrs[0].nbytes <= self.cutover_bytes:
            return self._oracle_tree(arrs, root).reshape(shape)
        return self._oracle_ring(
            {m: arrs[i].reshape(-1) for i, m in enumerate(self.members)},
            hierarchical=False).reshape(shape)

    def oracle_reduce_scatter(self, inputs: Sequence[Any]
                              ) -> List[np.ndarray]:
        arrs = self._check_inputs(inputs, host=True)
        flats = {m: arrs[i].reshape(-1)
                 for i, m in enumerate(self.members)}
        if len(self.members) == 1:
            return [flats[self.members[0]].copy()]
        full = self._oracle_ring(flats, hierarchical=False)
        ring = self.ring_m
        pos = {m: i for i, m in enumerate(ring)}
        bounds = _segment_bounds(full.size, len(ring))
        return [full[bounds[pos[m]][0]:bounds[pos[m]][1]].copy()
                for m in self.members]

    def _oracle_tree(self, arrs: List[np.ndarray],
                     root: int) -> np.ndarray:
        order = self._tree(root)
        idx = {m: i for i, m in enumerate(self.members)}
        R = len(order)

        def subtree(p: int) -> np.ndarray:
            acc = arrs[idx[order[p]]]
            for c in _tree_children(p, R):
                acc = acc + subtree(c)
            return acc

        return subtree(0)

    def _oracle_ring(self, flats: Dict[int, np.ndarray],
                     hierarchical: bool) -> np.ndarray:
        if hierarchical:
            acc_by = {}
            for mems in self._node_members.values():
                acc = flats[mems[0]].copy()
                for m in mems[1:]:
                    acc = acc + flats[m]    # intra: base + incoming
                acc_by[mems[0]] = acc
            ring = self.ring
        else:
            acc_by = {m: flats[m] for m in flats}
            ring = self.ring_m
        R = len(ring)
        if R == 1:
            return acc_by[ring[0]]
        out = np.empty_like(acc_by[ring[0]])
        for g, (lo, hi) in enumerate(_segment_bounds(out.size, R)):
            acc = acc_by[ring[(g + 1) % R]][lo:hi]
            for k in range(2, R + 1):
                # ring hop: the RECEIVER's accumulator is the left
                # operand (slab + chunk), matching the fused reduce
                acc = acc_by[ring[(g + k) % R]][lo:hi] + acc
            out[lo:hi] = acc
        return out

    def describe(self) -> Dict[str, Any]:
        """Shape snapshot for reports/benchmarks."""
        return {"members": list(self.members),
                "leaders": list(self.leaders),
                "ring": list(self.ring),
                "member_ring": list(self.ring_m),
                "cutover_bytes": self.cutover_bytes,
                "tag_space": self.tag_space}
