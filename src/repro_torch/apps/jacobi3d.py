"""Jacobi3D proxy application (paper §4.3–4.4).

Five execution modes on the same numerics:

  run_reference   — single-tensor plain PyTorch oracle
  run_tasked      — PREMA-style: the domain is over-decomposed into mobile
                    chunks executed as hetero_tasks with implicit
                    dependencies; halo exchange = put operations; compute and
                    halo traffic of different chunks overlap (paper Fig. 14)
  run_cluster     — distributed proxy on the message engine: slabs are
                    scattered over ranks through ``Rank.send`` (large slabs
                    ride the chunk-streamed rendezvous protocol), halo
                    planes travel as DIRECT ``Rank.put`` operations into
                    preregistered halo objects, and the result is gathered
                    back through the same protocol (paper §4.3); every k
                    iterations the global update residual through a
                    runtime allreduce (``residual_every``).
  run_cluster_elastic — run_cluster's numerics under the elastic fault-
                    tolerance runtime: slabs are mobile chunks tracked by
                    an OwnerMap, every iteration commits a checkpoint, and
                    a fault schedule (kill / revive / freeze) exercises the
                    detect → shrink → restore → resume loop live. The run
                    survives losing a rank mid-flight with a bounded stall
                    and NO restart, and the answer stays bit-identical.
  run_spmd        — the SPMD production version: the domain sharded along
                    x over a mesh axis, each step a ``shard_map`` whose
                    shards exchange their x faces by ``halo_exchange_1d``
                    and update their slabs; ``bulk_sync`` holds every
                    update until every exchange is done (the MPI+CUDA
                    baseline schedule the paper compares against).

Every update computes ``stencil_update``, which on a CUDA tensor is the
face-taking Jacobi kernel (``repro_torch.kernels.jacobi3d``): the padded
copy of a chunk is never built.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_numpy, to_torch
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import Runtime, spans
from repro_torch.distributed import spmd
from repro_torch.distributed.collectives import halo_exchange_1d
from repro_torch.distributed.collectives_rt import CollectiveGroup
from repro_torch.distributed.elastic import ElasticRuntime, forget
from repro_torch.distributed.handlers import handler
from repro_torch.distributed.mobile_object import OwnerMap, block_distribution
from repro_torch.distributed.overdecomp import plan_decomposition
from repro_torch.distributed.spmd import Mesh
from repro_torch.kernels import ops


def stencil_update(u: torch.Tensor, lo0, hi0, lo1, hi1, lo2,
                   hi2) -> torch.Tensor:
    """One Jacobi sweep over the interior given face halos (each a slab of
    thickness 1; zeros at physical boundaries)."""
    return ops.jacobi3d_faces(u, lo0, hi0, lo1, hi1, lo2, hi2)


# ---------------------------------------------------------------------------
# reference
# ---------------------------------------------------------------------------

def run_reference(u0: np.ndarray, iters: int,
                  device="cuda") -> np.ndarray:
    """The oracle: ``iters`` sweeps of the whole domain on ``device`` with
    the plain PyTorch stencil (never the CUDA kernel)."""
    u = to_torch(u0, device)
    x, y, z = u.shape
    zeros = {d: torch.zeros(d, dtype=u.dtype, device=u.device)
             for d in ((y, z), (x, z), (x, y))}
    for _ in range(iters):
        u = ops.jacobi3d_faces_plain(
            u, zeros[(y, z)], zeros[(y, z)], zeros[(x, z)], zeros[(x, z)],
            zeros[(x, y)], zeros[(x, y)])
    return to_numpy(u)


# ---------------------------------------------------------------------------
# PREMA-tasked over-decomposed version
# ---------------------------------------------------------------------------

def run_tasked(u0: np.ndarray, iters: int, runtime: Runtime,
               over_decomposition: int = 1) -> np.ndarray:
    """Over-decomposed Jacobi on the heterogeneous tasking runtime. Chunks
    are hetero_objects; each iteration submits per-chunk face-extraction and
    update tasks whose dependencies the runtime infers — independent chunks
    overlap automatically (the paper's Fig. 14 pipeline). The chunking
    and objects' creation, the sweeps and the gather are spans
    (``jacobi.upload``, ``jacobi.sweeps``, ``jacobi.download``)."""
    with spans.span("jacobi.upload"):
        n_workers = len(runtime.devices)
        plan = plan_decomposition(u0.shape, n_workers, over_decomposition)
        chunks = {c.cid: runtime.hetero_object(
            np.ascontiguousarray(u0[c.lo[0]:c.hi[0], c.lo[1]:c.hi[1],
                                    c.lo[2]:c.hi[2]]), name=f"chunk{c.cid}")
            for c in plan.chunks}
        # halo buffers per (chunk, face)
        faces = {}
        for c in plan.chunks:
            s = c.shape
            face_shapes = {"lo0": (s[1], s[2]), "hi0": (s[1], s[2]),
                           "lo1": (s[0], s[2]), "hi1": (s[0], s[2]),
                           "lo2": (s[0], s[1]), "hi2": (s[0], s[1])}
            for tag, fs in face_shapes.items():
                faces[(c.cid, tag)] = runtime.hetero_object(
                    np.zeros(fs, u0.dtype), name=f"halo{c.cid}:{tag}")

    # kernels created once → the device's kernel cache hits across iterations
    def make_face_kernel(tag: str):
        d = int(tag[-1])
        hi = tag.startswith("hi")

        def extract(u, out):
            idx = [slice(None)] * 3
            idx[d] = -1 if hi else 0
            # a copy of its own: the face must not alias the chunk
            return u[tuple(idx)].clone(memory_format=torch.contiguous_format)
        return extract

    face_kernels = {tag: make_face_kernel(tag)
                    for tag in ("lo0", "hi0", "lo1", "hi1", "lo2", "hi2")}

    def update_kernel(u, l0, h0, l1, h1, l2, h2):
        return stencil_update(u, l0, h0, l1, h1, l2, h2)

    opposite = {"lo0": "hi0", "hi0": "lo0", "lo1": "hi1", "hi1": "lo1",
                "lo2": "hi2", "hi2": "lo2"}

    with spans.span("jacobi.sweeps"):
        for _ in range(iters):
            # 1) extract + "send" faces into the neighbour's halo buffers
            # (put)
            for c in plan.chunks:
                nb = plan.neighbors(c.cid)
                for tag, other in nb.items():
                    if other is None:
                        continue
                    runtime.run(
                        face_kernels[tag],
                        [(chunks[c.cid], "r"),
                         (faces[(other, opposite[tag])], "w")],
                        name=f"halo{c.cid}->{other}")
            # 2) update each chunk from its halo buffers
            for c in plan.chunks:
                args = [(chunks[c.cid], "rw")]
                for tag in ("lo0", "hi0", "lo1", "hi1", "lo2", "hi2"):
                    args.append((faces[(c.cid, tag)], "r"))
                runtime.run(update_kernel, args, name=f"update{c.cid}")
            # iteration edge: the window delimiter task-graph replay keys
            # recurrence detection on (a no-op unless trace_graphs is set)
            runtime.step_boundary()
        runtime.barrier(timeout=600)

    with spans.span("jacobi.download"):
        out = np.empty_like(u0)
        for c in plan.chunks:
            out[c.lo[0]:c.hi[0], c.lo[1]:c.hi[1], c.lo[2]:c.hi[2]] = \
                chunks[c.cid].get()
    return out


# ---------------------------------------------------------------------------
# distributed version on the message engine (paper §4.3)
# ---------------------------------------------------------------------------
# handler-side state lives on the Rank objects themselves (one driver
# thread coordinates; handlers only deposit data and trip events)

@handler(name="jacobi_slab")
def _recv_slab(ctx, obj):
    st = ctx.rank._jacobi
    st["slab"] = obj
    st["slab_evt"].set()


@handler(name="jacobi_halo_done")
def _halo_done(ctx, obj):
    st = ctx.rank._jacobi
    with st["lock"]:
        st["halos"] += 1
        if st["halos"] >= st["halos_expected"]:
            st["halo_evt"].set()


@handler(name="jacobi_gather")
def _recv_gather(ctx, obj):
    st = ctx.rank._jacobi
    with st["lock"]:
        st["gathered"][ctx.message.user["part"]] = obj
        if len(st["gathered"]) >= st["gather_expected"]:
            st["gather_evt"].set()


def _slab_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    return [(p * n // parts, (p + 1) * n // parts) for p in range(parts)]


def _wait(evt: threading.Event, what: str, timeout: float = 600.0) -> None:
    if not evt.wait(timeout):
        raise TimeoutError(f"run_cluster: {what} did not complete within "
                           f"{timeout:.0f} s")


def _copy(u, out):
    return u.clone()


def _sq_diff_sum(u, old, out, planes: int = 32):
    """``sum((u - old)^2)`` in float64 as a one-element tensor, a few
    planes at a time (the float64 temporaries stay small)."""
    acc = torch.zeros((), dtype=torch.float64, device=u.device)
    for lo in range(0, u.shape[0], planes):
        d = u[lo:lo + planes].double() - old[lo:lo + planes].double()
        acc += (d * d).sum()
    return acc.reshape(1)


def run_cluster(u0: np.ndarray, iters: int, cluster, *,
                residual_every: int = 0,
                residuals: Optional[list] = None) -> np.ndarray:
    """Distributed Jacobi over ``cluster``'s ranks: axis-0 slab
    decomposition, scatter/gather through ``Rank.send`` (credit-windowed
    rendezvous streams for slabs above the eager threshold — big slabs
    never head-of-line block the halo control traffic), per-iteration
    halo planes through DIRECT ``Rank.put`` into preregistered halo
    objects (the freshly-extracted face already lives on a device, so the
    plane travels device-to-device; oversized planes chunk-stream through
    the same rendezvous path). Each update is ``stencil_update``: on a
    CUDA device the ``jacobi3d_faces`` kernel.

    ``residual_every=k`` computes the global update-residual norm
    ``||u_new - u_old||_2`` every k iterations through a runtime
    allreduce of per-rank partial sums (``(iter, norm)`` appended to
    ``residuals``) — no slab ever travels to rank 0 for it, unlike the
    final gather. Each rank keeps ``u_old`` as a clone on its device and
    computes its float64 partial as a task ordered after the update."""
    ranks = cluster.ranks
    n = len(ranks)
    bounds = _slab_bounds(u0.shape[0], n)
    for i, r in enumerate(ranks):
        r._jacobi = {
            "lock": threading.Lock(), "slab": None,
            "slab_evt": threading.Event(), "halos": 0,
            "halos_expected": (1 if i > 0 else 0) + (1 if i < n - 1 else 0),
            "halo_evt": threading.Event(),
            "gathered": {}, "gather_expected": n - 1,
            "gather_evt": threading.Event(),
        }
    # scatter: rank 0 owns u0; remote slabs travel the message protocol
    for i, (lo, hi) in enumerate(bounds):
        part = np.ascontiguousarray(u0[lo:hi])
        if i == 0:
            ranks[0]._jacobi["slab"] = ranks[0].runtime.hetero_object(part)
        else:
            src = ranks[0].runtime.hetero_object(part)
            ranks[0].send(i, "jacobi_slab", src)
    for i in range(1, n):
        _wait(ranks[i]._jacobi["slab_evt"], f"scatter to rank {i}")

    # per-rank halo objects + frozen zero faces for the untouched dims
    zeros = {}
    for i, r in enumerate(ranks):
        s = r._jacobi["slab"].shape
        rt = r.runtime
        r.register_object("jlo", rt.hetero_object(
            np.zeros((s[1], s[2]), u0.dtype)))
        r.register_object("jhi", rt.hetero_object(
            np.zeros((s[1], s[2]), u0.dtype)))
        zeros[i] = (rt.hetero_object(np.zeros((s[0], s[2]), u0.dtype)),
                    rt.hetero_object(np.zeros((s[0], s[1]), u0.dtype)))

    # a copy of its own: a face must not alias the slab
    def lo_face(u, out):
        return u[0].clone()

    def hi_face(u, out):
        return u[-1].clone()

    def update(u, l0, h0, z1, z2):
        return stencil_update(u, l0, h0, z1, z1, z2, z2)

    coll = CollectiveGroup(cluster) if residual_every > 0 else None

    for it in range(iters):
        res_tick = coll is not None and (it + 1) % residual_every == 0
        olds = []
        if res_tick:
            # u_old: the runtime orders the copy before this update
            for r in ranks:
                slab = r._jacobi["slab"]
                old = r.runtime.hetero_object(shape=slab.shape,
                                              dtype=slab.dtype)
                r.runtime.run(_copy, [(slab, "r"), (old, "w")])
                olds.append(old)
        for r in ranks:
            r._jacobi["halos"] = 0
            r._jacobi["halo_evt"].clear()
        # extract boundary planes + put them into the neighbours' halos
        for i, r in enumerate(ranks):
            rt, slab = r.runtime, r._jacobi["slab"]
            s = slab.shape
            if i > 0:
                f = rt.hetero_object(shape=(s[1], s[2]), dtype=u0.dtype)
                rt.run(lo_face, [(slab, "r"), (f, "w")])
                r.put(i - 1, "jhi", f, on_done="jacobi_halo_done",
                      path="direct")
            if i < n - 1:
                f = rt.hetero_object(shape=(s[1], s[2]), dtype=u0.dtype)
                rt.run(hi_face, [(slab, "r"), (f, "w")])
                r.put(i + 1, "jlo", f, on_done="jacobi_halo_done",
                      path="direct")
        for r in ranks:
            if r._jacobi["halos_expected"]:
                _wait(r._jacobi["halo_evt"], f"halo exchange of rank {r.rank}")
        # update each slab from its (now current) halo objects
        for i, r in enumerate(ranks):
            rt, slab = r.runtime, r._jacobi["slab"]
            z1, z2 = zeros[i]
            rt.run(update, [(slab, "rw"), (r.objects["jlo"], "r"),
                            (r.objects["jhi"], "r"), (z1, "r"), (z2, "r")])
        for r in ranks:
            r.runtime.barrier(timeout=600)
        if res_tick:
            # per-rank partial ||du||^2, summed by a (tiny, eager-tree)
            # runtime allreduce — bit-identical on every member
            parts = []
            for r, old in zip(ranks, olds):
                part = r.runtime.hetero_object(shape=(1,), dtype=np.float64)
                r.runtime.run(_sq_diff_sum, [(r._jacobi["slab"], "r"),
                                             (old, "r"), (part, "w")])
                parts.append(part)
            parts = [part.get() for part in parts]
            for old in olds:
                old.free()
            total = coll.allreduce(parts)[0]
            if residuals is not None:
                residuals.append((it + 1, float(np.sqrt(total[0]))))

    # gather back to rank 0 through the protocol
    for i in range(1, n):
        ranks[i].send(0, "jacobi_gather", ranks[i]._jacobi["slab"],
                      user={"part": i})
    if n > 1:
        _wait(ranks[0]._jacobi["gather_evt"], "gather")
    out = np.empty_like(u0)
    out[bounds[0][0]:bounds[0][1]] = ranks[0]._jacobi["slab"].get()
    for i in range(1, n):
        lo, hi = bounds[i]
        out[lo:hi] = ranks[0]._jacobi["gathered"][i].get()
    return out


# ---------------------------------------------------------------------------
# elastic fault-tolerant version
# ---------------------------------------------------------------------------
# Slabs are mobile chunks keyed ("jslab", i) in an OwnerMap; halo planes
# land in per-slab objects ("jhalo", side, i) at the slab's CURRENT owner.
# The coordinating loop never assumes the world is stable: each iteration
# snapshots the elastic epoch under er.hold(), issues the halo puts against
# that snapshot, and redoes the phase from scratch if a recovery or drain
# bumped the epoch mid-exchange. Redo is safe because slabs only change
# inside the committed update phase — a re-extracted face is bitwise the
# face the first attempt extracted.

@handler(name="jacobi_eslab")
def _recv_eslab(ctx, obj):
    ctx.rank.register_object(("jslab", ctx.message.user["slab"]), obj)


@handler(name="jacobi_replica")
def _recv_replica(ctx, obj):
    """Landing half of slab replication: register the committed bytes as
    a live replica under the slab's global key (so ``ElasticRuntime``'s
    replica-first recovery finds it) and mark the (iteration, slab) pair
    arrived for the coordinating loop's replication barrier."""
    u = ctx.message.user
    old = ctx.rank.objects.get(("jslab", u["slab"]))
    if old is not None and old is not obj:
        forget(ctx.rank, old)
    ctx.rank.register_object(("jslab", u["slab"]), obj)
    st = getattr(ctx.rank, "_jac_rep", None)
    if st is not None:
        with st["lock"]:
            st["got"].add((u["it"], u["slab"]))


@handler(name="jac_halo_mark")
def _halo_mark(ctx, obj):
    # obj is the preregistered halo target; None would mean the put beat
    # the registration (can't happen: registration is caller-side, before
    # the put issues) — refuse to mark rather than count lost data.
    st = getattr(ctx.rank, "_jac_halos", None)
    if st is None or obj is None:
        return
    with st["lock"]:
        st["got"].add(ctx.message.object_key)


def _poll_until(pred: Callable[[], bool], what: str, deadline: float,
                stop: Callable[[], bool] = lambda: False) -> bool:
    """Poll ``pred`` until it holds (True) or ``stop`` does (False);
    raise ``TimeoutError`` naming ``what`` past ``deadline``."""
    while not pred():
        if stop():
            return False
        if time.time() > deadline:
            raise TimeoutError(f"run_cluster_elastic: {what} stalled")
        time.sleep(0.002)
    return True


def run_cluster_elastic(u0: np.ndarray, iters: int, cluster, *,
                        slabs: Optional[int] = None,
                        ckpt_dir: Optional[str] = None,
                        kill: Optional[Tuple[int, int]] = None,
                        revive_at: Optional[Tuple[int, int]] = None,
                        freeze: Optional[Tuple[int, int, float]] = None,
                        replicate: bool = False,
                        corrupt_links: float = 0.0,
                        corrupt_leaf_at: Optional[Tuple[int, str]] = None,
                        heartbeat_interval_s: float = 0.02,
                        heartbeat_timeout_s: float = 0.5,
                        straggler_factor: float = 25.0,
                        poll_period_s: Optional[float] = None,
                        wait_timeout_s: float = 120.0,
                        ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Distributed Jacobi that SURVIVES rank loss and stragglers mid-run.

    ``kill=(rank, it)`` kills ``rank`` after iteration ``it`` commits its
    checkpoint; ``revive_at=(rank, it)`` folds it back in with live
    rebalancing migrations; ``freeze=(rank, it, secs)`` freezes a rank's
    network (it keeps computing) so the straggler path drains chunks off
    it. Recovery restores lost slabs from the per-iteration checkpoint —
    exact committed bytes, so a faulted run matches an unfaulted one
    bit-for-bit. A rank whose heartbeats stop is a straggler once the gap
    reaches ``straggler_factor × heartbeat_interval_s`` and dead past
    ``heartbeat_timeout_s``: a kill needs the timeout below the straggler
    gap (a dead rank taken for a straggler is drained, and its chunks
    never land), a freeze needs it above the freeze. Each update is
    ``stencil_update`` (on a card the ``jacobi3d_faces`` kernel), once per
    slab and iteration whatever the faults. Returns ``(result, report)``;
    beside the JAX package's keys
    the report holds ``iteration_s`` (each iteration's wall seconds, from
    its first halo put to the end of its fault schedule) and, with a
    checkpoint directory, ``checkpoint`` (the saves and their seconds,
    host gather and write).

    Integrity knobs: ``replicate=True`` streams each slab's committed
    bytes to a buddy rank (next alive rank in the ring) every iteration,
    so recovery prefers a live replica over disk. ``corrupt_links=p``
    bit-flips every host-staged payload on every directed link with
    probability ``p`` — the checksum layer rejects the flipped bytes and
    the reliability layer retransmits, so the run still converges
    bit-identically. ``corrupt_leaf_at=(it, key)`` flips one bit in that
    committed checkpoint leaf right after iteration ``it`` commits
    (silent storage corruption); the digest-validated restore path
    detects it and falls back to a replica or older step.
    """
    ranks = cluster.ranks
    n = len(ranks)
    S = slabs or n
    bounds = _slab_bounds(u0.shape[0], S)
    owner = OwnerMap()
    for i, r in block_distribution(S, n).items():
        owner.assign(i, r)

    faults = cluster.faults
    if (kill or revive_at or freeze or corrupt_links
            or corrupt_leaf_at) and faults is None:
        faults = cluster.fault_injector()
    if kill is not None and ckpt_dir is None and not replicate:
        raise ValueError("kill schedule needs ckpt_dir or replicate=True: "
                         "lost slabs are restored from the committed "
                         "checkpoint or a live replica")
    if corrupt_leaf_at is not None and ckpt_dir is None:
        raise ValueError("corrupt_leaf_at needs ckpt_dir")
    if corrupt_links:
        for a in range(n):
            for b in range(n):
                if a != b:
                    faults.set_link(a, b, corrupt=corrupt_links)

    ckpt = (Checkpointer(ckpt_dir, keep=3, async_save=False)
            if ckpt_dir else None)
    ckpt_stats = {"saves": 0, "save_s": 0.0}

    def restore_fn(oid):
        # newest committed copy of the leaf that passes digest/shape
        # validation — a corrupted newest step falls back to an older one
        if ckpt.latest_step() is None:
            raise RuntimeError("rank loss before the first checkpoint")
        _step, arr = ckpt.restore_leaf_fallback(f"slab{oid}")
        return arr

    er = ElasticRuntime(
        cluster, owner, key_fn=lambda oid: ("jslab", oid),
        restore_fn=restore_fn if ckpt is not None else None,
        monitor=0, heartbeat_interval_s=heartbeat_interval_s,
        heartbeat_timeout_s=heartbeat_timeout_s,
        straggler_factor=straggler_factor)

    for r in ranks:
        r._jac_halos = {"lock": threading.Lock(), "got": set()}
        r._jac_rep = {"lock": threading.Lock(), "got": set()}

    # -- scatter against the initial owner map -------------------------
    for i, (lo, hi) in enumerate(bounds):
        part = np.ascontiguousarray(u0[lo:hi])
        dst = owner.owner(i)
        obj = ranks[0].runtime.hetero_object(part)
        if dst == 0:
            ranks[0].register_object(("jslab", i), obj)
        else:
            ranks[0].send(dst, "jacobi_eslab", obj, user={"slab": i})
    t_end = time.time() + wait_timeout_s
    for i in range(S):
        _poll_until(lambda i=i: ("jslab", i) in ranks[owner.owner(i)].objects,
                    f"scatter of slab {i}", t_end)

    # the same kernels on every rank, so a migrated slab computes the same
    # bits wherever it lands; a face is a copy of its own (it must not
    # alias the slab)
    def lo_face(u, out):
        return u[0].clone()

    def hi_face(u, out):
        return u[-1].clone()

    def update(u, l0, h0, z1, z2):
        return stencil_update(u, l0, h0, z1, z1, z2, z2)

    zcache: Dict[Tuple[int, Tuple[int, ...]], Tuple[Any, Any]] = {}

    def zeros_for(r, s):
        z = zcache.get((r.rank, s))
        if z is None:
            z = (r.runtime.hetero_object(np.zeros((s[0], s[2]), u0.dtype)),
                 r.runtime.hetero_object(np.zeros((s[0], s[1]), u0.dtype)))
            zcache[(r.rank, s)] = z
        return z

    def ensure_halos():
        # halo targets must exist at a slab's current owner BEFORE any put
        # for this epoch issues (registration is caller-side + in-process,
        # so it happens-before the put's network delivery)
        for i in range(S):
            r = ranks[owner.owner(i)]
            s = r.objects[("jslab", i)].shape
            for side in ("lo", "hi"):
                key = ("jhalo", side, i)
                if key not in r.objects:
                    r.register_object(key, r.runtime.hetero_object(
                        np.zeros((s[1], s[2]), u0.dtype)))

    def issue_halos():
        expected = []
        for i in range(S):
            src = ranks[owner.owner(i)]
            rt = src.runtime
            slab = src.objects[("jslab", i)]
            s = slab.shape
            if i > 0:
                f = rt.hetero_object(shape=(s[1], s[2]), dtype=u0.dtype)
                rt.run(lo_face, [(slab, "r"), (f, "w")])
                src.put(owner.owner(i - 1), ("jhalo", "hi", i - 1), f,
                        on_done="jac_halo_mark", path="direct")
                expected.append((owner.owner(i - 1), ("jhalo", "hi", i - 1)))
            if i < S - 1:
                f = rt.hetero_object(shape=(s[1], s[2]), dtype=u0.dtype)
                rt.run(hi_face, [(slab, "r"), (f, "w")])
                src.put(owner.owner(i + 1), ("jhalo", "lo", i + 1), f,
                        on_done="jac_halo_mark", path="direct")
                expected.append((owner.owner(i + 1), ("jhalo", "lo", i + 1)))
        return expected

    iteration_s: List[float] = []
    er.start(poll_period_s)
    try:
        for it in range(iters):
            t_it = time.perf_counter()
            rep_expected: List[Tuple[int, int]] = []
            while True:               # redo loop: one pass per world epoch
                with er.hold():
                    epoch0 = er.epoch
                    for r in ranks:
                        with r._jac_halos["lock"]:
                            r._jac_halos["got"].clear()
                    ensure_halos()
                    expected = issue_halos()
                # wait outside the hold so the monitor can reshape the
                # world underneath us; epoch bump → redo from scratch
                done = _poll_until(
                    lambda: all(key in ranks[dst]._jac_halos["got"]
                                for dst, key in expected),
                    f"halo exchange at iteration {it}",
                    time.time() + wait_timeout_s,
                    stop=lambda: er.epoch != epoch0)
                if not done:
                    continue
                with er.hold():
                    if er.epoch != epoch0:
                        continue       # world changed after the wait; redo
                    for i in range(S):
                        r = ranks[owner.owner(i)]
                        slab = r.objects[("jslab", i)]
                        z1, z2 = zeros_for(r, slab.shape)
                        r.runtime.run(
                            update,
                            [(slab, "rw"),
                             (r.objects[("jhalo", "lo", i)], "r"),
                             (r.objects[("jhalo", "hi", i)], "r"),
                             (z1, "r"), (z2, "r")])
                    alive = set(er.controller.alive_workers())
                    for r in ranks:
                        if r.rank in alive:
                            r.runtime.barrier(timeout=wait_timeout_s)
                    if ckpt is not None:
                        t0 = time.perf_counter()
                        ckpt.save(it, {
                            f"slab{i}": ranks[owner.owner(i)]
                            .objects[("jslab", i)].get()
                            for i in range(S)}, block=True)
                        ckpt_stats["saves"] += 1
                        ckpt_stats["save_s"] += time.perf_counter() - t0
                    if replicate:
                        # stream each slab's committed bytes to its ring
                        # buddy; recovery will prefer this live replica
                        # over a disk read. Stale replicas elsewhere are
                        # dropped first — a later recovery must never
                        # resurrect an older iteration's bytes.
                        for i in range(S):
                            own = owner.owner(i)
                            cands = sorted(w for w in alive if w != own)
                            if not cands:
                                continue
                            buddy = next((w for w in cands if w > own),
                                         cands[0])
                            for r in ranks:
                                if r.rank in (own, buddy):
                                    continue
                                stale = r.objects.pop(("jslab", i), None)
                                if stale is not None:
                                    forget(r, stale)
                            ranks[own].send(
                                buddy, "jacobi_replica",
                                ranks[own].objects[("jslab", i)],
                                user={"slab": i, "it": it})
                            rep_expected.append((buddy, i))
                    break              # iteration committed
            # replication barrier OUTSIDE the hold (the buddy's pump must
            # run to land the stream) and BEFORE the fault schedule: the
            # replica must exist before the rank it protects against dies
            t_end = time.time() + wait_timeout_s
            for buddy, i in rep_expected:
                _poll_until(
                    lambda b=buddy, i=i: (it, i) in ranks[b]._jac_rep["got"],
                    f"replica of slab {i} at iteration {it}", t_end)
            # fault schedule fires AFTER the commit point, so a restore
            # replays exactly this iteration's bytes
            if faults is not None:
                if corrupt_leaf_at is not None and it == corrupt_leaf_at[0]:
                    faults.corrupt_checkpoint_leaf(ckpt_dir, it,
                                                   corrupt_leaf_at[1])
                if kill is not None and it == kill[1]:
                    faults.kill_rank(kill[0])
                if freeze is not None and it == freeze[1]:
                    faults.freeze_rank(freeze[0], freeze[2])
                if revive_at is not None and it == revive_at[1]:
                    faults.revive_rank(revive_at[0])
                    er.grow([revive_at[0]])
            iteration_s.append(time.perf_counter() - t_it)
    finally:
        er.close()

    report = er.report()
    report["epochs"] = er.epoch
    if faults is not None:
        report["faults"] = dict(faults.stats)
    report["integrity"] = {
        "checksum_fail": sum(r.stats["checksum_fail"] for r in ranks),
        "chunks_rejected": sum(r.stats["chunks_rejected"] for r in ranks),
        "retries": sum(r.stats["retries"] for r in ranks),
        "task_retries": sum(r.runtime.stats()["task_retries"]
                            for r in ranks),
        "lineage_recomputes": sum(r.runtime.stats()["lineage_recomputes"]
                                  for r in ranks),
        "ckpt_verify_fail": ckpt.stats["ckpt_verify_fail"] if ckpt else 0,
        "restore_fallbacks": er.stats["restore_fallbacks"],
    }
    report["collectives"] = {
        "coll_bytes_reduced": sum(
            r.stats["coll_bytes_reduced"] for r in ranks),
        "coll_chunks_in_flight_peak": max(
            r.stats["coll_chunks_in_flight_peak"] for r in ranks),
        "coll_aborts": sum(r.stats["coll_aborts"] for r in ranks),
    }
    report["iteration_s"] = iteration_s
    if ckpt is not None:
        report["checkpoint"] = ckpt_stats
    out = np.empty_like(u0)
    for i, (lo, hi) in enumerate(bounds):
        out[lo:hi] = ranks[owner.owner(i)].objects[("jslab", i)].get()
    return out, report


# ---------------------------------------------------------------------------
# SPMD version (shard_map + ppermute over the single-controller mesh)
# ---------------------------------------------------------------------------

def make_spmd_step(mesh: Mesh, axis: str = "data", bulk_sync: bool = False):
    """One step over ``u`` sharded along dim 0 of [X,Y,Z] over ``axis``:
    ``Sharded`` in, ``Sharded`` out. Each shard exchanges its x faces with
    its neighbours and updates its slab; its y and z faces are zeros,
    allocated at its first step. bulk_sync=True holds every shard's update
    until every shard's exchange has completed — the MPI+CUDA baseline
    schedule; otherwise a shard's update waits only on its own two
    incoming faces."""
    zeros: Dict[Tuple[int, ...], Tuple[torch.Tensor, torch.Tensor]] = {}

    def local_step(u):
        lo0, hi0 = halo_exchange_1d(u, axis)
        if bulk_sync:
            u, lo0, hi0 = spmd.bulk_barrier(u, lo0, hi0)
        # each shard's own faces, made on its stream: no shared update
        me = tuple(spmd.axis_index(a) for a in mesh.axis_names)
        if me not in zeros:
            zeros[me] = (u.new_zeros((u.shape[0], u.shape[2])),
                         u.new_zeros((u.shape[0], u.shape[1])))
        zy, zz = zeros[me]
        return stencil_update(u, lo0[0], hi0[0], zy, zy, zz, zz)

    return spmd.shard_map(local_step, mesh, in_specs=spmd.P(axis),
                          out_specs=spmd.P(axis))


def run_spmd(u0: np.ndarray, iters: int, mesh: Mesh, axis: str = "data",
             bulk_sync: bool = False) -> np.ndarray:
    """``iters`` sweeps of ``u0`` sharded along dim 0 over ``axis`` of
    ``mesh`` (on its shards' devices)."""
    step = make_spmd_step(mesh, axis, bulk_sync)
    u = spmd.device_put(torch.from_numpy(np.ascontiguousarray(u0)), mesh,
                        spmd.P(axis))
    for _ in range(iters):
        u = step(u)
    return to_numpy(u.full("cpu"))
