"""Jacobi3D proxy application (paper §4.3–4.4).

Three execution modes on the same numerics:

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
                    back through the same protocol (paper §4.3).

The elastic and SPMD modes of the JAX package are not ported yet.

Every update task computes ``stencil_update``, which on a CUDA tensor is the
face-taking Jacobi kernel (``repro_torch.kernels.jacobi3d``): the padded
copy of a chunk is never built.
"""
from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import Runtime
from repro_torch.distributed.handlers import handler
from repro_torch.distributed.overdecomp import plan_decomposition
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
    overlap automatically (the paper's Fig. 14 pipeline)."""
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

    for _ in range(iters):
        # 1) extract + "send" faces into the neighbour's halo buffers (put)
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


def run_cluster(u0: np.ndarray, iters: int, cluster, *,
                residual_every: int = 0) -> np.ndarray:
    """Distributed Jacobi over ``cluster``'s ranks: axis-0 slab
    decomposition, scatter/gather through ``Rank.send`` (credit-windowed
    rendezvous streams for slabs above the eager threshold — big slabs
    never head-of-line block the halo control traffic), per-iteration
    halo planes through DIRECT ``Rank.put`` into preregistered halo
    objects (the freshly-extracted face already lives on a device, so the
    plane travels device-to-device; oversized planes chunk-stream through
    the same rendezvous path). Each update is ``stencil_update``: on a
    CUDA device the ``jacobi3d_faces`` kernel.

    ``residual_every > 0`` (the JAX package's global residual through a
    runtime allreduce) needs the runtime collectives, which are not
    ported yet, and raises."""
    if residual_every > 0:
        raise NotImplementedError(
            "run_cluster(residual_every=...) needs the runtime collectives "
            "(distributed/collectives_rt.py), not ported yet; see ROADMAP.md "
            "Queue 1")
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

    for _ in range(iters):
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
