"""Jacobi3D proxy application (paper §4.3–4.4).

Two execution modes on the same numerics:

  run_reference   — single-tensor plain PyTorch oracle
  run_tasked      — PREMA-style: the domain is over-decomposed into mobile
                    chunks executed as hetero_tasks with implicit
                    dependencies; halo exchange = put operations; compute and
                    halo traffic of different chunks overlap (paper Fig. 14)

The distributed and SPMD modes of the JAX package are not ported yet.

Every update task computes ``stencil_update``, which on a CUDA tensor is the
face-taking Jacobi kernel (``repro_torch.kernels.jacobi3d``): the padded
copy of a chunk is never built.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import Runtime
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
        # iteration edge: the window delimiter task-graph replay will key
        # recurrence detection on (a no-op until replay is ported)
        runtime.step_boundary()
    runtime.barrier(timeout=600)

    out = np.empty_like(u0)
    for c in plan.chunks:
        out[c.lo[0]:c.hi[0], c.lo[1]:c.hi[1], c.lo[2]:c.hi[2]] = \
            chunks[c.cid].get()
    return out
