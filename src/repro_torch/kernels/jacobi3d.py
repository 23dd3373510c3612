"""Jacobi-3D stencil: the CUDA kernel (``csrc/jacobi3d.cu``) and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``_jacobi_kernel`` / ``jacobi3d`` of
``repro/kernels/jacobi3d.py``. Two entry points:

  ``jacobi3d(u_pad)``                the Pallas contract: halo-padded slab
                                     [X+2, Y+2, Z+2] → interior [X, Y, Z];
  ``jacobi3d_faces(u, lo0, ..., hi2)`` ``stencil_update``'s contract: a
                                     chunk and its six face halos, without
                                     building the padded copy.

Both sum the six neighbours in the reference's order and divide truly by
6. PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, so the plain versions divide by a 0-dim tensor on the same
device, which is a true division; kernel and plain version then agree bit
for bit. The kernels take float32, bfloat16 and float16 (the Pallas kernel
takes any float type and writes in its input's; the JAX package runs in
32-bit mode, so float64 raises here), rounding after each add and after
the division as PyTorch does. The faces kernel marches each (y, z)
column along x. Both are memory-bound: see the note in the CUDA source.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import Cost, count_launch

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}


def _six(t: torch.Tensor) -> torch.Tensor:
    # filled on the device: no host round trip, no stream sync
    return torch.full((), 6.0, dtype=t.dtype, device=t.device)


def _sweep(up: torch.Tensor) -> torch.Tensor:
    s = up[:-2, 1:-1, 1:-1] + up[2:, 1:-1, 1:-1]
    s += up[1:-1, :-2, 1:-1]
    s += up[1:-1, 2:, 1:-1]
    s += up[1:-1, 1:-1, :-2]
    s += up[1:-1, 1:-1, 2:]
    return s / _six(s)


def cost(u_pad: torch.Tensor) -> Cost:
    """One ``jacobi3d`` call's work: 6 FLOPs a point (five adds and the
    division); the padded slab read once and the interior written once."""
    x, y, z = (n - 2 for n in u_pad.shape)
    return Cost(6 * x * y * z, (u_pad.numel() + x * y * z)
                * u_pad.element_size())


def faces_cost(u: torch.Tensor, *faces: torch.Tensor) -> Cost:
    """One ``jacobi3d_faces`` call's work: 6 FLOPs a point; the chunk and
    its six faces read once, the chunk's update written once."""
    return Cost(6 * u.numel(), (2 * u.numel() + sum(f.numel() for f in faces))
                * u.element_size())


def jacobi3d_plain(u_pad: torch.Tensor) -> torch.Tensor:
    """u_pad: [X+2, Y+2, Z+2] → updated interior [X, Y, Z]."""
    return _sweep(u_pad)


def jacobi3d_faces_plain(u, lo0, hi0, lo1, hi1, lo2, hi2) -> torch.Tensor:
    """One sweep of chunk ``u`` [X, Y, Z] given its face halos (lo0/hi0
    [Y, Z], lo1/hi1 [X, Z], lo2/hi2 [X, Y]; zeros at physical
    boundaries)."""
    up = F.pad(u, (1, 1, 1, 1, 1, 1))
    up[0, 1:-1, 1:-1] = lo0
    up[-1, 1:-1, 1:-1] = hi0
    up[1:-1, 0, 1:-1] = lo1
    up[1:-1, -1, 1:-1] = hi1
    up[1:-1, 1:-1, 0] = lo2
    up[1:-1, 1:-1, -1] = hi2
    return _sweep(up)


def _check(*ts: torch.Tensor) -> str:
    """The entry points' type suffix, after checking the operands."""
    dev, dtype = ts[0].device, ts[0].dtype
    for t in ts:
        if t.device != dev or t.dtype != dtype or dtype not in _SUFFIX \
                or not t.is_contiguous():
            raise ValueError("jacobi3d kernels take contiguous float32, "
                             "bfloat16 or float16 tensors of one type on one "
                             f"device; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    return _SUFFIX[dtype]


def jacobi3d(u_pad: torch.Tensor) -> torch.Tensor:
    """u_pad: [X+2, Y+2, Z+2] → interior [X, Y, Z]."""
    if u_pad.device.type == "cpu":
        return jacobi3d_plain(u_pad)
    sfx = _check(u_pad)
    if u_pad.dim() != 3 or min(u_pad.shape) < 2:
        raise ValueError(f"jacobi3d: bad padded shape {tuple(u_pad.shape)}")
    from repro_torch.kernels import _build
    x, y, z = (n - 2 for n in u_pad.shape)
    out = torch.empty((x, y, z), dtype=u_pad.dtype, device=u_pad.device)
    lib = _build.library("jacobi3d")
    with torch.cuda.device(u_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(lib, f"jacobi3d_{sfx}")(
            u_pad.data_ptr(), out.data_ptr(), x, y, z, stream), "jacobi3d")
    count_launch("jacobi3d")
    return out


def jacobi3d_faces(u, lo0, hi0, lo1, hi1, lo2, hi2) -> torch.Tensor:
    """One sweep of chunk ``u`` given its six face halos."""
    if u.device.type == "cpu":
        return jacobi3d_faces_plain(u, lo0, hi0, lo1, hi1, lo2, hi2)
    faces = (lo0, hi0, lo1, hi1, lo2, hi2)
    sfx = _check(u, *faces)
    x, y, z = u.shape
    want = [(y, z), (y, z), (x, z), (x, z), (x, y), (x, y)]
    if [tuple(f.shape) for f in faces] != want:
        raise ValueError(f"jacobi3d_faces: faces {[tuple(f.shape) for f in faces]}"
                         f" do not fit chunk {tuple(u.shape)}")
    from repro_torch.kernels import _build
    out = torch.empty_like(u)
    lib = _build.library("jacobi3d")
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(lib, f"jacobi3d_faces_{sfx}")(
            u.data_ptr(), *(f.data_ptr() for f in faces), out.data_ptr(),
            x, y, z, stream), "jacobi3d_faces")
    count_launch("jacobi3d_faces")
    return out
