"""Plain reference of the Jacobi3D proxy: the 7-point stencil with zero
(Dirichlet) boundaries, u' = (sum of the six face neighbours) / 6.

Two forms of the same iteration:

``sweeps``  the iteration itself, sweep after sweep, in any float type (the
            control runs it in bfloat16);
``exact``   its closed form in float64. The update is u' = A u with
            A = (T(x)I(x)I + I(x)T(x)I + I(x)I(x)T) / 6 and T the path
            graph's adjacency (ones beside the diagonal). The sine transform
            S (DST-I, orthonormal and its own inverse) diagonalises T, with
            eigenvalues 2 cos(pi k / (n + 1)), so after t sweeps
            u_t = S S S [lambda^t * (S S S u_0)] with
            lambda_ijk = (c_i + c_j + c_k) / 3, S applied along each axis.
            Six matrix products and a power: exact to float64 rounding, and
            independent of how the sweeps are ordered or cut into chunks.

Imports nothing but torch.
"""
from __future__ import annotations

import math

import torch


def sweep(u: torch.Tensor) -> torch.Tensor:
    """One sweep of the whole domain ``u`` [X, Y, Z], zeros outside."""
    up = torch.nn.functional.pad(u, (1, 1, 1, 1, 1, 1))
    s = up[:-2, 1:-1, 1:-1] + up[2:, 1:-1, 1:-1]
    s += up[1:-1, :-2, 1:-1]
    s += up[1:-1, 2:, 1:-1]
    s += up[1:-1, 1:-1, :-2]
    s += up[1:-1, 1:-1, 2:]
    return s / torch.full((), 6.0, dtype=s.dtype, device=s.device)


def sweeps(u0: torch.Tensor, iters: int, dtype=torch.float32
           ) -> torch.Tensor:
    """``iters`` sweeps of ``u0`` computed in ``dtype``."""
    u = u0.to(dtype)
    for _ in range(iters):
        u = sweep(u)
    return u


def _sine_basis(n: int, device) -> torch.Tensor:
    k = torch.arange(1, n + 1, dtype=torch.float64, device=device)
    return math.sqrt(2.0 / (n + 1)) * torch.sin(
        math.pi * k[:, None] * k[None, :] / (n + 1))


def _along_each_axis(s: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """S applied along the three axes of ``u`` (a cube of side len(S))."""
    n = s.shape[0]
    for _ in range(3):
        # sum over the first axis and move it last: after three turns the
        # axes are back in order
        u = (s @ u.reshape(n, -1)).reshape(n, n, n).permute(1, 2, 0)
        u = u.contiguous()
    return u


def exact(u0: torch.Tensor, iters: int) -> torch.Tensor:
    """The domain after ``iters`` sweeps of a cube ``u0``, in float64."""
    n = u0.shape[0]
    if u0.shape != (n, n, n):
        raise ValueError(f"exact() takes a cube, got {tuple(u0.shape)}")
    dev = u0.device
    s = _sine_basis(n, dev)
    c = torch.cos(math.pi * torch.arange(1, n + 1, dtype=torch.float64,
                                         device=dev) / (n + 1))
    w = _along_each_axis(s, u0.to(torch.float64))
    # lambda^t plane by plane, so that no second cube of float64 is made
    for i in range(n):
        lam = (c[i] + c[:, None] + c[None, :]) / 3.0
        w[i] *= torch.pow(lam, float(iters))
    return _along_each_axis(s, w)


def max_abs_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over the domain."""
    return float((got.to(torch.float64) - want).abs().max())
