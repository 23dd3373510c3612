"""Tiled matrix product: the CUDA kernel (``csrc/matmul.cu``) and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``_matmul_kernel`` / ``matmul`` of
``repro/kernels/matmul.py``: ``[M, K] · [K, N]`` accumulated in float32
and cast to the input dtype, for float32 (IEEE FMA, never TF32: a
register-blocked, double-buffered SGEMM on the CUDA cores) and bfloat16
(on the tensor cores: ``wgmma`` fed by TMA, rounded once on store).

Any M, N and K run on the card, a superset of what the Pallas kernel takes
(dims up to 128, or multiples of 128); operands must be contiguous and
16-byte aligned. The arm follows from dtype and shape:

  * float32: ``matmul_f32``, the SGEMM; M, N multiples of 64 and K of 16
    take its 16-byte loads, any other shape the same loop with edge-safe
    element loads (zeros past the edges, the same bits inside);
  * bfloat16 with K and N multiples of 8: ``matmul_bf16``, on the tensor
    cores (TMA needs 16-byte row strides);
  * bfloat16 otherwise: ``matmul_bf16_fma``, the SGEMM with bf16 loads,
    converted to float, FMA in float32, rounded once on store.

All arms count under ``LAUNCHES["matmul"]``. The kernels are bound by
operations: see the note in the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import Cost, count_launch

_DTYPES = (torch.float32, torch.bfloat16)


def _entry(dtype: torch.dtype, k: int, n: int) -> str:
    """The C entry point (the arm) for this dtype and shape."""
    if dtype == torch.float32:
        return "matmul_f32"
    return "matmul_bf16" if k % 8 == 0 and n % 8 == 0 else "matmul_bf16_fma"


def cost(a: torch.Tensor, b: torch.Tensor) -> Cost:
    """One call's work: 2·M·N·K FLOPs; a and b read once, the [M, N]
    product written once."""
    m, k = a.shape
    n = b.shape[1]
    return Cost(2 * m * n * k, (m * k + k * n + m * n) * a.element_size())


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: float32 product, cast back."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [M, K] · b: [K, N] → [M, N] in a's dtype."""
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    m, k = a.shape
    k2, n = b.shape
    if k != k2 or a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"matmul: {a.dtype}{tuple(a.shape)} on {a.device} "
                         f"· {b.dtype}{tuple(b.shape)} on {b.device}")
    if a.dtype not in _DTYPES:
        raise ValueError(f"matmul: no kernel for {a.dtype}")
    if min(m, n, k) <= 0:
        raise ValueError(f"matmul: empty operand, (M, N, K) = {(m, n, k)}")
    if not (a.is_contiguous() and b.is_contiguous()) \
            or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("matmul: operands must be contiguous and 16-byte "
                         "aligned")
    from repro_torch.kernels import _build
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.library("matmul")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(lib, _entry(a.dtype, k, n))(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream),
            "matmul")
    count_launch("matmul")
    return out
