"""Tiled matrix product: the CUDA kernel (``csrc/matmul.cu``) and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``_matmul_kernel`` / ``matmul`` of
``repro/kernels/matmul.py``: ``[M, K] · [K, N]`` accumulated in float32
and cast to the input dtype, for float32 (IEEE FMA, never TF32: a
register-blocked, double-buffered SGEMM on the CUDA cores) and bfloat16
(on the tensor cores: ``wgmma`` fed by TMA, rounded once on store).
The kernel needs M and N to be multiples of 64, K of 16 and the operands
16-byte aligned, as the Pallas kernel needs its block sizes to divide the
dimensions. It is bound by operations: see the note in the CUDA source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import count_launch

BM, BN, BK = 64, 64, 16        # M, N, K multiples the kernel takes
_ENTRY = {torch.float32: "matmul_f32", torch.bfloat16: "matmul_bf16"}


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
    if a.dtype not in _ENTRY:
        raise ValueError(f"matmul: no kernel for {a.dtype}")
    if m % BM or n % BN or k % BK:
        raise ValueError(f"matmul: (M, N, K) = {(m, n, k)} must be "
                         f"multiples of {(BM, BN, BK)}")
    if not (a.is_contiguous() and b.is_contiguous()) \
            or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("matmul: operands must be contiguous and 16-byte "
                         "aligned")
    from repro_torch.kernels import _build
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    lib = _build.library("matmul")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(getattr(lib, _ENTRY[a.dtype])(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream),
            "matmul")
    count_launch("matmul")
    return out
