"""Public wrappers for the hand-written kernels.

A CPU tensor runs the kernel's plain PyTorch version; a CUDA tensor
launches the CUDA kernel (built at first use) or raises. ``LAUNCHES``
counts the kernel launches of each wrapper.
"""
from __future__ import annotations

from repro_torch.kernels import LAUNCHES  # noqa: F401
from repro_torch.kernels.decode_attention import (  # noqa: F401
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: F401
    flash_attention, flash_attention_gqa, flash_attention_plain)
from repro_torch.kernels.jacobi3d import (jacobi3d,  # noqa: F401
                                          jacobi3d_faces,
                                          jacobi3d_faces_plain,
                                          jacobi3d_plain)
from repro_torch.kernels.matmul import matmul, matmul_plain  # noqa: F401
from repro_torch.kernels.moe_experts import (  # noqa: F401
    moe_combine, moe_combine_plain, moe_experts, moe_experts_plain,
    routed_plan, routed_plan_plain)
from repro_torch.kernels.ssd import ssd_chunk, ssd_chunk_plain  # noqa: F401
