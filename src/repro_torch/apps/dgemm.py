"""The paper's Fig. 3 double DGEMM on the tasking runtime (the port of
``examples/quickstart.py``): ``D = (A · B) · B``, two tasks whose
dependency through ``C`` the runtime infers. Each task computes
``kernels.ops.matmul``, the hand-written CUDA kernel on a card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core import HeteroTask, Runtime
from repro_torch.kernels import ops


def dgemm(a, b, c):
    """Device-independent task kernel: C = A · B (C is write-only)."""
    return ops.matmul(a, b)


def run_double_dgemm(rt: Runtime, n: int,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """Run ``D = (A · B) · B`` on ``rt`` for float32 ``A``, ``B`` of shape
    ``(n, n)`` drawn uniform in [0, 1) from ``seed``. Returns (A, B, D)."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, n), dtype=np.float32)
    b = rng.random((n, n), dtype=np.float32)
    A = rt.hetero_object(a)
    B = rt.hetero_object(b)
    C = rt.hetero_object(shape=(n, n), dtype=np.float32)
    D = rt.hetero_object(shape=(n, n), dtype=np.float32)

    # chained task API, like the paper's listing
    t1 = HeteroTask("dgemm1")
    t1.arg(A).read()
    t1.arg(B).read()
    t1.arg(C).write()
    t1.set_threads((32, 32, 1), (32, 32, 1))   # advisory
    t1.device(rt.devices[0].info.device_type)  # a device TYPE, not an id
    rt.submit(t1, dgemm)

    # second DGEMM depends on the first through C — inferred implicitly
    t2 = HeteroTask("dgemm2")
    t2.arg(C).read()
    t2.arg(B).read()
    t2.arg(D).write()
    rt.submit(t2, dgemm)

    rt.barrier()
    return a, b, D.get()

