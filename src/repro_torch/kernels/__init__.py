"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``) for the
Pallas TPU kernels of ``repro.kernels``, and two that replace none (decode
attention against the KV cache, a mixture-of-experts layer's routed
experts), each beside its plain PyTorch version. A
CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels. A kernel captured into a CUDA graph runs at each
replay and not at the capture: ``recording_launches`` diverts the counts of
a capture, and ``add_launches`` adds them at each replay.

Each kernel module also has a ``cost(...)``: the operations and HBM bytes
of one call at its operands' shapes (each input read once, each output
written once), which ``chip_smoke.py`` bounds a kernel's time by and the
dry-run's counter (``repro_torch.opcount``) adds per launch. A ``meta``
tensor takes the card's route through the model's kernels (flash
attention, decode attention, SSD, the routed experts) without launching: the wrapper returns
empty outputs of the kernel's shapes and records the launch and its cost
with the active counter only.
"""
import contextlib
import threading
from typing import NamedTuple

import torch

LAUNCHES = {"jacobi3d": 0, "jacobi3d_faces": 0, "matmul": 0,
            "flash_attention": 0, "ssd_chunk": 0, "decode_attention": 0,
            "moe_plan": 0, "moe_experts": 0, "moe_combine": 0}
_launch_lock = threading.Lock()
_capturing = threading.local()


class Cost(NamedTuple):
    """One call's work: FLOPs and HBM bytes."""
    flops: int
    bytes: int


def aligned16(t: torch.Tensor) -> bool:
    """Whether ``t`` starts on a 16-byte boundary of its storage. Every
    storage starts on one (the caching allocator's blocks are 512-byte
    aligned), so this is the card's ``data_ptr() % 16 == 0`` and answers
    the same for a ``meta`` tensor, whose ``data_ptr()`` is 0."""
    return t.storage_offset() * t.element_size() % 16 == 0


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]`` (wrappers launch from several runtime
    worker threads), or to the counts of this thread's capture."""
    counts = getattr(_capturing, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1
        return
    with _launch_lock:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's launches count into the dict it
    yields instead of ``LAUNCHES``."""
    prev = getattr(_capturing, "counts", None)
    counts: dict = {}
    _capturing.counts = counts
    try:
        yield counts
    finally:
        _capturing.counts = prev


def add_launches(counts: dict) -> None:
    """Add recorded launches to ``LAUNCHES`` (one replay of a capture)."""
    with _launch_lock:
        for name, n in counts.items():
            LAUNCHES[name] += n
