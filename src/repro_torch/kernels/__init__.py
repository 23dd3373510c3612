"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``) for the
Pallas TPU kernels of ``repro.kernels``, each beside its plain PyTorch
version. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels. A kernel captured into a CUDA graph runs at each
replay and not at the capture: ``recording_launches`` diverts the counts of
a capture, and ``add_launches`` adds them at each replay.
"""
import contextlib
import threading

LAUNCHES = {"jacobi3d": 0, "jacobi3d_faces": 0, "matmul": 0,
            "flash_attention": 0, "ssd_chunk": 0}
_launch_lock = threading.Lock()
_capturing = threading.local()


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
