"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``) for the
Pallas TPU kernels of ``repro.kernels``, each beside its plain PyTorch
version. A CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main path
went through the kernels.
"""
import threading

LAUNCHES = {"jacobi3d": 0, "jacobi3d_faces": 0, "matmul": 0,
            "flash_attention": 0, "ssd_chunk": 0}
_launch_lock = threading.Lock()


def count_launch(name: str) -> None:
    """Add one to ``LAUNCHES[name]`` (wrappers launch from several runtime
    worker threads)."""
    with _launch_lock:
        LAUNCHES[name] += 1
