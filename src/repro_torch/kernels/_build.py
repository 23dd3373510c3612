"""Build and load the CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
``build/repro_torch/lib<name>.so`` under the repository root, with a plain
C interface loaded through ``ctypes``. All sources compile in parallel, at
the first call that needs a kernel, and again whenever a source, or a
header of ``csrc`` that it includes (``ptx.cuh``), is newer than its
library. Imported only when a CUDA tensor reaches a wrapper.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points of each library: name -> argtypes (all return int, the
# launch's cudaGetLastError())
SIGNATURES = {
    "jacobi3d": {
        "jacobi3d_f32": [_P, _P, _I, _I, _I, _P],
        "jacobi3d_bf16": [_P, _P, _I, _I, _I, _P],
        "jacobi3d_f16": [_P, _P, _I, _I, _I, _P],
        "jacobi3d_faces_f32": [_P] * 8 + [_I, _I, _I, _P],
        "jacobi3d_faces_bf16": [_P] * 8 + [_I, _I, _I, _P],
        "jacobi3d_faces_f16": [_P] * 8 + [_I, _I, _I, _P],
    },
    "matmul": {
        "matmul_f32": [_P, _P, _P, _I, _I, _I, _P],
        "matmul_bf16": [_P, _P, _P, _I, _I, _I, _P],
        "matmul_bf16_fma": [_P, _P, _P, _I, _I, _I, _P],
    },
    "flash_attention": {
        "flash_attention_f32": [_P] * 4 + [_I] * 7 + [_F, _P],
        "flash_attention_bf16": [_P] * 4 + [_I] * 7 + [_F, _P],
    },
    "decode_attention": {
        "decode_attention_bf16": [_P] * 7 + [_I] * 10 + [_F, _P],
    },
    "moe_experts": {
        "moe_experts_bf16": [_P] * 9 + [_I] * 7 + [_P],
        "moe_combine_bf16": [_P] * 4 + [_I] * 3 + [_P],
        "moe_plan": [_P] * 4 + [_I] * 4 + [_P],
    },
    "ssd": {
        "ssd_chunk_f32": [_P] * 8 + [_I] * 5 + [_P],
        "ssd_workspace_floats": [_I, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per library: (seconds nvcc took, its output), for the last build
BUILD_LOG: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and the headers of ``csrc`` it includes by a
    quoted name."""
    cu = CSRC / f"{name}.cu"
    return [cu] + [CSRC / h for h in _INCLUDE.findall(cu.read_text())]


def _stale(name: str) -> bool:
    lib = BUILD_DIR / f"lib{name}.so"
    return not lib.exists() or any(
        lib.stat().st_mtime < src.stat().st_mtime for src in _sources(name))


def build_all() -> Dict[str, tuple]:
    """Compile every stale library, all ``nvcc`` processes at once; raise
    with the compiler's output if one fails. Returns ``BUILD_LOG``."""
    todo = [n for n in SIGNATURES if _stale(n)]
    if not todo:
        return BUILD_LOG
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {n: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(BUILD_DIR / f"lib{n}.so"),
         str(CSRC / f"{n}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n in todo}
    failed = []
    for n, p in procs.items():
        out, _ = p.communicate()
        BUILD_LOG[n] = (time.perf_counter() - t0, out)
        if p.returncode != 0:
            failed.append(f"nvcc {n}.cu exited {p.returncode}:\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
