"""The CUDA build without a compiler: the ctypes signatures of
``repro_torch.kernels._build`` against the ``extern "C"`` prototypes of
``csrc/*.cu``, and the rebuild rule for headers.

A prototype and its ``argtypes`` that disagree still load and run: ctypes
then passes a pointer as a 32-bit int, or a float as an int, and the
kernel reads garbage. Nothing here needs nvcc or a card."""
import importlib.util
import os
import pathlib
import re

import pytest

from repro_torch.kernels import _build

PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
KIND = {_build.ctypes.c_void_p: "pointer", _build.ctypes.c_int: "int",
        _build.ctypes.c_float: "float"}


def _kind(param: str) -> str:
    """pointer, int or float, from a C parameter declaration."""
    if "*" in param or "cudaStream_t" in param:
        return "pointer"
    base = param.split()[-2] if len(param.split()) > 1 else param
    if base in ("int", "float"):
        return base
    raise AssertionError(f"parameter kind unknown to the test: {param!r}")


def _prototypes() -> dict:
    """{library: {entry point: [kinds]}} from every csrc/*.cu."""
    out = {}
    for cu in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", cu.read_text())
        out[cu.stem] = {name: [_kind(p.strip()) for p in params.split(",")]
                        for name, params in PROTOTYPE.findall(text)}
    return out


def test_signatures_match_the_c_prototypes():
    """Every library's entry points, in number, arity and kind, exactly as
    the sources declare them, and one library per source."""
    found = _prototypes()
    assert sorted(found) == sorted(_build.SIGNATURES)
    for lib, entries in found.items():
        assert entries, f"{lib}.cu declares no extern \"C\" entry point"
        listed = {fn: [KIND[t] for t in argtypes]
                  for fn, argtypes in _build.SIGNATURES[lib].items()}
        assert listed == entries, lib


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """A csrc with one source that includes a header; a build directory;
    the module pointed at both."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "h.cuh").write_text("#pragma once\n")
    (csrc / "unused.cuh").write_text("#pragma once\n")
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n'
                               '#include "h.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    for p in csrc.iterdir():
        os.utime(p, (100, 100))
    return csrc, build


def test_editing_an_included_header_marks_its_library_stale(tree):
    csrc, build = tree
    assert _build._stale("k")                       # never built
    lib = build / "libk.so"
    lib.write_bytes(b"")
    os.utime(lib, (200, 200))
    assert not _build._stale("k")
    os.utime(csrc / "unused.cuh", (300, 300))       # not included: no rebuild
    assert not _build._stale("k")
    os.utime(csrc / "h.cuh", (300, 300))            # included
    assert _build._stale("k")
    os.utime(lib, (400, 400))
    assert not _build._stale("k")
    os.utime(csrc / "k.cu", (500, 500))
    assert _build._stale("k")


HOPPER_HELPERS = ("mbar_init", "mbar_expect_tx", "mbar_arrive", "mbar_wait",
                  "tma_load_2d", "tma_load_4d", "wgmma_desc", "wgmma_fence",
                  "wgmma_commit", "wgmma_wait", "setmaxnreg_inc",
                  "setmaxnreg_dec", "bar_sync", "bar_arrive",
                  "tensor_map_encoder")


def test_the_sources_that_share_the_ptx_header_depend_on_it():
    """Both tensor-core sources include ``ptx.cuh`` (so editing it rebuilds
    them) and take the Hopper helpers from it: each helper is defined there
    once and in neither source, and both sources call the barrier, wgmma
    and register helpers through it."""
    for name in ("flash_attention", "matmul"):
        assert _build.CSRC / "ptx.cuh" in _build._sources(name)
    assert _build._sources("jacobi3d") == [_build.CSRC / "jacobi3d.cu"]
    header = (_build.CSRC / "ptx.cuh").read_text()
    for helper in HOPPER_HELPERS:
        defined = re.compile(rf"\b{helper}\s*\([^;{{]*\)\s*{{")
        assert len(defined.findall(header)) == 1, helper
        for name in ("flash_attention", "matmul"):
            src = (_build.CSRC / f"{name}.cu").read_text()
            assert not defined.findall(src), (name, helper)
    for name in ("flash_attention", "matmul"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        for helper in ("mbar_wait", "wgmma_desc", "wgmma_wait",
                       "setmaxnreg_inc", "tensor_map_encoder"):
            assert f"ptx::{helper}" in src, (name, helper)


def _kernel_variants():
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "kernel_variants.py"
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KERNEL_VARIANTS = _kernel_variants()


@pytest.mark.parametrize("name", sorted(KERNEL_VARIANTS.VARIANTS))
def test_kernel_variants_apply_to_the_committed_source(name):
    """``tools/kernel_variants.py`` builds each variant from the committed
    ``matmul.cu`` by text substitution: every substitution must still find
    its text exactly once, so the tool times what it names."""
    src = (_build.CSRC / "matmul.cu").read_text()
    out = KERNEL_VARIANTS.variant_source(name, src)
    assert (out == src) == (name == "committed")


@pytest.mark.parametrize("name", sorted(KERNEL_VARIANTS.FLASH_VARIANTS))
def test_flash_variants_apply_to_the_committed_source(name):
    """The earlier head-dim-256 design that ``chip_smoke.py`` times beside
    the committed kernels (``flash_attention.cu`` with the one-pass
    dispatch turned off), and the grid orders the tool times, are text
    substitutions: each finds its text exactly once."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    out = KERNEL_VARIANTS.variant_source(name, src, "flash_attention")
    assert (out == src) == (name == "committed")
    assert KERNEL_VARIANTS.library_path(name, "flash_attention").name == \
        f"libflash_attention_{name}.so"
