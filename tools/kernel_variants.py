#!/usr/bin/env python3
"""Time design variants of the bf16 matmul kernel on one CUDA card.

    python3 tools/kernel_variants.py [--reps 50] [--rounds 3]

Each variant is ``src/repro_torch/csrc/matmul.cu`` with named text
substitutions (``VARIANTS``), compiled by nvcc with the port's flags into
``build/variants/lib<name>.so`` beside the committed source. Every variant
is held against ``matmul_plain`` at three shapes, then all of them, the
wrapper ``ops.matmul`` and ``torch.matmul`` are timed at 4096^3 in turns
(CUDA events, the mean of ``--reps`` calls, ``--rounds`` times). Prints the
card's name and power limit, whether ptxas reported serialised wgmma
products (C7515) for each variant, and one JSON object. Needs a card and
nvcc; exits non-zero without them or on any mismatch.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "variants"
SHAPES = ((4096, 4096, 4096), (192, 48, 320), (320, 1040, 192))
# name -> [(text in matmul.cu, replacement)]
VARIANTS = {
    "committed": [],
    # a block per output tile instead of one block per SM walking tiles
    "block_per_tile": [("hgemm_wgmma_kernel<<<min(tiles, sms), kHThreads",
                        "hgemm_wgmma_kernel<<<tiles, kHThreads")],
    # three ring slots instead of four
    "three_slots": [("constexpr int kHStages = 4;",
                     "constexpr int kHStages = 3;")],
    # accumulators zeroed by instructions at each tile, every step
    # accumulating, instead of the first step's scale-d = 0
    "zeroed_accumulators": [
        ("    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n"
         "      for (int kt = 0; kt < nk; ++kt, ++it) {\n"
         "        const int s = it % kHStages;",
         "    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n"
         "#pragma unroll\n"
         "      for (int i = 0; i < kHBN / 2; ++i) acc[i] = 0.f;\n"
         "      for (int kt = 0; kt < nk; ++kt, ++it) {\n"
         "        const int s = it % kHStages;"),
        ("              kt > 0 || kk > 0);", "              1);")],
}


def variant_source(name: str, src: str) -> str:
    """The committed source with variant ``name``'s substitutions; raises
    if one no longer applies."""
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} found "
                             f"{src.count(old)} times in matmul.cu")
        src = src.replace(old, new)
    return src


def build(names) -> dict:
    from repro_torch.kernels import _build
    csrc = _build.CSRC
    src = (csrc / "matmul.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(variant_source(name, src))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    serialised = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: exit {proc.returncode}\n{out}")
        serialised[name] = "C7515" in out
    return serialised


def mean_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    serialised = build(VARIANTS)
    fns = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        lib.matmul_bf16.argtypes = _build.SIGNATURES["matmul"]["matmul_bf16"]
        lib.matmul_bf16.restype = ctypes.c_int
        fns[name] = lib.matmul_bf16
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"c7515": serialised, "max_abs_err": {}, "ms": {}}
    for m, k, n in SHAPES:
        a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        want = ops.matmul_plain(a, b).float()
        for name, fn in fns.items():
            c = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, stream)
            torch.cuda.synchronize()
            ok = rc == 0 and bool(torch.allclose(c.float(), want, rtol=2e-2,
                                                 atol=2e-2))
            if not ok:
                print(f"kernel_variants: {name} at {(m, k, n)} rc={rc} "
                      f"disagrees with matmul_plain", file=sys.stderr)
                return 1
            res["max_abs_err"][f"{name}@{m}x{k}x{n}"] = \
                (c.float() - want).abs().max().item()
    m = k = n = 4096
    a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
    c = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    calls = {"torch.matmul": lambda: torch.matmul(a, b),
             "ops.matmul": lambda: ops.matmul(a, b)}
    for name, fn in fns.items():
        calls[name] = (lambda fn=fn: fn(a.data_ptr(), b.data_ptr(),
                                        c.data_ptr(), m, n, k, stream))
    for _ in range(args.rounds):
        for name, call in calls.items():
            res["ms"].setdefault(name, []).append(mean_ms(call, args.reps))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
