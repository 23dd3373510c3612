#!/usr/bin/env python3
"""Time design variants of the bf16 matmul kernel, or of the head-dim-256
flash kernels, on one CUDA card.

    python3 tools/kernel_variants.py [--reps 50] [--rounds 3]
    python3 tools/kernel_variants.py --source flash_attention [--rounds 3]

Each variant is ``src/repro_torch/csrc/matmul.cu`` with named text
substitutions (``VARIANTS``), compiled by nvcc with the port's flags into
``build/variants/libmatmul_<name>.so`` beside the committed source. Every
variant is held against ``matmul_plain`` at three shapes, then all, the
wrapper ``ops.matmul`` and ``torch.matmul`` are timed at 4096^3 in turns
(CUDA events, the mean of ``--reps`` calls, ``--rounds`` times). Prints the
card's name and power limit, whether ptxas reported serialised wgmma
products (C7515, C7520, ...) for each variant, and one JSON object. Needs
a card and nvcc; exits non-zero without them or on any mismatch.

``FLASH_VARIANTS`` are the same for ``csrc/flash_attention.cu``, built
into ``build/variants/libflash_attention_<name>.so``: the earlier design
of heads 128 < D <= 256 (``column_groups``, which ``chip_smoke.py`` builds
and times beside the committed kernels) and two other grid orders of the
bf16 one-pass kernel. With ``--source flash_attention`` each is held
against ``flash_attention_plain`` at a ragged shape and at the two bf16
layouts of ``FLASH_LAYOUTS``, then timed at both layouts in turns
(``--reps`` calls a time, the order of the variants reversed every other
round).
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
# the same for flash_attention.cu
FLASH_VARIANTS = {
    "committed": [],
    # heads of 128 < D <= 256 through the column-group kernels, as before
    # the one-pass kernels: one 128-wide output column group a block, the
    # full-D scores recomputed for each group in 64-wide chunks
    "column_groups": [
        ("const bool one_pass = D > kMaxD && D <= kFullD && D % 4 == 0;",
         "const bool one_pass = false;"),
        ("const bool one_pass = D > kMaxD && D <= kFullD && D % 8 == 0;",
         "const bool one_pass = false;")],
    # the wgmma kernel's q tiles in z, as the D <= 128 kernels order them,
    # instead of beside the query heads in x
    "q_tiles_in_z": [
        ("  const int g = blockIdx.x % G;\n",
         "  const int g = blockIdx.x;\n"),
        ("  const int q0 = (gridDim.x / G - 1 - blockIdx.x / G) * kGBM;",
         "  const int q0 = (gridDim.z - 1 - blockIdx.z) * kGBM;"),
        ("  const dim3 grid(G * ((S + kGBM - 1) / kGBM), B * KH);",
         "  const dim3 grid(G, B * KH, (S + kGBM - 1) / kGBM);")],
    # the wgmma kernel's shortest causal rows first instead of the longest
    "light_first": [
        ("  const int q0 = (gridDim.x / G - 1 - blockIdx.x / G) * kGBM;",
         "  const int q0 = (blockIdx.x / G) * kGBM;")],
}
# (b, s, kh, g, d) of the bf16 one-pass kernel's timed layouts, causal:
# yi-9b's heads at D = 256, and recurrentgemma-9b's (MQA, 16 query heads
# on one KV head; its window of 2048 is the whole sequence here)
FLASH_LAYOUTS = {"kh4_g8": (4, 2048, 4, 8, 256),
                 "kh1_g16": (4, 2048, 1, 16, 256)}
SOURCES = {"matmul": VARIANTS, "flash_attention": FLASH_VARIANTS}


def variant_source(name: str, src: str, source: str = "matmul") -> str:
    """The committed ``<source>.cu`` text ``src`` with variant ``name``'s
    substitutions; raises if one no longer applies."""
    for old, new in SOURCES[source][name]:
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} found "
                             f"{src.count(old)} times in {source}.cu")
        src = src.replace(old, new)
    return src


def library_path(name: str, source: str = "matmul") -> pathlib.Path:
    return OUT / f"lib{source}_{name}.so"


def start_build(names, source: str = "matmul") -> dict:
    """Start one nvcc per variant of ``<source>.cu``, all at once; returns
    the processes by name (``finish_build`` waits for them)."""
    from repro_torch.kernels import _build
    csrc = _build.CSRC
    src = (csrc / f"{source}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name, source)
        cu = lib.with_name(lib.stem[3:] + ".cu")
        cu.write_text(variant_source(name, src, source))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def finish_build(procs) -> dict:
    """Wait for ``start_build``'s processes; raise if one failed. Returns
    each variant's ptxas output by name."""
    logs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: exit {proc.returncode}\n{out}")
        logs[name] = out
    return logs


def build(names, source: str = "matmul") -> dict:
    """Build the variants; whether ptxas serialised wgmma products (its
    C7515, C7520, ...) in each."""
    return {name: "wgmma.mma_async instructions are serialized" in out
            for name, out in finish_build(start_build(names, source)).items()}


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


def load(name: str, source: str):
    """The variant's library with the ctypes signatures of ``source``."""
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(library_path(name, source)))
    for fn, argtypes in _build.SIGNATURES[source].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def flash_call(lib, q, k, v, causal: bool = True):
    """A variant library's flash entry on q [B, S, KH, G, D] or [BH, S,
    D]; launched outside the port's wrappers, so it counts no launch."""
    import torch
    from repro_torch.kernels import _build
    if q.dim() == 3:
        (b, s, d), kh, g = q.shape, 1, 1
    else:
        b, s, kh, g, d = q.shape
    out = torch.empty_like(q)
    entry = {torch.bfloat16: "flash_attention_bf16",
             torch.float32: "flash_attention_f32"}[q.dtype]
    _build.check(getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
        k.shape[1], kh, g, d, int(causal), d ** -0.5,
        torch.cuda.current_stream().cuda_stream), entry)
    return out


def flash_main(args) -> int:
    import torch
    from repro_torch.kernels import ops
    serialised = build(FLASH_VARIANTS, "flash_attention")
    libs = {name: load(name, "flash_attention") for name in FLASH_VARIANTS}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(b, s, kh, g, d):
        q = torch.randn((b, s, kh, g, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, s, kh, d), generator=gen, device="cuda")
                for _ in range(2))
        return tuple(x.bfloat16() for x in (q, k, v))

    cases = {"s200_g8_d192": qkv(1, 200, 2, 8, 192)}
    cases.update((key, qkv(*shape)) for key, shape in FLASH_LAYOUTS.items())
    res = {"wgmma_serialised": serialised, "max_abs_err": {}, "ms": {}}
    for case, (q, k, v) in cases.items():
        want = ops.flash_attention_plain(q, k, v).float()
        for name, lib in libs.items():
            got = flash_call(lib, q, k, v).float()
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=2e-2, atol=2e-2):
                print(f"kernel_variants: {name} at {case} disagrees with "
                      f"flash_attention_plain", file=sys.stderr)
                return 1
            res["max_abs_err"][f"{name}@{case}"] = \
                (got - want).abs().max().item()
        del want
    for rnd in range(args.rounds):
        for case in FLASH_LAYOUTS:
            names = list(libs) if rnd % 2 == 0 else list(libs)[::-1]
            for name in names:
                res["ms"].setdefault(f"{name}@{case}", []).append(mean_ms(
                    lambda lib=libs[name]: flash_call(lib, *cases[case]),
                    args.reps))
    print(json.dumps(res))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--source", choices=sorted(SOURCES), default="matmul")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    if args.source == "flash_attention":
        return flash_main(args)
    serialised = build(VARIANTS)
    fns = {name: load(name, "matmul").matmul_bf16 for name in VARIANTS}
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"wgmma_serialised": serialised, "max_abs_err": {}, "ms": {}}
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
