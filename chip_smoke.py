"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/csrc`` with nvcc (sm_90a) into
``build/repro_torch/``, holds every kernel against its plain PyTorch
version on the card at the shapes the main path gives it and at the other
inputs the Pallas entry points take (ragged matmul and flash shapes, the
Jacobi stencil in bf16 and f16, SSD chunks past 256 rows and heads whose
A is positive; the SSD kernel's time split by its launches), then drives
the port's main path through the tasking runtime:

  * the Fig. 3 double DGEMM at n = 4096 float32 (two ``matmul`` launches);
  * the over-decomposed Jacobi3D proxy on a 768^3 float32 domain, 8 chunks
    of 384^3, 10 iterations (80 ``jacobi3d_faces`` launches), which must
    equal the plain PyTorch ``run_reference`` on the card bit for bit; then
    the same under ``trace_graphs``, its sweeps from the fourth on replayed
    as one CUDA graph, equal to both bit for bit, with its steady sweeps'
    time and device idle share beside the interpreted run's;
  * dense-LM serving of yi-9b at full width and depth (48 layers, bf16
    weights from a seed): the ``Engine`` prefills 4 prompts of 2048 tokens
    (48 ``flash_attention`` launches) and decodes 32 steps; the prefill
    must match the plain attention path, the greedy tokens the argmax of a
    full forward, and ``tasked_decode_loop`` through the runtime the
    Engine's tokens and KV cache, interpreted and replayed as CUDA graphs
    (ms per step of each, the device idle share of 4 replayed steps);
  * Mamba-2 serving of mamba2-370m at full width and depth (48 SSD layers,
    bf16 weights from a seed): the ``Engine`` prefills 8 prompts of 4096
    tokens (48 ``ssd_chunk`` launches, 16 chunks each) and decodes 32
    steps with the constant-size recurrent state; the same checks as
    yi-9b's, on the conv and state caches;
  * the distributed Jacobi3D proxy (``run_cluster``) at 768^3 over four
    ranks of the message engine that share the card, 10 iterations (40
    ``jacobi3d_faces`` launches), equal to ``run_reference`` bit for bit,
    with each rank's DIRECT and staged bytes; and ``Rank.send`` latency
    between two ranks at 8 B, 64 KB and 64 MB over both paths.

Launch counters are zeroed just before each main-path run and read just
after. The second-to-last line is a JSON object with one entry per kernel of
the main path; the last line is the device summary. Exits non-zero, and
prints no result, on any failure or where there is no CUDA device.
"""
from __future__ import annotations

import functools
import gc
import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

SEED = 0
JACOBI_N, JACOBI_OD, JACOBI_ITERS = 768, 8, 10
DGEMM_N = 4096
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = "yi-9b", 4, 2048, 32
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_STEPS = "mamba2-370m", 8, 4096, 32
# ssd_chunk shapes (bc, q, h, p, n) checked in phase 2: the mamba2 prefill's
# (8 requests x 16 chunks), the mamba2 smoke config's, the three of
# tests/test_kernels.py, a ragged chunk (a prompt shorter than 256), and
# shapes past the first design's limits (q 512, p 128, n 256; ragged q, p
# and n)
SSD_MAIN = (SSM_BATCH * SSM_PROMPT // 256, 256, 32, 64, 128)
SSD_SHAPES = (SSD_MAIN, (4, 16, 4, 32, 16), (2, 16, 4, 8, 16),
              (1, 32, 2, 16, 8), (4, 8, 8, 4, 4), (8, 100, 32, 64, 128),
              (2, 512, 4, 128, 256), (3, 100, 5, 96, 200))
# a model-like ssd_chunk case whose A is positive on every other head: cs
# increases there, so those heads take the kernel's direct form off the
# diagonal
SSD_MIXED = (16, 256, 8, 64, 128)
# matmul shapes (m, k, n) checked in phase 2 in float32 and bf16: the
# DGEMM's; one whose N is not a multiple of the float32 kernel's 128-wide
# tile and whose K (48) ends inside the bf16 kernel's first 64-deep step;
# and one with M, N and K distinct whose tiles overhang the bf16 kernel's
# 128 x 256 output tile on both sides (a transposed or misdescribed B
# operand cannot pass it)
MATMUL_SHAPES = ((DGEMM_N,) * 3, (192, 48, 320), (320, 1040, 192))
# shapes the Pallas kernel takes as one block (dims up to 128) that are not
# multiples of the card tiles: the SGEMM's edge-safe loads, and in bf16 the
# FMA arm where K = 12 gives rows TMA cannot describe
MATMUL_RAGGED = ((100, 64, 64), (32, 16, 32), (96, 12, 40))
# flash_attention_gqa shapes (b, s, t, kh, g, d, causal) checked in phase 2
# in bf16 and float32 beside the main ones: head dims below, between and at
# the kernels' two compiled widths (8 and 12 load element by element in
# bf16) and past them (160, 256: the column-group kernels), S != T with and
# without the mask, one and eight query heads a KV head
FLASH_SHAPES = tuple((2, s, t, 2, g, d, causal)
                     for d in (8, 12, 64, 128, 160, 256)
                     for s, t, causal in ((128, 192, True), (192, 128, False))
                     for g in (1, 8)) + tuple(
    # S and T the Pallas kernel takes as one block, not multiples of 64
    (2, s, t, 2, 4, 64, causal)
    for s, t, causal in ((32, 32, True), (96, 96, True), (96, 128, False)))
# Jacobi shapes (interior x, y, z) checked in bf16 and f16 beside the main
# ones: a small ragged one (both entry points) and the proxy's chunk
JACOBI_HALF_SHAPES = ((70, 33, 65), (JACOBI_N // 2,) * 3)
# Tolerances, each against a plain PyTorch version on the card:
#  - flash kernel output: 2e-2 absolute and relative in bf16. Kernel and
#    plain walk the same 64-wide kv tiles; only the float32 sum order
#    inside a dot product differs, which can flip the bf16 rounding of p or
#    of the output: a few bf16 ulps (2^-8 = 3.9e-3 relative) on outputs
#    below 2. In float32, 1e-4: the same sums in another order, on
#    outputs below 1 (float32 ulps there are below 1.2e-7).
#  - prefill hidden state, kernel on vs off (plain blockwise path, 512
#    blocks), relative L2 error. In bf16, 5e-2: the paths round p to bf16
#    after different running maxima (64- against 512-wide blocks), and 48
#    random layers grow that to about 2e-2. So the same prefill also runs
#    with float32 weights, where the kernel must sit within 1e-4 of the
#    plain path (rounding of the sum order only).
#  - greedy decode vs argmax of a full forward: at least 90% agreement.
#    Random weights give near-ties among 64000 logits, which bf16 noise
#    between the decode and the full-forward attention paths can flip.
FLASH_TOL = {"f32": 1e-4, "bf16": 2e-2}
PREFILL_REL_TOL = {"bf16": 5e-2, "f32": 1e-4}
#  - ssd_chunk output: largest difference at most 1e-4 of the output's
#    largest magnitude. Kernel and plain version share cs (a float64 scan
#    rounded to float32); only the float32 sum order of the products
#    differs.
#  - mamba2 prefill hidden state, ssd kernel on vs off (the einsum path),
#    relative L2: 1e-4 with float32 weights (sum order of the intra-chunk
#    products only). In bf16, 5e-2: both paths compute the scan in float32
#    but round its output to bf16, so a sum-order difference can flip a
#    bf16 rounding that 48 random layers then carry forward.
SSD_TOL = 1e-4
SSM_PREFILL_REL_TOL = {"bf16": 5e-2, "f32": 1e-4}
GREEDY_MIN_AGREEMENT = 0.9
GREEDY_MAX_SHORTFALL = 0.25

# Published peaks (NVIDIA data sheets, dense): float32 outside the tensor
# cores, bf16 tensor cores, HBM bandwidth. Matched on the name nvidia-smi
# gives; the SXM part is the default H100.
PEAKS = {  # name fragment: (fp32 FLOP/s, bf16 FLOP/s, bytes/s)
    "H100 PCIe": (51.2e12, 756e12, 2.0e12),
    "H100 NVL": (60e12, 835e12, 3.9e12),
    "H100": (67e12, 989e12, 3.35e12),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def peaks(name: str):
    for frag, p in PEAKS.items():
        if frag in name:
            return frag, p
    raise SmokeFailure(f"no published peaks for card {name!r}")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
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


def bound(nbytes: float, nops: float, op_rate: float, mem_rate: float):
    """Least time (ms) for the work, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stencil_weight(device) -> torch.Tensor:
    """conv3d weight of the 7-point stencil: 1/6 on the six face
    neighbours (the library yardstick for the Jacobi kernels)."""
    w = torch.zeros((1, 1, 3, 3, 3), device=device)
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        w[(0, 0) + idx] = 1.0 / 6.0
    return w


def sweep_trace(run_tasked, Runtime, RuntimeConfig, u0,
                traced: bool = False) -> dict:
    """A traced run of the Jacobi main path (``traced``: under
    ``trace_graphs``): where its sweeps' time goes on the device. The
    sweeps span from the first stencil kernel's start to the last one's
    end; inside it, the device is busy for the union of all its kernels
    and copies. The steady sweeps are sweeps 5 to 10, which a traced run
    replays from its captured graph: their time is the interval between
    the first stencil kernels of sweeps 5 and 10, over 5."""
    from torch.profiler import ProfilerActivity, profile
    rt = Runtime(RuntimeConfig(trace_graphs=traced))
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_tasked(u0, JACOBI_ITERS, rt, over_decomposition=JACOBI_OD)
            wall_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    stencil = sorted((a, b) for n, a, b in dev if "jacobi3d_faces" in n)
    if len(stencil) != JACOBI_OD * JACOBI_ITERS:
        return {"wall_s": wall_s, "device_trace": "not measured",
                "stencil_kernels_traced": len(stencil)}
    lo, hi = stencil[0][0], max(b for _, b in stencil)
    busy = _busy_us(dev, lo, hi)
    span_ms = (hi - lo) / 1e3
    s_lo, s_hi = stencil[4 * JACOBI_OD][0], stencil[9 * JACOBI_OD][0]
    s_busy = _busy_us(dev, s_lo, s_hi)
    return {"wall_s": wall_s, "sweeps_span_ms": span_ms,
            "ms_per_sweep": span_ms / (JACOBI_ITERS - 1),
            "steady_ms_per_sweep": (s_hi - s_lo) / 1e3 / 5,
            "steady_device_idle_share": 1.0 - s_busy / (s_hi - s_lo),
            "stencil_kernel_ms": sum(b - a for a, b in stencil) / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (hi - lo),
            "by_name_ms": {k: round(v, 3) for k, v in sorted(
                _by_name(dev, lo, hi).items(), key=lambda kv: -kv[1])[:6]}}


def _busy_us(dev, lo, hi) -> float:
    """Length of the union of the device intervals, clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for _, a, b in sorted(dev, key=lambda x: x[1]):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy, end = busy + b - a, b
    return busy


def _by_name(dev, lo, hi) -> dict:
    out: dict = {}
    for n, a, b in dev:
        if b > lo and a < hi:
            key = "jacobi3d_faces" if "jacobi3d_faces" in n else n[:40]
            out[key] = out.get(key, 0.0) + (b - a) / 1e3
    return out


def kernel_checks(ops, gen, fp32, bf16, mem_rate) -> dict:
    """Phase 2: each kernel against its plain version at main-path shapes.
    Returns the per-kernel numbers for the JSON line."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    res = {}

    # jacobi3d (padded contract) on a 770^3 slab: must equal the plain
    # version, and both must equal a true float32 division of the sum
    n = JACOBI_N
    u_pad = torch.randn((n + 2,) * 3, generator=gen, device=dev)
    got = ops.jacobi3d(u_pad)
    plain = ops.jacobi3d_plain(u_pad)
    s = u_pad[:-2, 1:-1, 1:-1] + u_pad[2:, 1:-1, 1:-1]
    for sl in ((slice(1, -1), slice(None, -2), slice(1, -1)),
               (slice(1, -1), slice(2, None), slice(1, -1)),
               (slice(1, -1), slice(1, -1), slice(None, -2)),
               (slice(1, -1), slice(1, -1), slice(2, None))):
        s += u_pad[sl]
    true_div = (s.double() / 6.0).float()   # correctly rounded s / 6
    del s
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    check(torch.equal(got, plain), f"jacobi3d != plain (max err {err})")
    plain_true = bool(torch.equal(plain, true_div))
    del true_div, plain
    w = stencil_weight(dev)
    lib_out = F.conv3d(u_pad[None, None], w)[0, 0]
    lib_err = (lib_out - got).abs().max().item()
    del lib_out, got
    nb = 4 * ((n + 2) ** 3 + n ** 3)
    b_ms, b_by = bound(nb, 6 * n ** 3, fp32, mem_rate)
    res["jacobi3d"] = dict(
        shape=[n + 2] * 3, max_abs_err=err, tol=0.0,
        ms=time_ms(lambda: ops.jacobi3d(u_pad), 10),
        plain_ms=time_ms(lambda: ops.jacobi3d_plain(u_pad), 3),
        library_ms=time_ms(lambda: F.conv3d(u_pad[None, None], w), 3),
        library_max_abs_err=lib_err, plain_is_true_division=plain_true,
        bound_ms=b_ms, bound_by=b_by)
    del u_pad

    # jacobi3d_faces on one 384^3 chunk with random face halos
    c = n // 2
    u = torch.randn((c,) * 3, generator=gen, device=dev)
    faces = [torch.randn(shape, generator=gen, device=dev)
             for shape in ((c, c),) * 6]
    got = ops.jacobi3d_faces(u, *faces)
    plain = ops.jacobi3d_faces_plain(u, *faces)
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    check(torch.equal(got, plain), f"jacobi3d_faces != plain (max err {err})")
    up = F.pad(u, (1,) * 6)
    nb = 4 * (2 * c ** 3 + 6 * c * c)
    b_ms, b_by = bound(nb, 6 * c ** 3, fp32, mem_rate)
    res["jacobi3d_faces"] = dict(
        shape=[c] * 3, max_abs_err=err, tol=0.0,
        ms=time_ms(lambda: ops.jacobi3d_faces(u, *faces), 20),
        plain_ms=time_ms(lambda: ops.jacobi3d_faces_plain(u, *faces), 5),
        library_ms=time_ms(lambda: F.conv3d(up[None, None], w), 5),
        bound_ms=b_ms, bound_by=b_by)
    del u, faces, up, got, plain

    # matmul at MATMUL_SHAPES, float32 (the main path) and bf16; timed at
    # the DGEMM's 4096^3, the bf16 arm (0.2 ms) over 50 calls so that no
    # one call's host time sets the mean
    for dtype, tol, rate, key, reps in (
            (torch.float32, 1e-3, fp32, "matmul", 5),
            (torch.bfloat16, 2e-2, bf16, "matmul_bf16", 50)):
        errs = {}
        for m, k, n in MATMUL_SHAPES:
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            got = ops.matmul(a, b).float()
            want = ops.matmul_plain(a, b).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
                  f"{key} {(m, k, n)} outside {tol} of plain (max err {err})")
            errs[f"{m}x{k}x{n}"] = err
            if (m, k, n) == MATMUL_SHAPES[0]:
                main = (a, b)
            del a, b, got, want
        a, b = main
        m = DGEMM_N
        b_ms, b_by = bound(3 * m * m * a.element_size(), 2 * m ** 3, rate,
                           mem_rate)
        res[key] = dict(
            shape=[m, m, m], dtype=str(dtype),
            max_abs_err=errs[f"{m}x{m}x{m}"], tol=tol,
            max_abs_err_by_shape=dict(errs),
            ms=time_ms(functools.partial(ops.matmul, a, b), reps),
            plain_ms=time_ms(functools.partial(ops.matmul_plain, a, b), 5),
            library_ms=time_ms(functools.partial(torch.matmul, a, b), reps),
            bound_ms=b_ms, bound_by=b_by)
        for m, k, n in MATMUL_RAGGED:
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            before = ops.LAUNCHES["matmul"]
            got = ops.matmul(a, b).float()
            check(ops.LAUNCHES["matmul"] == before + 1,
                  f"{key} {(m, k, n)} did not launch the kernel")
            want = ops.matmul_plain(a, b).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
                  f"{key} {(m, k, n)} outside {tol} of plain (max err {err})")
            res[key]["max_abs_err_by_shape"][f"{m}x{k}x{n}"] = err
            del a, b, got, want
        del main

    res["jacobi_half_types"] = jacobi_half_checks(ops, gen)
    res.update(flash_checks(ops, gen, fp32, bf16, mem_rate))
    res["ssd_chunk"] = ssd_checks(ops, gen, fp32, mem_rate)
    return res


def jacobi_half_checks(ops, gen) -> dict:
    """Both Jacobi entry points in bf16 and f16 at JACOBI_HALF_SHAPES: equal
    to their plain versions bit for bit, one launch each."""
    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        for shape in JACOBI_HALF_SHAPES:
            x, y, z = shape
            u_pad = torch.randn(tuple(n + 2 for n in shape), generator=gen,
                                device=dev).to(dtype)
            u = u_pad[1:-1, 1:-1, 1:-1].contiguous()
            faces = [torch.randn(f, generator=gen, device=dev).to(dtype)
                     for f in ((y, z), (y, z), (x, z), (x, z), (x, y),
                               (x, y))]
            before = dict(ops.LAUNCHES)
            got = ops.jacobi3d(u_pad)
            got_f = ops.jacobi3d_faces(u, *faces)
            check(ops.LAUNCHES["jacobi3d"] == before["jacobi3d"] + 1
                  and ops.LAUNCHES["jacobi3d_faces"]
                  == before["jacobi3d_faces"] + 1,
                  f"jacobi {dtype} {shape} did not launch the kernels")
            for what, a, b in (
                    ("jacobi3d", got, ops.jacobi3d_plain(u_pad)),
                    ("jacobi3d_faces", got_f,
                     ops.jacobi3d_faces_plain(u, *faces))):
                torch.cuda.synchronize()
                diff = int((a != b).sum().item())
                check(a.dtype == dtype and diff == 0,
                      f"{what} {dtype} {shape}: {diff} points differ from "
                      f"plain")
                out[f"{what}/{str(dtype)[6:]}/{'x'.join(map(str, shape))}"] \
                    = "equal"
            del u_pad, u, faces, got, got_f
    return out


def flash_checks(ops, gen, fp32, bf16, mem_rate) -> dict:
    """flash_attention at the serve prefill's shapes: the GQA entry in bf16
    (the main path, q [4, 2048, 4, 8, 128]) and the Pallas contract in
    float32 at [128, 2048, 128], both causal; each arm also through the GQA
    entry at FLASH_SHAPES. The library yardstick is
    scaled_dot_product_attention on the same, broadcast, heads."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    edge_errs = {"bf16": {}, "f32": {}}
    for b_, s_, t_, kh_, g_, d_, causal in FLASH_SHAPES:
        q = torch.randn((b_, s_, kh_, g_, d_), generator=gen, device=dev)
        k, v = (torch.randn((b_, t_, kh_, d_), generator=gen, device=dev)
                for _ in range(2))
        for arm, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            qq, kk, vv = (x.to(dtype) for x in (q, k, v))
            got = ops.flash_attention_gqa(qq, kk, vv, causal=causal).float()
            want = ops.flash_attention_plain(qq, kk, vv,
                                             causal=causal).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            key = f"s{s_}t{t_}g{g_}d{d_}{'c' if causal else ''}"
            tol = FLASH_TOL[arm]
            check(bool(torch.isfinite(got).all()),
                  f"flash {arm} {key}: non-finite")
            check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
                  f"flash {arm} {key} outside {tol} of plain (max err {err})")
            edge_errs[arm][key] = err
    cfg_b, s, kh, g = SERVE_BATCH, SERVE_PROMPT, 4, 8
    bh = cfg_b * kh * g
    res = {}
    cases = []
    # the main shapes (D = 128), then the same at D = 256 (the column-group
    # kernels; no ported config reaches them)
    for d, sfx in ((128, ""), (256, "_d256")):
        q = torch.randn((cfg_b, s, kh, g, d), generator=gen, device=dev)
        k = torch.randn((cfg_b, s, kh, d), generator=gen, device=dev)
        v = torch.randn((cfg_b, s, kh, d), generator=gen, device=dev)
        # causal work: S(S+1)/2 scored pairs per head, 4*D flops each
        flops = bh * s * (s + 1) / 2 * 4 * d
        cases += [
            ("flash_attention" + sfx, torch.bfloat16, bf16, FLASH_TOL["bf16"],
             (q, k, v), ops.flash_attention_gqa, ops.flash_attention_plain,
             flops),
            ("flash_attention_f32" + sfx, torch.float32, fp32,
             FLASH_TOL["f32"],
             (q.permute(0, 2, 3, 1, 4).reshape(bh, s, d),
              k.permute(0, 2, 1, 3)[:, :, None].expand(cfg_b, kh, g, s, d)
              .reshape(bh, s, d),
              v.permute(0, 2, 1, 3)[:, :, None].expand(cfg_b, kh, g, s, d)
              .reshape(bh, s, d)),
             ops.flash_attention,
             lambda a, b, c: ops.flash_attention_plain(
                 a[:, :, None, None], b[:, :, None], c[:, :, None])[:, :, 0, 0],
             flops)]
        del q, k, v
    for key, dtype, rate, tol, args, kernel, plain, flops in cases:
        args = tuple(x.to(dtype).contiguous() for x in args)
        got = kernel(*args).float()
        want = plain(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{key}: non-finite output")
        check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
              f"{key} outside {tol} of plain (max err {err})")
        del got, want
        # SDPA on [B, H, S, D] with K and V broadcast to every query head
        d = args[0].shape[-1]
        if args[0].dim() == 5:
            qs = args[0].reshape(cfg_b, s, kh * g, d).transpose(1, 2)
            ks, vs = (x.transpose(1, 2).repeat_interleave(g, dim=1)
                      for x in args[1:])
        else:
            qs, ks, vs = (x[None] for x in args)
        qs, ks, vs = (x.contiguous() for x in (qs, ks, vs))
        nbytes = sum(x.numel() for x in args + (args[0],)) * \
            args[0].element_size()
        b_ms, b_by = bound(nbytes, flops, rate, mem_rate)
        res[key] = dict(
            shape=list(args[0].shape), dtype=str(dtype), max_abs_err=err,
            tol=tol, ms=time_ms(functools.partial(kernel, *args), 5),
            plain_ms=time_ms(functools.partial(plain, *args), 2, warmup=1),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), 5),
            bound_ms=b_ms, bound_by=b_by)
        del qs, ks, vs, args
    res["flash_attention"]["max_abs_err_by_shape"] = edge_errs["bf16"]
    res["flash_attention_f32"]["max_abs_err_by_shape"] = edge_errs["f32"]
    return res


def ssd_inputs(gen, bc, q, h, p, n, model_like: bool, mixed: bool = False):
    """x, dt, A, B, C on the card. ``model_like`` draws dt and A as the
    mamba2 block makes them (softplus around dt_bias = log(expm1(0.01)),
    A = -linspace(1, 16)); otherwise as tests/test_kernels.py does.
    ``mixed`` (with ``model_like``) makes A positive and small (+0.05) on
    every other head."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    x = torch.randn((bc, q, h, p), generator=gen, device=dev)
    r = torch.randn((bc, q, h), generator=gen, device=dev)
    if model_like:
        dt = F.softplus(r + float(np.log(np.expm1(0.01))))
        A = -torch.linspace(1.0, 16.0, h, device=dev)
        if mixed:
            A[1::2] = 0.05
    else:
        dt = F.softplus(r)
        A = -torch.exp(torch.randn((h,), generator=gen, device=dev))
    B = torch.randn((bc, q, n), generator=gen, device=dev)
    C = torch.randn((bc, q, n), generator=gen, device=dev)
    return x, dt, A, B, C


def ssd_work(bc, q, h, p, n):
    """(bytes, flops) of one ssd_chunk call: each input read once and each
    output written once; the products C·Bᵀ over the causal half, w·xdt
    over it, and the states contraction (the elementwise decay and
    exponentials, about 1/p of these, are not counted)."""
    pairs = q * (q + 1) / 2
    flops = 2 * bc * (pairs * n + h * pairs * p + h * q * p * n)
    nbytes = 4 * (2 * bc * q * h * p + bc * q * h + h + 2 * bc * q * n
                  + bc * h * p * n)
    return nbytes, flops


def ssd_checks(ops, gen, fp32, mem_rate) -> dict:
    """ssd_chunk against its plain version at every shape of SSD_SHAPES,
    with test-style and model-style dt and A; times at the main path's
    shape with model-style inputs. No one PyTorch call computes this
    function, so there is no library time."""
    worst = {}
    cases = [(shape, model_like, False) for shape in SSD_SHAPES
             for model_like in (False, True)] + [(SSD_MIXED, True, True)]
    for shape, model_like, mixed in cases:
        args = ssd_inputs(gen, *shape, model_like, mixed)
        y, st = ops.ssd_chunk(*args)
        wy, wst = ops.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        for got, want, what in ((y, wy, "y"), (st, wst, "states")):
            check(bool(torch.isfinite(got).all()),
                  f"ssd_chunk {shape}: non-finite {what}")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            check(err <= SSD_TOL * scale, f"ssd_chunk {shape} {what}: "
                  f"max err {err} above {SSD_TOL} x {scale}")
            key = f"{'x'.join(map(str, shape))}{'/mixed' if mixed else ''}" \
                f"/{what}"
            worst[key] = max(worst.get(key, 0.0), err / scale)
        if shape == SSD_MAIN and model_like:
            main_err = max((y - wy).abs().max().item(),
                           (st - wst).abs().max().item())
        del args, y, st, wy, wst
    args = ssd_inputs(gen, *SSD_MAIN, True)
    b_ms, b_by = bound(*ssd_work(*SSD_MAIN), fp32, mem_rate)
    return dict(
        shape=list(SSD_MAIN), dtype="torch.float32", max_abs_err=main_err,
        tol=f"{SSD_TOL} x max|plain|", rel_err_by_shape=worst,
        ms_by_part=ssd_parts(ops, args),
        ms=time_ms(functools.partial(ops.ssd_chunk, *args), 10),
        plain_ms=time_ms(functools.partial(ops.ssd_chunk_plain, *args), 3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def ssd_parts(ops, args, reps: int = 5) -> dict:
    """Device time of one ssd_chunk call split by its kernels (a traced
    run of ``reps`` calls): the y part (the scan, the scores and the two y
    kernels) and the states part, with each kernel's own time."""
    from torch.profiler import ProfilerActivity, profile
    ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ops.ssd_chunk(*args)
        torch.cuda.synchronize()
    by: dict = {}
    for e in prof.events():
        name = e.name.replace("(anonymous namespace)::", "")
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and name.startswith("ssd_"):
            key = name.split("(")[0]
            by[key] = by.get(key, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e3 / reps
    if not by:
        return {"device_trace": "not measured"}
    return {"by_kernel": by,
            "states": by.get("ssd_states_kernel", 0.0),
            "y": sum(v for k, v in by.items() if k != "ssd_states_kernel")}


def _trace_summary(prof, lo_name: Optional[str] = None) -> dict:
    """Device time of a traced window: its span, the union of its kernels
    and copies (busy), the idle share, the time of kernels whose name holds
    ``lo_name`` (where given) and the six names that took longest."""
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"device_trace": "not measured"}
    lo, hi = min(a for _, a, _ in dev), max(b for _, _, b in dev)
    busy = _busy_us(dev, lo, hi)
    names: dict = {}
    for n, a, b in dev:
        names[n[:60]] = names.get(n[:60], 0.0) + (b - a) / 1e3
    out = {"span_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / (hi - lo),
           "by_name_ms": {k: round(v, 3) for k, v in sorted(
               names.items(), key=lambda kv: -kv[1])[:6]}}
    if lo_name is not None:
        named = sum(b - a for n, a, b in dev if lo_name in n) / 1e3
        out[f"{lo_name}_ms"] = named
        out[f"{lo_name}_share_of_busy"] = named / (busy / 1e3)
    return out


def serve_trace(eng, tokens, kernel: str) -> dict:
    """A traced prefill and four traced decode steps, after the main run:
    where the device time of each goes (``kernel``: the prefill kernels'
    name fragment)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        nxt, cache = eng.prefill(tokens)
        torch.cuda.synchronize()
    out = {"prefill": _trace_summary(prof, kernel)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.decode(cache, nxt, tokens.shape[1], 4)
        torch.cuda.synchronize()
    out["decode_4_steps"] = _trace_summary(prof)
    return out


# the serving phases: (arch, batch, prompt tokens, decode steps, the kernel
# flag, the kernel's LAUNCHES key, its name in a trace, prefill tolerances)
SERVE_SPECS = {
    5: (SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, "use_flash_kernel",
        "flash_attention", "flash_mma", PREFILL_REL_TOL),
    6: (SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_STEPS, "use_ssd_kernel",
        "ssd_chunk", "ssd_", SSM_PREFILL_REL_TOL),   # ssd_y + ssd_states
}


def serve_phase(ops, Runtime, RuntimeConfig, phase: int) -> dict:
    """Phase 5 (yi-9b) or 6 (mamba2-370m) at full width and depth through
    the Engine (the main path), then the checks and the tasked decode loop
    from the same prefill state."""
    import dataclasses
    from repro_torch.configs import GLOBAL_ATTN, get_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_model
    from repro_torch.serve import tasked_decode_loop
    arch, b, s, steps, flag, kernel, trace_name, tols = SERVE_SPECS[phase]
    dev = torch.device("cuda")
    cfg = get_config(arch)
    model = build_model(cfg)
    check(getattr(model.flags, flag)
          and model.flags.param_dtype == torch.bfloat16,
          f"serve flags {model.flags}: want bf16 and {flag}")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    r = {"arch": cfg.name, "layers": cfg.n_layers, "batch": b, "prompt": s,
         "decode_steps": steps, "init_s": time.perf_counter() - t0,
         "weights_gb": sum(p.numel() * p.element_size()
                           for p in params.parameters()) / 1e9}
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(
                               SEED + 1))
    eng = Engine(model, params, b, s + steps)
    nxt, cache = eng.prefill(tokens)              # warm-up, not counted
    eng.decode(cache, nxt, s, 2)
    del nxt, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r["allocated_before_gb"] = torch.cuda.memory_allocated() / 1e9

    # -- the main path: prefill + decode, counters around it --
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    nxt, cache = eng.prefill(tokens)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r["launches_in_prefill"] = dict(ops.LAUNCHES)
    start_cache = {k: v.clone() for k, v in cache.items()}
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rest = eng.decode(cache, nxt, s, steps)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    r["launches"] = dict(ops.LAUNCHES)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["cache_gb"] = {k: v.numel() * v.element_size() / 1e9
                     for k, v in cache.items()}
    r["prefill_ms"] = (t1 - t0) * 1e3
    r["prefill_tok_s"] = b * s / (t1 - t0)
    r["decode_ms_per_step"] = (t3 - t2) * 1e3 / steps
    r["decode_tok_s"] = b * steps / (t3 - t2)
    out = torch.cat([nxt, rest], dim=1)                   # [B, steps + 1]
    check(r["launches"][kernel] == cfg.n_layers
          and r["launches_in_prefill"][kernel] == cfg.n_layers,
          f"serve launched {kernel} {r['launches'][kernel]} times "
          f"({r['launches_in_prefill'][kernel]} in the prefill), not "
          f"{cfg.n_layers} (all in the prefill)")
    check(out.shape == (b, steps + 1) and bool(
        ((out >= 0) & (out < cfg.vocab)).all()), "tokens out of range")

    # -- the same decode as hetero tasks, from the same prefill state:
    # interpreted, then replayed as CUDA graphs (trace_graphs) --
    for traced in (False, True):
        key = "tasked_traced" if traced else "tasked"
        r[key] = tasked_decode(Runtime, RuntimeConfig, tasked_decode_loop,
                               model, params, start_cache, nxt, s, steps,
                               cache, out, traced)
    r["tasked_decode_ms_per_step"] = r["tasked"]["ms_per_step"]
    r["tasked_traced"]["trace_4_replayed_steps"] = traced_decode_trace(
        Runtime, RuntimeConfig, tasked_decode_loop, model, params,
        start_cache, nxt, s)
    # the runtimes' objects (and their lineage records) hold the weights
    del start_cache
    gc.collect()
    r["tasked_equals_engine"] = True

    # -- prefill through the kernel vs the plain path on the card --
    r["prefill_kernel_vs_plain"] = {"bf16": prefill_vs_plain(
        model, params, tokens, tols["bf16"], flag)}

    # -- greedy decode vs argmax of a full forward over prompt + tokens --
    full = torch.cat([tokens, out[:, :-1]], dim=1)
    n = full.shape[1]
    fwd_flags = model.flags
    if cfg.layer_pattern == (GLOBAL_ATTN,):
        # the attention layer takes the kernel only at S % 128 == 0, as the
        # JAX package's takes the Pallas one: the plain path, in
        # the largest block that divides prompt + steps
        blk = max(d for d in range(1, 513) if n % d == 0)
        fwd_flags = dataclasses.replace(fwd_flags, use_flash_kernel=False,
                                        flash_block=blk)
        r["full_forward_block"] = blk
    fwd = build_model(cfg, fwd_flags)
    hidden, _ = fwd.apply(params, {"tokens": full}, mode="train")
    logits = fwd.unembed(params, hidden[:, s - 1:]).float()  # [B, steps+1, V]
    del hidden
    top2 = logits.topk(2, dim=-1).values
    # how far below the full forward's best logit each decoded token lies
    # (0 where the two agree)
    shortfall = top2[..., 0] - logits.gather(-1, out.long()[..., None])[..., 0]
    agree = (logits.argmax(dim=-1) == out).float().mean().item()
    r["greedy_vs_full_forward"] = {
        "agreement": agree, "threshold": GREEDY_MIN_AGREEMENT,
        "max_logit_shortfall": shortfall.max().item(),
        "shortfall_tol": GREEDY_MAX_SHORTFALL,
        "median_top2_gap": (top2[..., 0] - top2[..., 1]).median().item()}
    del logits
    check(agree >= GREEDY_MIN_AGREEMENT, f"greedy decode agrees with the full "
          f"forward on {agree:.4f} of tokens, below {GREEDY_MIN_AGREEMENT}")
    check(shortfall.max().item() <= GREEDY_MAX_SHORTFALL,
          f"a decoded token's logit lies {shortfall.max().item()} below the "
          f"full forward's best, more than {GREEDY_MAX_SHORTFALL}")
    del cache
    r["trace"] = serve_trace(eng, tokens, trace_name)
    share = r["trace"]["prefill"].get(f"{trace_name}_share_of_busy", 0.0)
    check(share > 0, f"no {trace_name!r} kernel time in the traced prefill "
          f"({r['trace']['prefill']})")
    # the same prefill check with float32 weights: the bf16 ones go
    del eng, params
    torch.cuda.empty_cache()
    model32 = build_model(cfg, dataclasses.replace(
        model.flags, param_dtype=torch.float32))
    params32 = model32.init(torch.Generator(device=dev).manual_seed(SEED),
                            dev)
    r["prefill_kernel_vs_plain"]["f32"] = prefill_vs_plain(
        model32, params32, tokens, tols["f32"], flag)
    del params32
    torch.cuda.empty_cache()
    return r


def tasked_decode(Runtime, RuntimeConfig, tasked_decode_loop, model, params,
                  start_cache, nxt, s, steps, cache, out, traced) -> dict:
    """``tasked_decode_loop`` from the prefill state: ms per step, runtime
    counters, and its tokens, lengths and cache checked bit for bit
    against the Engine's (``cache``, ``out``). ``traced`` runs it under
    ``trace_graphs``: the windows after the third replay a CUDA graph."""
    b = nxt.shape[0]
    rt = Runtime(RuntimeConfig(trace_graphs=traced))
    try:
        c = {k: v.clone() for k, v in start_cache.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok_obj, len_obj, c_objs = tasked_decode_loop(
            rt, model, params, c, nxt.clone(),
            torch.full((b,), s, dtype=torch.int32, device=nxt.device), steps,
            timeout=600)
        tok, lens = tok_obj.get(), len_obj.get()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        # the reads above waited for the device: the caches are final
        diff = {k: int((c_objs[k].copies[0] != cache[k]).sum().item())
                for k in sorted(cache)}
        stats = rt.stats()
    finally:
        rt.shutdown()
    del c, tok_obj, len_obj, c_objs, rt
    r = {"ms_per_step": ms, "runtime_stats": {k: stats[k] for k in (
        "tasks", "transfers_h2d", "transfers_d2h", "transfers_d2d",
        "bytes_h2d", "bytes_d2h", "prefetch_hits", "prefetch_misses",
        "graphs_traced", "graph_replays", "graph_invalidations",
        "replayed_tasks")}}
    what = "traced tasked" if traced else "tasked"
    check(np.array_equal(tok, out[:, -1:].cpu().numpy()),
          f"{what} decode's last tokens {tok.ravel().tolist()} != "
          f"Engine's {out[:, -1].tolist()}")
    check(bool((lens == s + steps).all()), f"{what} lengths {lens}")
    check(not any(diff.values()), f"{what} cache differs from the "
          f"Engine's at {diff} elements")
    if traced:
        check(stats["graph_replays"] > 0 and stats["graph_invalidations"] == 0,
              f"traced tasked decode replayed no graph: {r['runtime_stats']}")
    return r


def traced_decode_trace(Runtime, RuntimeConfig, tasked_decode_loop, model,
                        params, start_cache, nxt, s, n: int = 4) -> dict:
    """Device time of ``n`` replayed decode steps: a traced loop of
    ``replay_after + 1 + n`` steps (interpreted windows, the capture, then
    n more replays) under the profiler. The window runs from the host's
    launch of the n-th last graph replay to the end of the last device
    event."""
    from torch.profiler import ProfilerActivity, profile
    b = nxt.shape[0]
    rt = Runtime(RuntimeConfig(trace_graphs=True))
    try:
        c = {k: v.clone() for k, v in start_cache.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tok_obj, _, _ = tasked_decode_loop(
                rt, model, params, c, nxt.clone(),
                torch.full((b,), s, dtype=torch.int32, device=nxt.device),
                rt.cfg.replay_after + 1 + n, timeout=600)
            tok_obj.get()
    finally:
        rt.shutdown()
    del c, tok_obj, rt
    launches = sorted(e.time_range.start for e in prof.events()
                      if e.name == "cudaGraphLaunch")
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(launches) < n or not dev:
        return {"device_trace": "not measured",
                "graph_launches_traced": len(launches)}
    lo, hi = launches[-n], max(e for _, _, e in dev)
    busy = _busy_us(dev, lo, hi)
    # idle between consecutive device events: gaps under 20 us are the
    # device's own launch latency between the graph's kernels, longer ones
    # wait for the host
    short = long_ = 0.0
    end = lo
    inside = sorted((a, b) for _, a, b in dev if b > lo and a < hi)
    for a, b in inside:
        if a > end:
            if a - end < 20.0:
                short += a - end
            else:
                long_ += a - end
        end = max(end, b)
    return {"steps": n, "span_ms": (hi - lo) / 1e3,
            "ms_per_step": (hi - lo) / 1e3 / n,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (hi - lo),
            "kernels_per_step": len(inside) / n,
            "idle_in_gaps_under_20us_ms": short / 1e3,
            "idle_in_longer_gaps_ms": long_ / 1e3}


def traced_jacobi(ops, run_tasked, Runtime, RuntimeConfig, u0, interp,
                  want) -> dict:
    """Phase 4b: ``run_tasked`` under ``trace_graphs`` at the main path's
    size. Sweeps 1-3 run interpreted and compile the window; sweep 4
    captures it as a CUDA graph, and every later sweep replays it. It must
    equal the interpreted run and ``run_reference`` bit for bit and launch
    the stencil as often; then a profiled run gives its steady sweeps."""
    rt = Runtime(RuntimeConfig(trace_graphs=True))
    try:
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        got = run_tasked(u0, JACOBI_ITERS, rt, over_decomposition=JACOBI_OD)
        wall_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        stats = rt.stats()
        replay_after = rt.cfg.replay_after
    finally:
        rt.shutdown()
    n_diff = int(np.count_nonzero(got != interp))
    check(n_diff == 0 and np.array_equal(got, want),
          f"traced run_tasked differs from the interpreted run at {n_diff} "
          f"points (and from run_reference: {not np.array_equal(got, want)})")
    check(stats["graph_replays"] >= JACOBI_ITERS - replay_after - 1,
          f"traced run_tasked replayed {stats['graph_replays']} windows")
    check(launches["jacobi3d_faces"] == JACOBI_OD * JACOBI_ITERS,
          f"traced run_tasked launched jacobi3d_faces "
          f"{launches['jacobi3d_faces']} times, not "
          f"{JACOBI_OD * JACOBI_ITERS}")
    del got, rt
    gc.collect()
    trace = sweep_trace(run_tasked, Runtime, RuntimeConfig, u0, traced=True)
    return {"wall_s": wall_s, "launches": launches,
            "equal_to_interpreted_and_reference": True,
            "runtime_stats": {k: stats[k] for k in (
                "tasks", "graphs_traced", "graph_replays",
                "graph_invalidations", "replayed_tasks")},
            "trace": trace}


def cluster_phase(ops, run_reference, RuntimeConfig, u0) -> dict:
    """Phase 7: ``run_cluster`` over a ``Cluster(4)`` whose ranks share the
    card: slabs of 192 x 768 x 768 scattered and gathered on rendezvous
    streams, halo planes put DIRECT, each update the ``jacobi3d_faces``
    kernel. Run with 0 iterations (scatter and gather alone, which must
    return the domain bit for bit) and with 10, which must equal
    ``run_reference``; the difference of the two walls over 10 is the
    wall time of one iteration."""
    from repro_torch.apps.jacobi3d import run_cluster
    from repro_torch.distributed import Cluster
    n_ranks = 4
    want = run_reference(u0, JACOBI_ITERS, device="cuda")
    out = {"ranks": n_ranks, "shape": list(u0.shape),
           "iterations": JACOBI_ITERS}
    walls = {}
    for iters in (0, JACOBI_ITERS):
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        with Cluster(n_ranks, RuntimeConfig()) as c:
            t0 = time.perf_counter()
            got = run_cluster(u0, iters, c)
            walls[iters] = time.perf_counter() - t0
            stats = [dict(r.stats) for r in c.ranks]
        ref = u0 if iters == 0 else want
        n_diff = int(np.count_nonzero(got != ref))
        check(n_diff == 0, f"run_cluster ({iters} iterations) differs from "
              f"{'the domain' if iters == 0 else 'run_reference'} at "
              f"{n_diff} points")
        check(ops.LAUNCHES["jacobi3d_faces"] == n_ranks * iters,
              f"run_cluster launched jacobi3d_faces "
              f"{ops.LAUNCHES['jacobi3d_faces']} times, not "
              f"{n_ranks * iters}")
        del got
        gc.collect()
    out.update({
        "wall_s": walls[JACOBI_ITERS], "scatter_gather_wall_s": walls[0],
        "ms_per_iteration": (walls[JACOBI_ITERS] - walls[0]) * 1e3
        / JACOBI_ITERS,
        "equal_to_reference": True,
        "per_rank": [{k: s[k] for k in (
            "bytes_d2d", "bytes_staged", "eager", "rendezvous",
            "chunks_out", "chunks_in", "max_window")} for s in stats],
        "rendezvous_streams": sum(s["rendezvous"] for s in stats)})
    del want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def send_latency(RuntimeConfig, reps: int = 5) -> dict:
    """``Rank.send`` latency between two ranks sharing the card: host clock
    from the send to the run of the receiving handler, median of ``reps``
    after two warm-up sends, at 8 B, 64 KB and 64 MB, over the DIRECT path
    (a payload resident on the card, snapshotted and landed on the card)
    and the host path (a host payload, which an eager message leaves in
    the receiver's host memory and a rendezvous stream lands on the card).
    The message engine's own overhead on one card, not an inter-node
    figure."""
    import threading

    from repro_torch.distributed import Cluster, handler
    arrived = threading.Event()

    @handler(name="smoke_ping")
    def _ping(ctx, obj):
        arrived.set()

    out = {}
    with Cluster(2, RuntimeConfig()) as c:
        r0 = c.ranks[0]
        for nbytes in (8, 64 << 10, 64 << 20):
            for path in ("direct", "host"):
                times = []
                for i in range(reps + 2):
                    if path == "direct":
                        obj = r0.runtime.adopt_device_array(
                            torch.ones(nbytes // 4, device="cuda"), 0)
                    else:
                        obj = r0.runtime.hetero_object(
                            np.ones(nbytes // 4, np.float32))
                    before = dict(r0.stats)
                    arrived.clear()
                    t0 = time.perf_counter()
                    r0.send(1, "smoke_ping", obj, path=path)
                    check(arrived.wait(120), f"send of {nbytes} B over "
                          f"{path} never reached its handler")
                    dt = time.perf_counter() - t0
                    c.barrier()
                    if i >= 2:
                        times.append(dt * 1e6)
                rdzv = r0.stats["rendezvous"] > before["rendezvous"]
                d2d = r0.stats["bytes_d2d"] > before["bytes_d2d"]
                out[f"{nbytes}B_{path}"] = {
                    "protocol": "rendezvous" if rdzv else "eager",
                    "path_taken": "direct" if d2d else "host",
                    "median_us": float(np.median(times)),
                    "min_us": float(min(times))}
    return out


def prefill_vs_plain(model, params, tokens, tol: float, flag: str) -> dict:
    """The prefill's final hidden state through the kernel against the same
    prefill with the kernel ``flag`` off (the plain path)."""
    import dataclasses
    from repro_torch.models import build_model
    x_on, _ = model.apply(params, {"tokens": tokens}, mode="prefill")
    off = build_model(model.cfg, dataclasses.replace(model.flags,
                                                     **{flag: False}))
    x_off, _ = off.apply(params, {"tokens": tokens}, mode="prefill")
    x_on, x_off = x_on.float(), x_off.float()
    check(bool(torch.isfinite(x_on).all()), "non-finite prefill hidden state")
    rel = ((x_on - x_off).norm() / x_off.norm()).item()
    check(rel <= tol, f"prefill hidden state through the kernel is {rel} "
          f"(relative L2) from the plain path, above {tol} "
          f"({model.flags.param_dtype})")
    return {"rel_l2": rel, "max_abs": (x_on - x_off).abs().max().item(),
            "tol_rel_l2": tol}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.apps.dgemm import run_double_dgemm
    from repro_torch.apps.jacobi3d import run_reference, run_tasked
    from repro_torch.core import Runtime, RuntimeConfig
    from repro_torch.kernels import _build, ops

    # -- phase 1: card and build --------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    sku, (fp32, bf16, mem_rate) = peaks(name)
    print(card)
    print(f"peaks of the {sku}: fp32 {fp32:.3g} FLOP/s, bf16 {bf16:.3g} "
          f"FLOP/s, {mem_rate:.3g} B/s; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    log = _build.build_all()
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} over "
          f"src/repro_torch/csrc/{{{','.join(sorted(_build.SIGNATURES))}}}.cu"
          f" in {time.perf_counter() - t0:.3f} s")
    for lib, (secs, out) in sorted(log.items()):
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln]
        print(f"build: lib{lib}.so {secs:.3f} s; " + " | ".join(regs))

    # -- phase 2: kernels against their plain versions ------------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = kernel_checks(ops, gen, fp32, bf16, mem_rate)
    for key, r in res.items():
        print(f"kernel {key}: {json.dumps(r)}")

    # -- phase 3: double DGEMM through the runtime -----------------------------
    rt = Runtime(RuntimeConfig())
    try:
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        a, b, d = run_double_dgemm(rt, DGEMM_N, SEED)
        dgemm_ms = (time.perf_counter() - t0) * 1e3
        dgemm_launches = dict(ops.LAUNCHES)
        stats = rt.stats()
    finally:
        rt.shutdown()
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    want = ops.matmul_plain(ops.matmul_plain(ta, tb), tb).cpu().numpy()
    del ta, tb
    dgemm_err = float(np.max(np.abs(d - want)))
    check(bool(np.allclose(d, want, rtol=1e-3, atol=1e-3)),
          f"runtime DGEMM outside 1e-3 of plain (max err {dgemm_err})")
    check(dgemm_launches["matmul"] == 2,
          f"DGEMM launched matmul {dgemm_launches['matmul']} times, not 2")
    print(f"dgemm: n={DGEMM_N} {dgemm_ms:.3f} ms wall (incl. staging); "
          f"launches {dgemm_launches}; max abs err vs plain {dgemm_err}; "
          + json.dumps({k: stats[k] for k in (
              "tasks", "transfers_h2d", "transfers_d2h", "transfers_d2d",
              "bytes_h2d", "bytes_d2h", "staging_hits", "staging_misses",
              "prefetch_hits", "prefetch_stalls", "prefetch_misses")}))

    # -- phase 4: Jacobi3D through the runtime ---------------------------------
    u0 = np.random.default_rng(SEED).random((JACOBI_N,) * 3,
                                            dtype=np.float32)
    torch.cuda.reset_peak_memory_stats()
    rt = Runtime(RuntimeConfig())
    try:
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        got = run_tasked(u0, JACOBI_ITERS, rt,
                         over_decomposition=JACOBI_OD)
        jac_s = time.perf_counter() - t0
        jac_launches = dict(ops.LAUNCHES)
        stats = rt.stats()
    finally:
        rt.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trace = sweep_trace(run_tasked, Runtime, RuntimeConfig, u0)
    t0 = time.perf_counter()
    want = run_reference(u0, JACOBI_ITERS, device="cuda")
    ref_s = time.perf_counter() - t0
    n_diff = int(np.count_nonzero(got != want))
    check(n_diff == 0, f"run_tasked differs from run_reference at "
          f"{n_diff} points (max {float(np.max(np.abs(got - want)))})")
    want_launches = JACOBI_OD * JACOBI_ITERS
    check(jac_launches["jacobi3d_faces"] == want_launches,
          f"run_tasked launched jacobi3d_faces "
          f"{jac_launches['jacobi3d_faces']} times, not {want_launches}")
    check(bool(np.isfinite(got).all()), "non-finite Jacobi result")
    print(f"jacobi: {JACOBI_N}^3 od={JACOBI_OD} iters={JACOBI_ITERS} "
          f"run_tasked {jac_s * 1e3 / JACOBI_ITERS:.3f} ms/iteration wall "
          f"(incl. staging in and out); run_reference {ref_s:.3f} s; "
          f"tasks {stats['tasks']}; launches {jac_launches}; equal to "
          f"run_reference: True")
    print(f"jacobi peak device memory {peak_gb:.3f} GB; traced run: "
          + json.dumps(trace))
    # the Jacobi runtime's objects (and their lineage records, a cycle)
    # still hold the domain on the card
    del rt
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 4b: the same proxy with its sweeps replayed as CUDA graphs --
    traced = traced_jacobi(ops, run_tasked, Runtime, RuntimeConfig, u0, got,
                           want)
    traced["interpreted_trace"] = {k: trace.get(k) for k in (
        "steady_ms_per_sweep", "steady_device_idle_share",
        "stencil_kernel_ms")}
    print(f"jacobi traced ({card}): " + json.dumps(traced))
    del got, want
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 5: dense-LM serving, yi-9b at full width and depth -------------
    srv = serve_phase(ops, Runtime, RuntimeConfig, 5)
    print(f"serve ({card}): " + json.dumps(srv))

    # -- phase 6: Mamba-2 serving, mamba2-370m at full width and depth -------
    ssm = serve_phase(ops, Runtime, RuntimeConfig, 6)
    print(f"serve ssm ({card}): " + json.dumps(ssm))

    # -- phase 7: the distributed proxy on the message engine --------------
    dist = cluster_phase(ops, run_reference, RuntimeConfig, u0)
    print(f"jacobi cluster ({card}): " + json.dumps(dist))
    print(f"send latency ({card}): "
          + json.dumps(send_latency(RuntimeConfig)))

    launches = {"jacobi3d_faces": jac_launches["jacobi3d_faces"],
                "matmul": dgemm_launches["matmul"],
                "flash_attention": srv["launches"]["flash_attention"],
                "ssd_chunk": ssm["launches"]["ssd_chunk"]}
    sources = {"jacobi3d_faces": ("src/repro_torch/csrc/jacobi3d.cu",
                                  "src/repro/kernels/jacobi3d.py:19"),
               "matmul": ("src/repro_torch/csrc/matmul.cu",
                          "src/repro/kernels/matmul.py:18"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:20"),
               "ssd_chunk": ("src/repro_torch/csrc/ssd.cu",
                             "src/repro/kernels/ssd.py:22")}
    kernels = [dict(
        name=k, route="cuda", source=sources[k][0], replaces=sources[k][1],
        launches=launches[k], max_abs_err=res[k]["max_abs_err"],
        ms=res[k]["ms"], plain_ms=res[k]["plain_ms"],
        bound_ms=res[k]["bound_ms"], bound_by=res[k]["bound_by"],
        library_ms=res[k]["library_ms"]) for k in sources]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
