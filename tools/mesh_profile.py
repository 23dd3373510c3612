#!/usr/bin/env python3
"""Where a mesh step's time goes: llama4-scout-17b-16e at full width with 8
of its 48 layers (bf16, drawn from the seed straight onto the mesh)
served by the Engine over a (1, 4) mesh of four shards of card 0, as
``chip_smoke.py`` phase 19 serves it.

    python3 tools/mesh_profile.py

Prints the card's name and power limit, then one JSON object: the time
of a ``psum`` over the four shards at a decode and a prefill activation
([4, 1, 5120] and [4, 2048, 5120] float32) and of a bare rendezvous (20
in a row, mean), the placement's time, the prefill's and a decode step's
time (host clock, synchronised), and each shard's time a decode step
spent waiting in rendezvous; then the profiler's tables of two decode
steps (CUDA API calls by CPU time) and of one prefill (kernels by device
time). Needs a CUDA card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))


def rendezvous_ms(mesh, shape, dev) -> dict:
    """Mean ms of a ``psum`` and of a bare rendezvous over ``mesh`` of a
    float32 value of ``shape``, 20 in a row, three calls."""
    from repro_torch.distributed import spmd
    x = torch.ones(shape, device=dev)

    def psums(a):
        for _ in range(20):
            a = spmd.psum(a, "model") * 0.25
        return a

    def bare(a):
        for _ in range(20):
            spmd._exchange(a)
        return a

    out = {}
    for name, body in (("psum_ms", psums), ("rendezvous_ms", bare)):
        f = spmd.shard_map(body, mesh, spmd.P(), spmd.P())
        f(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            f(x)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / 60 * 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("mesh_profile: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.distributed import spmd
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_model
    from repro_torch.models.sharding import use_sharding
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    _build.build_all()
    dev = torch.device("cuda")
    mesh = make_smoke_mesh(1, 4, devices=[dev] * 4)
    out = {}
    for shape in ((4, 1, 5120), (4, 2048, 5120)):
        out[str(list(shape))] = rendezvous_ms(mesh, shape, dev)
    cfg = dataclasses.replace(get_config("llama4-scout-17b-16e"), n_layers=8)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), dev, mesh=mesh)
    torch.cuda.synchronize()
    out["init_on_mesh_s"] = time.perf_counter() - t0
    b, s, steps = 4, 2048, 8
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    waits = [0.0] * mesh.size
    exchange = spmd._exchange

    def timed(t):
        i = spmd._ctx().index
        t0 = time.perf_counter()
        r = exchange(t)
        waits[i] += time.perf_counter() - t0
        return r

    with use_sharding(mesh):
        eng = Engine(model, params, b, s + 3 * steps + 2)
        nxt, cache = eng.prefill(tokens)
        eng.decode(cache, nxt, s, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, cache = eng.prefill(tokens)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        eng.decode(cache, nxt, s, steps)
        torch.cuda.synchronize()
        out["decode_ms_per_step"] = (time.perf_counter() - t0) * 1e3 / steps
        spmd._exchange = timed
        try:
            eng.decode(cache, nxt, s + steps, steps)
            torch.cuda.synchronize()
        finally:
            spmd._exchange = exchange
        out["rendezvous_wait_ms_per_step_by_shard"] = [
            w * 1e3 / steps for w in waits]
        print(json.dumps(out), flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.decode(cache, nxt, s + 2 * steps, 2)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=15), flush=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.prefill(tokens)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=15), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
