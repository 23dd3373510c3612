#!/usr/bin/env python3
"""Time ``run_spmd`` at 768^3 with one shard a card and with four shards
on card 0, on a node of four CUDA cards.

    python3 tools/spmd_cards.py

For each layout and schedule (overlapped, bulk-synchronous): the run of 10
iterations must equal ``run_reference`` bit for bit with 40
``jacobi3d_faces`` launches; then 10 steady steps after a warm-up one are
timed on the host clock, every card synchronised. Prints the cards' names
and power limits and one JSON object. Exits non-zero with fewer than four
cards.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "..", "src"))


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("spmd_cards: needs four CUDA cards", file=sys.stderr)
        return 2
    from repro_torch.apps.jacobi3d import (make_spmd_step, run_reference,
                                           run_spmd)
    from repro_torch.distributed import spmd
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.mesh import make_smoke_mesh
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    u0 = np.random.default_rng(0).random((768,) * 3, dtype=np.float32)
    want = run_reference(u0, 10)
    out = {"cards": torch.cuda.device_count()}
    ok = True
    for name, devs in (("four_cards", None),
                       ("one_card", [torch.device("cuda", 0)] * 4)):
        mesh = make_smoke_mesh(4, 1, devices=devs)
        for bulk in (False, True):
            n = LAUNCHES["jacobi3d_faces"]
            got = run_spmd(u0, 10, mesh, bulk_sync=bulk)
            equal = bool(np.array_equal(got, want)) and \
                LAUNCHES["jacobi3d_faces"] == n + 40
            ok = ok and equal
            step = make_spmd_step(mesh, bulk_sync=bulk)
            u = spmd.device_put(torch.from_numpy(u0), mesh, spmd.P("data"))
            u = step(u)
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            for _ in range(10):
                u = step(u)
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
            out[f"{name}_{'bulk' if bulk else 'overlapped'}"] = {
                "equal_and_40_launches": equal,
                "ms_per_iteration": (time.perf_counter() - t0) * 100}
            del u, step
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
