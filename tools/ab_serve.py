#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s serving phases from several checkouts in turn
on one CUDA card, to compare two commits in one call.

    python3 tools/ab_serve.py PARENT CHANGE CHANGE PARENT [--phases 5 6]

Each argument is the root of a checkout (a ``git archive`` of a commit
unpacked in a git-ignored directory, or the working tree). Each runs in a
process of its own, builds its kernels into its own ``build/`` and runs
its ``serve_phase`` for each phase; prints one line per checkout,
``AB <root> <JSON>`` with the prefill, decode and replayed-decode times.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

CODE = r'''
import json, os, sys, gc
root, phases = sys.argv[1], [int(p) for p in sys.argv[2:]]
sys.path[:0] = [root, os.path.join(root, "src")]
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as cs
from repro_torch.core import Runtime, RuntimeConfig
from repro_torch.kernels import _build, ops
_build.build_all()
out = {}
for ph in phases:
    r = cs.serve_phase(ops, Runtime, RuntimeConfig, ph)
    t = r["tasked_traced"]["trace_4_replayed_steps"]
    out[ph] = {k: r[k] for k in ("prefill_ms", "decode_ms_per_step",
                                 "tasked_decode_ms_per_step")}
    out[ph].update(traced_ms=r["tasked_traced"]["ms_per_step"],
                   replay_ms=t.get("ms_per_step"),
                   kernels_per_step=t.get("kernels_per_step"),
                   busy_ms=t.get("device_busy_ms"))
    gc.collect()
    torch.cuda.empty_cache()
print("AB", root, json.dumps(out), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--phases", nargs="+", default=["5", "6"])
    args = ap.parse_args()
    rc = 0
    for root in args.roots:
        p = subprocess.run([sys.executable, "-c", CODE, root, *args.phases],
                           capture_output=True, text=True)
        print(p.stdout[-3000:], flush=True)
        if p.returncode:
            print(p.stderr[-2000:], file=sys.stderr, flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
