#!/usr/bin/env python3
"""Read ``chip_smoke.py`` phase 24's checks against planted faults: the
phase (yi-9b at full width, 1 layer, float32, trained compressed and
ZeRO-1 over a (2, 2, 2) mesh of shards of one card, against one card's
oracle) runs once sound and once with each fault patched into
``repro_torch.train.compression``, which only the mesh's step calls (the
oracle's ``compressed_mean_stacked`` is not touched):

- ``shard_local``: each shard quantizes its slice of a leaf with its own
  256-blocks and maxima, not the whole leaf's;
- ``local_scale``: the whole leaf's blocks, but each part of a block
  split over the model axis takes its own maximum (no ``pmax``);
- ``dropped_ef``: the residual carried in is not added before quantizing;
- ``swapped_pods``: each pod keeps the other pod's new residual.

    python3 tools/phase24_faults.py [variant ...]

Each run prints the phase's line (``multipod_run``'s readings) and then
one ``VERDICT`` line (``multipod_checks``); the last line is a JSON
object of each variant's first-step and worst-leaf readings and verdict.
Exits non-zero if the sound run fails a check or a fault passes them
all. Needs one card (about 40 s a variant on an H100).
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

VARIANTS = ("sound", "shard_local", "local_scale", "dropped_ef",
            "swapped_pods")


@contextlib.contextmanager
def planted(name: str):
    """``name``'s fault patched into ``train.compression`` while open."""
    from repro_torch.distributed import spmd
    from repro_torch.train import compression as Q
    saved = Q.compressed_pmean, Q._quantize_part, Q.spmd
    pmean, part = saved[0], saved[1]
    if name == "shard_local":
        Q._quantize_part = lambda x, split: part(x, ())
    elif name == "local_scale":
        class NoPmax:
            def __getattr__(self, k):
                return getattr(spmd, k)

            @staticmethod
            def pmax(x, axis):
                return x
        Q.spmd = NoPmax()
    elif name == "dropped_ef":
        def fault(x, axis_name, residual=None, split=()):
            return pmean(x, axis_name, None, split)
        Q.compressed_pmean = fault
    elif name == "swapped_pods":
        def fault(x, axis_name, residual=None, split=()):
            mean, new = pmean(x, axis_name, residual, split)
            every = spmd.all_gather(new, axis_name)
            i, n = spmd.axes_index((axis_name,))
            return mean, every[(i + 1) % n].clone()
        Q.compressed_pmean = fault
    elif name != "sound":
        raise SystemExit(f"no variant {name!r}: {VARIANTS}")
    try:
        yield
    finally:
        Q.compressed_pmean, Q._quantize_part, Q.spmd = saved


def readings(r: dict) -> dict:
    """The phase line's numbers its limits are read against."""
    t = r["first_step_ties"]
    out = {"off_not_ties": t["not_ties"], "elements": t["elements"],
           "ties_and_off": t["off"], "worst": t["worst"]}
    for i, after in enumerate(r["after_step"]):
        for part, leaves in after["leaf_rel_l2"].items():
            out[f"step{i + 1}_{part}"] = max(leaves.values())
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("phase24_faults: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch import kernels as ops
    names = sys.argv[1:] or list(VARIANTS)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, bad = {}, []
    for name in names:
        t0 = time.perf_counter()
        r = None
        with planted(name):
            try:
                with C.watchdog(C.MULTIPOD_WATCHDOG_S, f"phase 24 {name}"):
                    r = C.multipod_run(ops, card)
                C.multipod_checks(r)
                verdict = "passed"
            except C.SmokeFailure as e:
                verdict = f"failed: {e}"
        if (name == "sound") != (verdict == "passed"):
            bad.append(name)
        out[name] = {"verdict": verdict, "s": time.perf_counter() - t0,
                     **(readings(r) if r is not None else {})}
        print("VERDICT " + json.dumps({"variant": name, "verdict": verdict}),
              flush=True)
    print(json.dumps({"card": card, "variants": out, "wrong": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
