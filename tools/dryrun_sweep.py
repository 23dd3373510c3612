"""Lower every (arch x shape) cell of ``configs.all_cells()`` at the
``baseline`` and ``opt`` levels on 8 ``meta`` shards (one HGX H100 node)
with ``repro_torch.launch.dryrun``, then write the roofline table of each
level and the tuned configs. Needs no card.

    PYTHONPATH=src python tools/dryrun_sweep.py [--chips 8] [--workers 4]
        [--levels baseline opt] [--only yi_9b] [--shapes train_4k]
        [--multi-pod] [--data 2]

Each cell runs in a worker process; its result (or the error it raised,
under ``error``) goes to ``build/repro_torch/dryrun/
{arch}__{shape}__tp{chips}__{level}.json`` (``launch.dryrun.result_path``:
``pod2``/``dp{data}`` before ``tp`` with ``--multi-pod``/``--data``,
``launch.dryrun.build_cell``'s meshes). A cell whose file holds a
result is not lowered again ("cached"; delete the file to force it), as
the JAX package's sweep does. On ``(1, chips)`` the tables go to
``build/repro_torch/roofline_{level}.json`` and
``build/repro_torch/tuned_configs.json`` (they read that mesh's files
alone). Prints each cell's seconds and the sweep's wall time.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _one(arch: str, shape: str, chips: int, level: str, out: str,
         multi_pod: bool, data: int):
    # one torch thread a worker: meta runs compute nothing
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.dryrun import lower_cell
    t0 = time.perf_counter()
    try:
        res = lower_cell(arch, shape, chips=chips, opt_level=level,
                         multi_pod=multi_pod, data=data)
    except Exception as e:  # recorded, as the JAX sweep records it
        res = {"arch": arch, "shape": shape, "opt_level": level,
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
    res["wall_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    return arch, shape, level, res.get("error"), res["wall_s"]


def _done(path: str) -> bool:
    if not os.path.exists(path):
        return False
    with open(path) as f:
        return "error" not in json.load(f)


def main() -> int:
    from repro_torch.configs import all_cells
    from repro_torch.launch import autotune, roofline
    from repro_torch.launch.dryrun import RESULTS, result_path
    ap = argparse.ArgumentParser()
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--levels", nargs="+", default=["baseline", "opt"])
    ap.add_argument("--only", default=None, help="one architecture")
    ap.add_argument("--shapes", nargs="+", default=None,
                    help="only these shapes (e.g. train_4k prefill_32k)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--data", type=int, default=1)
    args = ap.parse_args()
    os.makedirs(RESULTS, exist_ok=True)
    mesh = dict(multi_pod=args.multi_pod, data=args.data)
    jobs = [(arch, shape.name, args.chips, level,
             result_path(RESULTS, arch, shape.name, args.chips, level,
                         **mesh))
            for level in args.levels for arch, shape in all_cells()
            if args.only in (None, arch)
            and (args.shapes is None or shape.name in args.shapes)]
    cached = [j for j in jobs if _done(j[-1])]
    for arch, shape, _, level, _ in cached:
        print(f"{arch:24s} {shape:12s} {level:9s} cached", flush=True)
    jobs = [j for j in jobs if j not in cached]
    t0 = time.perf_counter()
    errors = 0
    ctx = multiprocessing.get_context("spawn")
    with cf.ProcessPoolExecutor(args.workers, mp_context=ctx) as pool:
        for fut in cf.as_completed([pool.submit(_one, *j, args.multi_pod,
                                                args.data) for j in jobs]):
            arch, shape, level, err, secs = fut.result()
            errors += err is not None
            print(f"{arch:24s} {shape:12s} {level:9s} {secs:7.1f} s"
                  + (f"  ERROR {err}" if err else ""), flush=True)
    wall = time.perf_counter() - t0
    print(f"sweep: {len(jobs)} lowerings on {args.chips} meta shards "
          f"({len(cached)} cached), {errors} errors, {wall:.1f} s wall "
          f"with {args.workers} workers")
    if args.multi_pod or args.data != 1:
        return 1 if errors else 0
    base = os.path.dirname(RESULTS)
    for level in args.levels:
        rows = roofline.build_table(RESULTS, level, args.chips)
        with open(os.path.join(base, f"roofline_{level}.json"), "w") as f:
            json.dump(rows, f, indent=1)
    if {"baseline", "opt"} <= set(args.levels):
        with open(autotune.TUNED, "w") as f:
            json.dump(autotune.tune(RESULTS, args.chips), f, indent=1)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
