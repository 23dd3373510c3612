"""The control of a cell's check, on the card: for each seed, one short run
of the cell (the program's readings of the numbers compared) and then the
control's readings on the same inputs: the plain reference put in the
program's place, computed in the nearest precision below the one the
configuration states (each traffic kind's ``control``). A sound limit lies
above every program reading and below every control reading.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 1] [--out control.jsonl]

The benchmark's own runs never run it. Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from portbench import run as bench_run  # noqa: E402
from portbench import spec  # noqa: E402


def readings(cell: spec.Cell, seed: int, seconds: float, device: str,
             pkg: pathlib.Path = spec.HERE) -> dict:
    """The program's and the control's readings of one seed."""
    run = bench_run.execute(bench_run.Run(cell, seed, seconds, False, device,
                                          pkg), shm_dir=None)
    kind = spec.kind(cell.traffic["kind"], pkg)
    out = {"seed": seed, "correct": run.correct, "problems": run.problems,
           "program": {k: c["value"] for k, c in run.checks.items()},
           "limits": {k: c["limit"] for k, c in run.checks.items()},
           "control": kind.control(run, run.state)}
    run.state = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.Cell(spec.load_bench(ROOT), args.workload)
    for seed in args.seeds:
        line = json.dumps(readings(cell, seed, args.seconds, "cuda"))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
