"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. It looks up the cell in ``BENCHMARK.json``,
sets up (weights and inputs drawn from the seed, the program built and
every shape the cell uses warmed up: ``setup_s``), drives the cell's
traffic through the program for ``--seconds`` in a closed loop of whole
units (solves, batches, generations), reads the card's peak memory, frees
the program, checks the outputs against the plain reference, and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics: one unit runs under the profiler
before the window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number compared beside its limit (also the last lines on
standard error). A run is correct only if every number is within its
limit, every unit finished, the card's allocation came back after each
unit to its level after warm-up, and nothing was written to /dev/shm.

It needs as many CUDA cards as the cell asks for, and exits with another
code than 0 and prints no result where there are fewer, where the program
(``src/repro_torch``) is not in the checkout, or where the process has
loaded JAX or the JAX package (``repro``) by the time the window closes.
The program's kernels build into ``build/repro_torch/`` inside the
checkout at the first run and are found there by later runs.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import sys
import time
import traceback
from typing import Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from portbench import spec, trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
MEMORY_SLACK = 64 << 20      # bytes a card may hold after a unit over its
#                               level after warm-up (workspaces, rounding)


class Run:
    """What one run of a cell knows: its inputs, the program's units and
    counters, the profiled unit's trace, and the checks. The traffic's
    kind module fills the units and counters; metric readers read them."""

    def __init__(self, cell: spec.Cell, seed: int, seconds: float,
                 traced: bool, device: str, pkg: pathlib.Path):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.seconds = seconds
        self.traced = traced
        self.on_card = device == "cuda"
        self.cards = cell.chips
        self.device = torch.device("cuda", 0) if self.on_card \
            else torch.device("cpu")
        self.pkg = pkg
        self.setup_s: Optional[float] = None
        self.units: List[dict] = []
        self.window_s: Optional[float] = None
        self.counters: Dict[str, float] = {}
        self.trace: Optional[trace.Trace] = None
        self.checks: Dict[str, dict] = {}
        self.problems: List[str] = []
        self.attempted = 0
        self.failed = 0
        self.peak_bytes = 0
        self.card = torch.cuda.get_device_name(0) if self.on_card else "cpu"
        self.state = None         # the kind module's, after the check

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared: the run is correct only if ``value`` is at
        most ``limit``."""
        self.checks[name] = {"value": value, "limit": limit}

    @property
    def correct(self) -> bool:
        return (not self.problems and self.failed == 0 and self.units != []
                and bool(self.checks)
                and all(c["value"] <= c["limit"]
                        for c in self.checks.values()))


def _sync(run: Run) -> None:
    if run.on_card:
        for i in range(run.cards):
            torch.cuda.synchronize(i)


def _allocated(run: Run) -> List[int]:
    """Bytes allocated on each card, without cuBLAS's workspaces: PyTorch
    keeps one for every stream cuBLAS has run on (each runtime's streams,
    drawn from PyTorch's pool of 32 a card), freed here first, so that
    what is compared is what the program holds."""
    if not run.on_card:
        return []
    torch._C._cuda_clearCublasWorkspaces()
    return [torch.cuda.memory_allocated(i) for i in range(run.cards)]


def _shm(shm_dir: Optional[str]) -> set:
    if shm_dir is None or not os.path.isdir(shm_dir):
        return set()
    return set(os.listdir(shm_dir))


def _failed(run: Run, i: int) -> None:
    traceback.print_exc()
    n = run.traffic.get("requests_per_unit", 1)
    run.attempted += n
    run.failed += n
    run.problems.append(f"unit {i} raised")


def _record(run: Run, rec: dict, base: List[int]) -> None:
    """Keep a unit's record; the card's allocation after it must come
    back to its level after warm-up."""
    rec["allocated"] = _allocated(run)
    run.units.append(rec)
    run.attempted += rec.get("requests", 1)
    i = len(run.units) - 1
    for card, (b, now) in enumerate(zip(base, rec["allocated"])):
        if now > b + MEMORY_SLACK:
            run.problems.append(
                f"card {card} holds {now} B after unit {i}, "
                f"{now - b} B over its level after warm-up")


def execute(run: Run, shm_dir: Optional[str] = "/dev/shm") -> Run:
    """Set up, measure and check ``run`` (everything but the look for a
    card and the printing)."""
    kind = spec.kind(run.traffic["kind"], run.pkg)
    shm0 = _shm(shm_dir)
    t0 = time.perf_counter()
    state = kind.setup(run)
    _sync(run)
    run.setup_s = time.perf_counter() - t0
    gc.collect()
    base = _allocated(run)
    if run.traced:
        # the profiled unit runs before the window: the profiler's reading
        # of its events takes longer than the unit
        try:
            rec, run.trace, t0, t1 = trace.profiled(
                lambda: kind.unit(run, state, 0), run.cards, run.on_card)
        except Exception:                       # the program failed a unit
            _failed(run, 0)
        else:
            _record(run, dict(rec, t0=t0, t1=t1), base)
    start = time.perf_counter()
    while not run.problems and (
            run.units == [] or time.perf_counter() - start < run.seconds):
        i = len(run.units)
        t0 = time.perf_counter()
        try:
            rec = kind.unit(run, state, i)
        except Exception:                       # the program failed a unit
            _failed(run, i)
            break
        _record(run, dict(rec, t0=t0, t1=time.perf_counter()), base)
    run.window_s = time.perf_counter() - start
    run.counters = kind.counters(run, state)
    if run.on_card:
        run.peak_bytes = max(torch.cuda.max_memory_allocated(c)
                             for c in range(run.cards))
    new_shm = _shm(shm_dir) - shm0
    if new_shm:
        run.problems.append(f"the run wrote to {shm_dir}: {sorted(new_shm)}")
    kind.release(run, state)
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
    if run.units:
        kind.check(run, state)
    run.state = state
    return run


def read_metrics(run: Run) -> Dict[str, dict]:
    """The cell's metrics for this run (per-layer where traced), each by
    its own reader; a reader that finds nothing to read gives None and the
    metric is left out."""
    out = {}
    for m in run.cell.per_layer if run.traced else run.cell.end_to_end:
        value = spec.metric(m["name"], run.pkg).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit_w() -> Optional[float]:
    """The first card's power limit as ``nvidia-smi`` reads it."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def result(run: Run) -> dict:
    metrics = read_metrics(run)
    device = {"platform": "gpu" if run.on_card else "cpu", "kind": run.card,
              "count": run.cards, "memory_peak_bytes": run.peak_bytes,
              "power_limit_w": power_limit_w() if run.on_card else None}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced and run.trace is not None:
        busy = trace.busy_s(run.trace)
        if busy is not None:
            device["busy_s"] = busy
            device["window_s"] = run.trace.window_s
        out["breakdown"] = trace.breakdown(run.trace)
    out["checks"] = dict(run.checks, **{
        f"problem_{k}": {"value": 1, "limit": 0}
        for k in range(len(run.problems))})
    return out


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load_bench(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    run = execute(Run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", spec.HERE))
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}: the benchmark runs "
              f"the port alone", file=sys.stderr)
        return 3
    out = result(run)
    print("units (s, bytes allocated after): " + " ".join(
        f"{u['t1'] - u['t0']:.4f}/{max(u['allocated'], default=0)}"
        for u in run.units), file=sys.stderr)
    for p in run.problems:
        print(f"problem: {p}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
