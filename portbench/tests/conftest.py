"""Tiny cells of the benchmark for the CPU tests: a copy of the harness
under a temporary root with configurations and mixes of their own, added
as new files and new ``BENCHMARK.json`` entries, the way a later change
adds a cell."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
for _p in (REPO / "src", REPO):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from portbench import run as bench_run  # noqa: E402
from portbench import spec  # noqa: E402

SMALL_LM = {"n_layers": 8, "d_model": 64, "n_heads": 8, "n_kv_heads": 2,
            "head_dim": 8, "d_ff": 128, "vocab": 256}
# each tiny cell: (config, its changes, mix, its changes, cards, the real
# cell whose metrics it reports)
TINY = {
    "jacobi": ("jacobi3d-768", {"domain": 12}, "solve2000-1card",
               {"sweeps": 30}, 2, "jacobi3d-768.solve2000-1card"),
    "prefill": ("yi-9b", SMALL_LM, "prefill-4x2048",
                {"batch": 2, "prompt_len": 128, "check_within": 3}, 1,
                "yi-9b.prefill-4x2048"),
    "decode": ("yi-9b", SMALL_LM, "decode-64x2048",
               {"batch": 4, "prompt_len": 16, "gen_steps": 8,
                "checked_requests": 2}, 1, "yi-9b.decode-64x2048"),
}


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def with_pending(bench: dict) -> dict:
    """``bench`` with the entries of ``portbench/pending/*.json`` added:
    the cells held back until the program's fault is mended, kept
    working on the CPU."""
    for f in sorted((spec.HERE / "pending").glob("*.json")):
        for key, entries in _json(f).items():
            bench[key] = bench[key] + entries
    return bench


def make_tiny(root: pathlib.Path):
    """A copy of the harness under ``root`` with one tiny cell per kind,
    added as files and entries only. Returns (bench, pkg)."""
    pkg = root / "portbench"
    shutil.copytree(spec.HERE, pkg,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = with_pending(spec.load_bench(REPO))
    for name, (conf, conf_changes, mix, mix_changes, cards,
               real) in TINY.items():
        c = dict(_json(pkg / "configs" / f"{conf}.json"), **conf_changes,
                 name=f"tiny-{name}")
        c["reduced"] = sorted(conf_changes) if conf == "yi-9b" else []
        (pkg / "configs" / f"tiny-{name}.json").write_text(json.dumps(c))
        m = dict(_json(pkg / "traffic" / f"{mix}.json"), **mix_changes)
        (pkg / "traffic" / f"tiny-{name}.json").write_text(json.dumps(m))
        bench["configs"].append({
            "name": f"tiny-{name}", "source": "test",
            "file": f"portbench/configs/tiny-{name}.json",
            "reduced": c["reduced"], "why": "test"})
        bench["workloads"].append({
            "name": f"tiny.{name}", "config": f"tiny-{name}",
            "traffic": f"tiny-{name}", "chips": cards, "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(f"tiny.{name}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, pkg


def run_tiny(bench, pkg, name: str, seed: int = 2 ** 31 + 11,
             traced: bool = False, seconds: float = 0.2):
    """One run of tiny cell ``name`` on the CPU (the look for a card
    skipped), with its result."""
    cell = spec.Cell(bench, f"tiny.{name}", pkg)
    run = bench_run.execute(bench_run.Run(cell, seed, seconds, traced, "cpu",
                                          pkg), shm_dir=None)
    return run, bench_run.result(run)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("portbench"))
