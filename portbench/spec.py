"""Everything a cell is made of, found by name from files alone.

``BENCHMARK.json`` at the root names the cells, configurations and
metrics. A cell's configuration is the file its ``configs`` entry names
(``configs/<config>.json``); its traffic mix is ``traffic/<traffic>.json``;
the mix's ``kind`` names the module ``kinds/<kind>.py`` that runs that
kind of traffic through the program; each metric is read by
``metrics/<metric>.py``. Adding a cell, a configuration, a mix or a metric
is adding files and entries: nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import types
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent


class Cell:
    """One entry of ``workloads`` with what it names loaded: ``config``
    and ``traffic`` (dicts read from their files), ``chips``, and the
    metrics it reports with ``--trace 0`` (``end_to_end``) and ``--trace 1``
    (``per_layer``), each the metric's ``BENCHMARK.json`` entry."""

    def __init__(self, bench: dict, name: str, pkg: pathlib.Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                           f"{sorted(cells)}")
        w = cells[name]
        self.name = name
        self.chips = w["chips"]
        self.config_name = w["config"]
        self.traffic_name = w["traffic"]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.config = json.loads((pkg.parent / conf["file"]).read_text())
        self.traffic = json.loads(
            (pkg / "traffic" / f"{w['traffic']}.json").read_text())
        self.end_to_end = _mine(bench["end_to_end"], name)
        self.per_layer = _mine(bench["per_layer"], name)


def _mine(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_bench(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def module(path: pathlib.Path) -> types.ModuleType:
    """The Python file at ``path``, loaded by its path (a metric's file is
    named by the metric, dots and all)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, pkg: pathlib.Path = HERE) -> types.ModuleType:
    """The module that runs traffic of kind ``name``."""
    return module(pkg / "kinds" / f"{name}.py")


def metric(name: str, pkg: pathlib.Path = HERE) -> types.ModuleType:
    return module(pkg / "metrics" / f"{name}.py")


def patterns(name: str, pkg: pathlib.Path = HERE) -> List[str]:
    """The kernel-name patterns of metric ``name``: every non-empty line
    not starting with ``#`` of every file in ``metrics/patterns/<name>/``
    (one file per implementation; a later one is a file added)."""
    out: List[str] = []
    d = pkg / "metrics" / "patterns" / name
    for f in sorted(d.glob("*.txt")) if d.is_dir() else []:
        out += [ln.strip() for ln in f.read_text().splitlines()
                if ln.strip() and not ln.lstrip().startswith("#")]
    return out


def all_metrics(bench: dict) -> Dict[str, dict]:
    return {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
