"""The benchmark's definition against its rules, from files alone:
every cell, configuration, mix and metric found by name; names, units and
keys within their limits; each per-layer metric's end-to-end metric
reported wherever it is; a new cell added as new files runs with no edit;
the result line's keys."""
from __future__ import annotations

import json
import re

import pytest

from portbench import spec
from portbench.tests.conftest import REPO, run_tiny, with_pending

BENCH = spec.load_bench(REPO)
WITH_PENDING = with_pending(spec.load_bench(REPO))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expan|experts_per_tok|d_model|d_ff")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and \
        1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("bench", [BENCH, WITH_PENDING],
                         ids=["benchmark", "with_pending"])
def test_names_units_and_texts(bench):
    names = [c["name"] for c in bench["configs"]] + \
        [w["name"] for w in bench["workloads"]] + \
        [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for n in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(n), n
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
        assert c["file"].startswith("portbench/configs/")
        assert len(c["reduced"]) <= 16
        assert not [k for k in c["reduced"] if WIDTH.search(k)]


def test_every_piece_found_by_name():
    for w in BENCH["workloads"]:
        cell = spec.Cell(BENCH, w["name"])
        assert cell.config["name"] == w["config"]
        assert (spec.HERE / "kinds" / f"{cell.traffic['kind']}.py").exists()
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric(m["name"]).read)
    files = {p.stem for p in (spec.HERE / "metrics").glob("*.py")}
    assert files == set(spec.all_metrics(WITH_PENDING))


@pytest.mark.parametrize("bench", [BENCH, WITH_PENDING],
                         ids=["benchmark", "with_pending"])
def test_metric_files_agree_with_the_definition(bench):
    for m in bench["end_to_end"]:
        mod = spec.metric(m["name"])
        assert set(m) - {"workloads"} == E2E_KEYS
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == \
            (m["unit"], m["better"], m["source"])
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        mod = spec.metric(m["name"])
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == \
            (m["unit"], m["better"], m["source"], m["layer"], m["moves"])
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


@pytest.mark.parametrize("bench", [BENCH, WITH_PENDING],
                         ids=["benchmark", "with_pending"])
def test_each_metric_moves_what_its_cells_report(bench):
    for w in bench["workloads"]:
        cell = spec.Cell(bench, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("bench", [BENCH, WITH_PENDING],
                         ids=["benchmark", "with_pending"])
def test_share_metrics_are_named_as_shares(bench):
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_pattern_files_name_kernels():
    for name in ("flash_roofline", "stencil_roofline",
                 "replay.copy_ms_per_sweep"):
        assert spec.patterns(name)


@pytest.mark.parametrize("name", ["jacobi", "prefill", "decode"])
def test_a_new_cell_added_as_files_runs(tiny, name):
    """A tiny cell of each kind, added under a copy of the harness as new
    configuration and mix files and new entries, runs and reports the
    result line with exactly its five keys, its end-to-end metrics
    and its checks last."""
    bench, pkg = tiny
    run, out = run_tiny(bench, pkg, name)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True, out
    assert set(out["metrics"]) == {
        m["name"] for m in spec.Cell(bench, f"tiny.{name}", pkg).end_to_end}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)


def test_a_traced_run_adds_the_breakdown(tiny):
    bench, pkg = tiny
    run, out = run_tiny(bench, pkg, "jacobi", traced=True)
    assert list(out)[-2:] == ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the program's counters are read on the CPU too; the device's only
    # on the card
    assert "replay.replayed_share.jacobi" in out["metrics"]
