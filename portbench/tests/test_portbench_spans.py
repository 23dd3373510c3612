"""The per-layer metrics read from the program's own spans, on tiny traced
cells on the CPU: the host-time metrics read the profiled unit's spans,
the device-time ones are left out where no card timed them, and a program
without spans leaves them all out without failing the run."""
from __future__ import annotations

import sys

import pytest

from portbench import spec
from portbench.tests.conftest import SMALL_LM, run_tiny

SPAN_METRICS = {"yi-9b.decode-64x2048": {
    "runtime.setup_ms.decode", "serve.adopt_ms.decode",
    "replay.capture_ms.decode"},
    "yi-9b.prefill-4x2048": {
    "model.attention_ms.prefill", "model.mlp_ms.prefill",
    "model.norm_ms.prefill"}}
HOST = {"runtime.setup_ms.decode", "serve.adopt_ms.decode",
        "replay.capture_ms.decode"}


@pytest.fixture(scope="module")
def traced(tiny):
    """Each tiny cell's traced run, its result and the span records its
    metrics read (the last recording period's, taken before the next
    run)."""
    from repro_torch.core import spans
    bench, pkg = tiny
    out = {}
    for name in ("prefill", "decode"):
        run, res = run_tiny(bench, pkg, name, traced=True)
        out[name] = run, res, spans.records()
    return out


def test_the_span_metrics_are_the_programs(tiny):
    bench, _ = tiny
    ours = {m["name"]: m for m in bench["per_layer"]
            if m["source"] == "program_span"}
    assert set(ours) == set().union(*SPAN_METRICS.values())
    for cell, names in SPAN_METRICS.items():
        for n in names:
            assert cell in ours[n]["workloads"]
            assert (ours[n]["unit"], ours[n]["better"]) == ("ms", "lower")


def test_traced_decode_reads_the_host_span_metrics(traced):
    run, out, recs = traced["decode"]
    assert out["correct"] is True, out
    got = out["metrics"]
    for name in HOST:
        assert got[name]["value"] > 0, name
    # the program's counters are still read
    assert "replay.replayed_share.decode" in got
    gen = [r for r in recs if r.name == "serve.generation"]
    assert len(gen) == 1 and gen[0].attrs == {"steps": run.traffic[
        "gen_steps"]}


def test_traced_prefill_spans_its_batch(traced):
    run, out, recs = traced["prefill"]
    assert out["correct"] is True, out
    assert not set(out["metrics"]) & SPAN_METRICS["yi-9b.prefill-4x2048"]
    # the records read after the window are the profiled batch's alone
    names = [r.name for r in recs]
    assert names.count("engine.prefill") == 1
    assert names.count("model.attention") == SMALL_LM["n_layers"]


def test_a_program_without_spans_leaves_them_out(traced, tiny, monkeypatch):
    _, pkg = tiny
    run, _, _ = traced["decode"]
    monkeypatch.setitem(sys.modules, "repro_torch.core.spans", None)
    for name in set().union(*SPAN_METRICS.values()):
        assert spec.metric(name, pkg).read(run) is None, name
