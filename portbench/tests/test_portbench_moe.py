"""The MoE prefill cell (kind ``moe_prefill_batches``, configuration
``olmoe-1b-7b-0924``) at a small size on the CPU: a sound run is correct,
each planted fault in the MoE model's own parts and the float8 control
turn ``correct`` false, the configuration file is the program's, the
counters read the dense fallback's E / k, and the frozen counts give the
figures the cell is read against."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import control, spec
from portbench.counts import moe as moe_counts
from portbench.counts import work
from portbench.tests.conftest import REPO, _json, make_tiny, run_tiny

OLMOE = _json(REPO / "portbench/configs/olmoe-1b-7b-0924.json")
SMALL_MOE = {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
             "head_dim": 16, "d_ff": 32, "vocab": 256, "num_experts": 8,
             "top_k": 2, "d_ff_expert": 32}
CELL = "olmoe-1b-7b-0924.moe-prefill-4x2048"


@pytest.fixture(scope="module")
def tiny_moe(tmp_path_factory):
    """The tiny harness copy with one more cell, ``tiny.moe``, added as a
    configuration file, a mix file and entries, reporting what the real
    MoE cell reports."""
    root = tmp_path_factory.mktemp("portbench_moe")
    bench, pkg = make_tiny(root)
    conf = dict(OLMOE, **SMALL_MOE, name="tiny-moe",
                reduced=sorted(SMALL_MOE))
    (pkg / "configs" / "tiny-moe.json").write_text(json.dumps(conf))
    mix = dict(_json(pkg / "traffic" / "moe-prefill-4x2048.json"),
               batch=2, prompt_len=128, check_within=3)
    (pkg / "traffic" / "tiny-moe.json").write_text(json.dumps(mix))
    bench["configs"].append({
        "name": "tiny-moe", "source": "test",
        "file": "portbench/configs/tiny-moe.json",
        "reduced": conf["reduced"], "why": "test"})
    bench["workloads"].append({
        "name": "tiny.moe", "config": "tiny-moe", "traffic": "tiny-moe",
        "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny.moe")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, pkg


def _route_patched(monkeypatch, change):
    import repro_torch.models.moe as M
    real = M._route

    def route(router_w, x, mcfg):
        w, idx, aux = real(router_w, x, mcfg)
        return change(w), idx, aux
    monkeypatch.setattr(M, "_route", route)


def _qk_norm_left_out(monkeypatch):
    import repro_torch.models.attention as A
    monkeypatch.setattr(A, "qk_norm", lambda params, q, k, eps: (q, k))


def _renormalised(monkeypatch):
    _route_patched(monkeypatch, lambda w: w / w.sum(-1, keepdim=True))


def _expert_dropped(monkeypatch):
    """The last of each token's top-k experts left out of its sum."""
    def drop(w):
        w = w.clone()
        w[:, -1] = 0
        return w
    _route_patched(monkeypatch, drop)


FAULTS = {"QK-norm left out": _qk_norm_left_out,
          "top-k renormalised": _renormalised,
          "one of the top-k experts dropped": _expert_dropped}


def test_sound_run_is_correct_and_counts_rows(tiny_moe):
    bench, pkg = tiny_moe
    run, out = run_tiny(bench, pkg, "moe", traced=True)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"logits_rel_err", "kv_rel_err",
                                  "first_token_mismatch"}
    # the dense fallback: every expert on every token, E / k = 8 / 2
    assert out["metrics"]["moe.expert_rows_ratio.prefill"]["value"] == 4.0
    b, s = run.traffic["batch"], run.traffic["prompt_len"]
    assert run.counters["routed_rows"] == \
        (len(run.units) - 1) * b * s * 2 * SMALL_MOE["n_layers"]
    # no card: no peak to take a share of
    assert "moe_prefill.mfu" not in out["metrics"]
    from repro_torch.core import spans
    names = [r.name for r in spans.records()]
    for n in ("moe.route", "moe.experts", "moe.combine"):
        assert names.count(n) == SMALL_MOE["n_layers"], n


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_turns_correct_false(tiny_moe, monkeypatch, fault):
    bench, pkg = tiny_moe
    FAULTS[fault](monkeypatch)
    run, out = run_tiny(bench, pkg, "moe")
    assert out["correct"] is False, (fault, out["checks"], run.problems)


def test_control_fails_where_the_program_passes(tiny_moe):
    bench, pkg = tiny_moe
    cell = spec.Cell(bench, "tiny.moe", pkg)
    got = control.readings(cell, 2 ** 31 + 23, 0.2, "cpu", pkg)
    assert got["correct"] and not got["problems"], got
    assert all(got["program"][k] <= got["limits"][k] for k in got["limits"])
    assert any(got["control"][k] > got["limits"][k] for k in got["limits"]), \
        got
    assert 0 <= got["control"]["near_tie_share"] <= 1


def test_config_file_agrees_with_the_program():
    from repro_torch.configs import get_config
    kind = spec.kind("moe_prefill_batches")
    assert kind.port_config(OLMOE) == get_config("olmoe-1b-7b-0924")
    for key, wrong in (("norm_topk_prob", True), ("qk_norm", False),
                       ("top_k", 2), ("norm_eps", 1e-6)):
        with pytest.raises(ValueError, match=key):
            kind.port_config(dict(OLMOE, **{key: wrong}))
    # 6.92 B parameters, 13.84 GB in bf16
    shapes = kind.shapes(OLMOE)
    n = sum(torch.Size(s).numel() for s, _, _ in shapes.values())
    assert n == pytest.approx(6.92e9, rel=1e-3)


def test_moe_counts():
    small = dict(SMALL_MOE, n_layers=2, d_model=8, n_heads=2, n_kv_heads=2,
                 head_dim=4, num_experts=4, top_k=2, d_ff_expert=3,
                 vocab=10)
    # q, k, v, o 8x8 each; two experts of three 8x3 products; router 8x4
    assert moe_counts.attention_params(small) == 4 * 64
    assert moe_counts.routed_expert_params(small) == 2 * 3 * 24
    assert moe_counts.prefill_flops(small, 1, 3) == \
        2 * 2 * (256 + 144 + 32) * 3 \
        + 2 * work.causal_attention_flops(1, 3, 2, 4) + 2 * 8 * 10
    # the cell's shape: 1.763e13 of products, 1.10e12 of attention, 8.2e8
    # of unembedding; 18.9 ms at the bf16 peak
    f = moe_counts.prefill_flops(OLMOE, 4, 2048)
    assert f == pytest.approx(1.873e13, rel=1e-3)
    assert 16 * work.causal_attention_flops(4, 2048, 16, 128) == \
        pytest.approx(1.10e12, rel=1e-2)
    assert f / 989e12 * 1e3 == pytest.approx(18.9, rel=1e-2)
