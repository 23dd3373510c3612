"""The trace reduction on a hand-made trace, and what the harness loads."""
from __future__ import annotations

import subprocess
import sys
import textwrap

from portbench import trace
from portbench.tests.conftest import REPO

MS = 1_000_000


def _trace():
    dev = [("gemm", 0, 4 * MS, 0), ("flash_mma_kernel<1>", 3 * MS, 5 * MS, 0),
           ("Memcpy DtoD (Device -> Device)", 8 * MS, 9 * MS, 0),
           ("gemm", 0, 2 * MS, 1), ("gemm", 6 * MS, 9 * MS, 1)]
    host = [("run", 0, 10 * MS), ("cudaStreamSynchronize", 5 * MS, 8 * MS),
            ("aten::copy_", 2 * MS, 6 * MS)]
    return trace.Trace(dev, host, 0.010, 2)


def test_busy_and_idle():
    tr = _trace()
    # card 0 busy 0-5 and 8-9 ms, card 1 0-2 and 6-9: 6 and 5 ms
    assert abs(trace.busy_s(tr) - 0.0055) < 1e-12
    assert abs(trace.idle_share(tr) - 0.45) < 1e-9
    assert trace.busy_s(trace.Trace([], [], 1.0, 1)) is None


def test_matching_and_names():
    tr = _trace()
    s, n = trace.matching_s(tr, ["flash_mma_kernel", "flash_wgmma"])
    assert (round(s, 9), n) == (0.002, 1)
    assert trace.matching_s(tr, []) == (0.0, 0)
    assert abs(trace.by_name(tr)["gemm"] - 0.009) < 1e-12


def test_idle_gaps_by_host_operation():
    gaps = trace.idle_by_host(_trace())
    # card 0 idles 5-8 ms (middle 6.5: under the sync), card 1 2-6 ms
    # (middle 4: under the copy, shorter than the run)
    assert abs(gaps["host: cudaStreamSynchronize"] - 0.0015) < 1e-12
    assert abs(gaps["host: aten::copy_"] - 0.002) < 1e-12
    b = trace.breakdown(_trace())
    assert b["device_ops"][0][0] == "gemm" and len(b["idle_gaps"]) == 2


def test_harness_loads_neither_jax_nor_the_jax_package():
    """Importing the harness and everything a run of each cell loads
    (traffic kinds, readers, references and the program's modules) leaves no
    module whose top-level name is jax, jaxlib, flax or repro."""
    code = textwrap.dedent("""
        import sys
        sys.path[:0] = [%r, %r]
        from portbench import run, spec, control
        bench = spec.load_bench(run.ROOT)
        for w in bench["workloads"]:
            cell = spec.Cell(bench, w["name"])
            spec.kind(cell.traffic["kind"])
            for m in cell.end_to_end + cell.per_layer:
                spec.metric(m["name"])
        import repro_torch.apps.jacobi3d, repro_torch.launch.serve
        import repro_torch.serve, repro_torch.core, repro_torch.models
        print(run.forbidden_modules())
    """ % (str(REPO / "src"), str(REPO)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules().count("repro") == 1
    assert "repro_torch_lookalike" not in run.forbidden_modules()
