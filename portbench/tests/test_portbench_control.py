"""The control of each cell's check at a size a test run holds: the plain
reference put in the program's place in the nearest precision below the
configuration's (bfloat16 sweeps for the float32 stencil, float8 products
for the bfloat16 model) must fail at least one of the cell's numbers,
while the program on the same inputs passes them all. The same readings
at the cells' own sizes come from ``portbench/control.py`` on the card."""
from __future__ import annotations

import pytest

from portbench import control, spec


@pytest.mark.parametrize("name", ["jacobi", "prefill", "decode"])
def test_control_fails_where_the_program_passes(tiny, name):
    bench, pkg = tiny
    cell = spec.Cell(bench, f"tiny.{name}", pkg)
    got = control.readings(cell, 2 ** 31 + 23, 0.2, "cpu", pkg)
    assert got["correct"] and not got["problems"], got
    assert all(got["program"][k] <= got["limits"][k] for k in got["limits"])
    assert any(got["control"][k] > got["limits"][k] for k in got["limits"]), \
        got
