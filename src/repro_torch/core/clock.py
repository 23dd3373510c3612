"""Injectable clock plumbing — the ONE place `core/` and `distributed/`
may read a clock for deadline arithmetic.

Wall clocks (`time.time`) step under NTP adjustment and make timeout
logic silently wrong; `tools/lint_runtime.py` therefore bans
`time.time()`/`time.monotonic()` calls in `core/` + `distributed/`
outside this module (`time.perf_counter` stays allowed — it is the
measurement clock, never a deadline clock). Deadline code calls
``clock.now()``; components that take an injectable clock parameter
(e.g. ``ElasticController(clock=...)``) default it to ``clock.monotonic``
so tests can substitute a virtual clock.
"""
from __future__ import annotations

import time

# injectable default for components that accept a clock callable
monotonic = time.monotonic


def now() -> float:
    """Monotonic seconds for deadline/timeout arithmetic. Never a wall
    clock: immune to NTP steps and daylight-saving jumps."""
    return monotonic()
