"""What the per-layer metrics of ``source`` ``program_span`` read: the
program's own spans (``repro_torch.core.spans``) of the profiled unit.
The profiler's session around that unit is the program's last recording
period, so its records are still there when the metrics are read after
the window. A program without spans, or a run without a profiled unit,
gives nothing to read, and such a metric is left out of the line."""
from __future__ import annotations

import importlib
from typing import List, Optional


def records(run) -> Optional[list]:
    """The profiled unit's span records, by host start; None where there
    are none."""
    if not run.traced or run.trace is None:
        return None
    try:
        spans = importlib.import_module("repro_torch.core.spans")
    except ImportError:                  # a program without spans
        return None
    return spans.records() or None


def host_ms(run, names) -> Optional[float]:
    """Host milliseconds in the profiled unit's spans named ``names``."""
    picked = [r for r in records(run) or () if r.name in names]
    return sum(r.host_ms for r in picked) if picked else None


def device_ms(picked: List) -> Optional[float]:
    """Device milliseconds of the spans ``picked``; None where there are
    none or one has no device time (off the card, or opened while a CUDA
    graph was captured)."""
    if not picked or any(r.device_ms is None for r in picked):
        return None
    return sum(r.device_ms for r in picked)


def named(run, name: str) -> List:
    return [r for r in records(run) or () if r.name == name]
