"""What the metric readers share: the units a rate is taken over, the
card's peaks, and the profiled unit."""
from __future__ import annotations

from typing import List, Optional

from portbench.counts import work


def timed_units(run) -> List[dict]:
    """The units a host-clock share is taken over: in a traced run every
    unit but the profiled one, where there are others."""
    units = run.units
    return units[1:] if run.traced and len(units) > 1 else units


def seconds(units: List[dict]) -> float:
    return sum(u["t1"] - u["t0"] for u in units)


def peak(run) -> Optional[dict]:
    """The peak row of the run's card; None off the card, or for a card the
    table does not hold."""
    return work.peaks(run.card) if run.on_card else None


def percent(x: Optional[float]) -> Optional[float]:
    return None if x is None else 100.0 * x
