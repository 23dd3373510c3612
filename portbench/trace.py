"""The device trace of one profiled unit of work, and its reduction to
busy time, time by operation name and idle gaps.

The profiler's events are kept in memory as (name, start, end, card)
tuples read straight from its raw results, so that a unit of half a
million kernels (a generation of replayed decode steps) reduces in
seconds; nothing is written to disk.
"""
from __future__ import annotations

import heapq
import re
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

NAME_LEN = 120


class Trace:
    """``device``: (name, start_ns, end_ns, card) of every kernel, copy and
    set on the cards; ``host``: (name, start_ns, end_ns) of every host
    operation the profiler saw; ``window_s``: the unit's length by the
    host clock; ``cards``: the cards the run uses."""

    def __init__(self, device, host, window_s: float, cards: int):
        self.device: List[Tuple[str, int, int, int]] = device
        self.host: List[Tuple[str, int, int]] = host
        self.window_s = window_s
        self.cards = cards


def profiled(fn: Callable[[], object], cards: int, on_card: bool):
    """Run ``fn`` under the profiler; returns its result, its Trace, and
    when it started and ended by the host clock (the profiler's own
    reading of its events comes after)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        t1 = time.perf_counter()
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == torch.autograd.DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.end_ns(), e.device_index()))
        elif kind == torch.autograd.DeviceType.CPU:
            host.append((e.name(), e.start_ns(), e.end_ns()))
    return out, Trace(dev, host, t1 - t0, cards), t0, t1


def _union(intervals) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def busy_s(tr: Trace) -> Optional[float]:
    """Seconds in which an operation ran, per card, averaged over the
    cards the run uses; None where the trace saw no device operation."""
    if not tr.device:
        return None
    total = 0
    for card in range(tr.cards):
        total += sum(b - a for a, b in _union(
            (s, e) for _, s, e, c in tr.device if c == card))
    return total / tr.cards / 1e9


def idle_share(tr: Trace) -> Optional[float]:
    busy = busy_s(tr)
    if busy is None or tr.window_s <= 0:
        return None
    return 1.0 - busy / tr.window_s


def matching_s(tr: Trace, patterns: Sequence[str]) -> Tuple[float, int]:
    """Seconds (summed over cards) and count of the device operations whose
    names match any of ``patterns`` (regular expressions)."""
    if not patterns:
        return 0.0, 0
    rx = re.compile("|".join(f"(?:{p})" for p in patterns))
    ns, n = 0, 0
    for name, s, e, _ in tr.device:
        if rx.search(name):
            ns += e - s
            n += 1
    return ns / 1e9, n


def by_name(tr: Trace) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name, s, e, _ in tr.device:
        key = name[:NAME_LEN]
        out[key] = out.get(key, 0.0) + (e - s) / 1e9
    return out


def idle_by_host(tr: Trace, min_gap_ns: int = 20_000) -> Dict[str, float]:
    """Idle seconds of the cards in gaps of ``min_gap_ns`` or more, summed
    by what the host was doing at each gap's middle: the shortest host
    operation that spans it (averaged over the cards)."""
    gaps = []
    for card in range(tr.cards):
        busy = _union((s, e) for _, s, e, c in tr.device if c == card)
        gaps += [((a + b) // 2, b - a) for (_, a), (b, _) in
                 zip(busy, busy[1:]) if b - a >= min_gap_ns]
    host = sorted(tr.host, key=lambda h: h[1])
    out: Dict[str, float] = {}
    active: list = []           # (duration, end, name): shortest on top
    i = 0
    for mid, length in sorted(gaps):
        while i < len(host) and host[i][1] <= mid:
            name, s, e = host[i]
            heapq.heappush(active, (e - s, e, name))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)    # ended before this gap and every later
        label = f"host: {active[0][2][:NAME_LEN]}" if active else \
            "host: no profiled operation"
        out[label] = out.get(label, 0.0) + length / 1e9 / tr.cards
    return out


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time and the ten host
    operations under which the cards idled longest."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:10]]
    return {"device_ops": top(by_name(tr)), "idle_gaps": top(idle_by_host(tr))}
