"""Spans: named intervals of the program's work, on the profiler's clock.

    from repro_torch.core import spans

    with spans.span("runtime.barrier"):
        ...
    with spans.recording():           # or inside any torch.profiler session
        run_the_work()
    for r in spans.records():
        print(r.name, r.host_ms, r.device_ms, r.request, r.parent)

A record holds the span's name, the id of the span open around it on the
same thread (``parent``), the request it serves, its thread, its host start
and end (``time.perf_counter_ns``), its attributes and, on a card, the
device milliseconds between two CUDA events recorded at its start and at
its end on the stream it times: the one its opener names (``stream=``),
else the stream current where it opened (None off the card, and for a
span opened while that stream captures a CUDA graph: no event is
recorded then). Where the host is slower than the card, that is the
host's pace, not the kernels' time.

A request id is opened by a serving entry point (``request``: one prefill
batch, one generation); every span beneath it on the same thread carries
it, and a task carries it from ``Runtime.submit`` to the worker that
launches it (``current_request``, ``span(..., request=)``).

Recording is on while the torch profiler runs and inside ``recording()``;
each time it turns on from off a new recording period starts, and
``records()`` gives the last period's. Off, a span is one check of a
module-level flag: no profiler call, no CUDA event, no record. While the
profiler runs each span also puts a host mark on its timeline (a plain CPU
operation to the profiler, so it never becomes a device-side range), which
lets a trace name what the host was doing in each of the card's idle gaps.
The profiler keeps the CPU operations, marks included, of the thread that
started it; those of the runtime's worker threads only with its
``profile_all_threads`` option.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _profiler

from repro_torch.core import sanitizer

__all__ = ["Record", "span", "request", "spanned", "recording", "records",
           "current_request"]

# the host mark a span puts on the profiler's timeline
_mark = torch._C._profiler._RecordFunctionFast

_on = False             # recording: the profiler runs, or recording() is open
_profiling = False      # the torch profiler runs
_opened = 0             # recording() blocks open
_records: List["Record"] = []      # the current period's, in opening order
_state_lock = sanitizer.make_lock("spans._state_lock")
_local = threading.local()         # .stack: the thread's open records
_ids = itertools.count()
_requests = itertools.count(1)
# timing events read, reusable on the card that recorded them, by its index
_free_events: Dict[int, List["torch.cuda.Event"]] = {}
# current streams by (card, raw handle): a default stream's handle is 0 on
# every card
_streams: Dict[tuple, "torch.cuda.Stream"] = {}


@dataclasses.dataclass
class Record:
    id: int
    name: str
    parent: Optional[int]
    request: Optional[int]
    thread: str
    start_ns: int
    end_ns: int
    attrs: Dict[str, Any]
    device_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_NULL = contextlib.nullcontext()        # what a span is while recording is off


def _current_stream() -> "torch.cuda.Stream":
    """``torch.cuda.current_stream()``, looked up by card and raw handle:
    the wrapper costs about as much as recording an event."""
    device = torch._C._cuda_getDevice()
    key = (device, torch._C._cuda_getCurrentRawStream(device))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(device)
    return stream


def _capturing(stream: Optional["torch.cuda.Stream"]) -> bool:
    """Whether ``stream`` (None: the current one) captures a CUDA graph."""
    if stream is None:
        return torch.cuda.is_current_stream_capturing()
    with torch.cuda.stream(stream):
        return torch.cuda.is_current_stream_capturing()


def _event(device: int) -> "torch.cuda.Event":
    try:
        return _free_events[device].pop()
    except (KeyError, IndexError):
        return torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("rec", "mark", "stream", "stack")

    def __init__(self, name: str, req: Optional[int], attrs: Dict[str, Any],
                 stream: Optional["torch.cuda.Stream"] = None):
        stack = self.stack = _stack()
        top = stack[-1] if stack else None
        if req is None and top is not None:
            req = top.request
        self.rec = Record(next(_ids), name, top.id if top else None, req,
                          threading.current_thread().name, 0, 0, attrs)
        self.mark = None
        self.stream = stream

    def __enter__(self) -> Record:
        rec = self.rec
        self.stack.append(rec)
        _records.append(rec)
        if _profiling:
            self.mark = _mark(rec.name)
            self.mark.__enter__()
        if torch.cuda.is_initialized() and not _capturing(self.stream):
            if self.stream is None:
                self.stream = _current_stream()
            stream, device = self.stream, self.stream.device_index
            rec.events = (device, _event(device), _event(device))
            rec.events[1].record(stream)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        end_ns = time.perf_counter_ns()
        if rec.events is not None:
            # the stream it opened on: not capturing then, and a capture
            # opened inside the span has closed inside it
            rec.events[2].record(self.stream)
        rec.end_ns = end_ns             # closed: records() may read it
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
        self.stack.pop()
        return False


def _stack() -> List[Record]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, request: Optional[int] = None,
         stream: Optional["torch.cuda.Stream"] = None, **attrs):
    """A context manager timing its block as span ``name`` with
    ``attrs``; ``request`` gives the request id where it is not the one
    open on this thread (a worker launching another thread's task), and
    ``stream`` the stream whose work it times where that is not the
    current one (a worker launching on a card's compute stream)."""
    if not _on:
        return _NULL
    return _Span(name, request, attrs, stream)


def request(name: str, **attrs):
    """A span that opens a new request: it and every span beneath it on
    this thread carry a fresh request id."""
    if not _on:
        return _NULL
    return _Span(name, next(_requests), attrs)


def spanned(name: str) -> Callable:
    """Decorator: each call of the function is span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, None, {}):
                return fn(*args, **kwargs)
        return run
    return wrap


def current_request() -> Optional[int]:
    """The request id open on this thread while recording, else None."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1].request if stack else None


def _turn(profiler: Optional[bool] = None, opened: int = 0) -> None:
    global _on, _profiling, _opened, _records
    with _state_lock:
        if profiler is not None:
            _profiling = profiler
        _opened += opened
        now = _profiling or _opened > 0
        if now and not _on:
            _records = []                   # a new recording period
        _on = now


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block, with or without the profiler."""
    _turn(opened=1)
    try:
        yield
    finally:
        _turn(opened=-1)


def records() -> List[Record]:
    """The closed spans of the last recording period, by host start. On a
    card each one's ``device_ms`` is read here (waiting for its events)."""
    out = sorted((r for r in _records if r.end_ns), key=lambda r: r.start_ns)
    for r in out:
        if r.events is not None:
            device, start, end = r.events
            end.synchronize()
            r.device_ms = start.elapsed_time(end)
            r.events = None
            _free_events.setdefault(device, []).extend((start, end))
    return out


def _follow_the_profiler() -> None:
    """Turn recording on and off with every torch profiler session: the
    profiler calls these two functions of its module when it starts and
    stops. Where a torch lacks them, only ``recording()`` records."""
    if not (hasattr(_profiler, "_run_on_profiler_start")
            and hasattr(_profiler, "_run_on_profiler_stop")):
        return
    if getattr(_profiler._run_on_profiler_start, "_spans", False):
        return
    start, stop = _profiler._run_on_profiler_start, \
        _profiler._run_on_profiler_stop

    def on_start():
        start()
        _turn(profiler=True)

    def on_stop():
        stop()
        _turn(profiler=False)
    on_start._spans = on_stop._spans = True
    _profiler._run_on_profiler_start = on_start
    _profiler._run_on_profiler_stop = on_stop


_follow_the_profiler()
_turn(profiler=bool(getattr(_profiler, "_is_profiler_enabled", False)))
