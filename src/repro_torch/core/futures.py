"""Futures for asynchronous runtime operations (paper §3.1.1/§3.1.3).

A ``HFuture`` is returned by every asynchronous runtime call (task submission,
data-access request, transfer). It supports non-blocking status queries —
the paper's requirement that PREMA can poll operation status without
blocking its time-slicing loop — and blocking waits with timeouts.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, List, Optional

from repro_torch.core import sanitizer


class HFuture:
    __slots__ = ("_event", "_result", "_error", "_callbacks", "_lock")

    def __init__(self):
        self._event = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._callbacks: List[Callable[["HFuture"], None]] = []
        self._lock = sanitizer.make_lock("HFuture._lock")

    # -- producer side -----------------------------------------------------
    def set_result(self, value: Any) -> None:
        with self._lock:
            self._result = value
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def set_error(self, err: BaseException) -> None:
        with self._lock:
            self._error = err
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def reset(self) -> None:
        """Recycle (request-pool reuse, paper §4.1.4)."""
        self._event.clear()
        self._result = None
        self._error = None
        self._callbacks = []

    # -- consumer side ------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def get(self, timeout: Optional[float] = None) -> Any:
        if not self._event.is_set():
            # actually entering the wait path is a lane-discipline event:
            # a serial lane parked here could just as well park forever
            san = sanitizer.current()
            if san is not None:
                t0 = time.perf_counter()
                ok = self._event.wait(timeout)
                san.note_future_wait(time.perf_counter() - t0)
                if not ok:
                    raise TimeoutError("future not ready")
            elif not self._event.wait(timeout):
                raise TimeoutError("future not ready")
        if self._error is not None:
            raise self._error
        return self._result

    def add_done_callback(self, cb: Callable[["HFuture"], None]) -> None:
        fire = False
        with self._lock:
            if self._event.is_set():
                fire = True
            else:
                self._callbacks.append(cb)
        if fire:
            cb(self)
