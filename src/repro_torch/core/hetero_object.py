"""hetero_object — location-transparent, coherence-tracked data (paper §3.1.1).

A HeteroObject owns every copy of one logical datum across memory spaces
(HOST = -1, or a device id). A MESI-like two-state protocol per copy
(VALID / absent) with a single rule — a write invalidates every other copy —
gives the paper's guarantee: "the most recent version of the data will be
available at the target device when needed".

Applications never hold raw device pointers; they access data through tasks
(optimal path) or via ``request_host`` which pins the host copy and blocks
writer tasks until ``release`` (paper: request_data/release).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np

from repro_torch.convert import torch_dtype
from repro_torch.core import sanitizer, spans
from repro_torch.core.futures import HFuture

HOST = -1
_ids = itertools.count()


class HeteroObject:
    """Created through Runtime.hetero_object(...) — not directly."""

    def __init__(self, runtime, value: Optional[np.ndarray] = None,
                 shape: Optional[Tuple[int, ...]] = None, dtype=None,
                 name: str = ""):
        self.id = next(_ids)
        self.name = name or f"hobj{self.id}"
        self._rt = runtime
        self.lock = sanitizer.make_rlock("HeteroObject.lock")
        # space -> array (HOST: np.ndarray, device: torch.Tensor)
        self.copies: Dict[int, Any] = {}
        # dependency bookkeeping (owned by DependencyTracker, kept here for
        # O(1) lookup): last writer task + readers since that write
        self.last_writer = None
        self.readers: Set[Any] = set()
        # host pin: while > 0, writer tasks must wait (request_host/release)
        self.host_pins = 0
        # device-view pin: while > 0, launches must not DONATE this object's
        # buffers (a snapshot — e.g. a distributed DIRECT send — still
        # references them; donation would delete the array under the NIC)
        self.device_pins = 0
        self._pin_waiters: list = []
        # monotonically-increasing write version: bumped on every
        # write-rebind (task output, distributed put, host write pin,
        # compiled-graph replay). Lineage records are valid for exactly
        # one generation — the cycle-safety anchor for in-place chains.
        self.generation = 0
        # the element type is a torch dtype always (numpy dtypes are
        # mapped): a bfloat16 object needs no numpy bfloat16 until a host
        # copy of it is made
        if value is not None:
            value = np.asarray(value)
            self.shape, self.dtype = value.shape, torch_dtype(value.dtype)
            self.copies[HOST] = value
        else:
            assert shape is not None and dtype is not None
            self.shape, self.dtype = tuple(shape), torch_dtype(dtype)

    # ------------------------------------------------------------------
    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    def valid_spaces(self) -> Set[int]:
        with self.lock:
            return set(self.copies)

    def resident_devices(self) -> Set[int]:
        """Devices holding a valid replica, answered by the runtime's
        residency ledger (the placement/landing source of truth; never
        includes HOST)."""
        return self._rt.residency.devices_of(self)

    def has_copy(self, space: int) -> bool:
        with self.lock:
            return space in self.copies

    def busy(self) -> bool:
        with self.lock:
            return (self.last_writer is not None or bool(self.readers)
                    or self.host_pins > 0)

    # ------------------------------------------------------------------
    # host access protocol (paper: request_data -> future; release)
    # ------------------------------------------------------------------
    def request_host(self, write: bool = False) -> HFuture:
        """Async request for host access. Resolves with the np.ndarray once
        (a) conflicting tasks finished and (b) data staged to host."""
        return self._rt._request_host(self, write)

    def release(self) -> None:
        self._rt._release_host(self)

    @spans.spanned("runtime.get")
    def get(self, timeout: Optional[float] = None) -> np.ndarray:
        """Convenience: request, wait, copy out, release. A bfloat16 object
        raises ``TypeError`` where numpy has no bfloat16 registered."""
        fut = self.request_host(write=False)
        arr = np.array(fut.get(timeout))
        self.release()
        return arr

    def free(self) -> None:
        """Explicitly drop all copies (paper: early cleanup request)."""
        self._rt._free_object(self)

    def __repr__(self):
        return (f"HeteroObject({self.name}, {self.shape}, {self.dtype}, "
                f"spaces={sorted(self.copies)})")
