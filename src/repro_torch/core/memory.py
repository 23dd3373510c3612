"""Memory pools: reusable host staging buffers + request/future freelists.

Paper analogues:
  §4.1.1 page-locked host pool  → ``StagingPool``: preallocated, reused host
                                  staging buffers keyed by (shape, dtype);
                                  page-locked (pinned) where a card copies
  §4.1.4 request pools           → ``RequestPool``: freelist of futures

Per-device residency accounting and LRU offload (paper §3.1.1) moved to the
residency ledger — see ``repro_torch.core.residency.ResidencyLedger``.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.convert import numpy_dtype, torch_dtype
from repro_torch.core import sanitizer


class StagingPool:
    """Reusable host staging buffers (the page-locked pool, paper §4.1.1).

    With ``pinned`` every buffer is the numpy view of a page-locked torch
    tensor, so a card copies from and into it by DMA. The view's ``base``
    holds the tensor, so the page-locked memory lives exactly as long as
    the array: in the pool's free lists, or wherever a buffer was handed.
    """

    def __init__(self, enabled: bool = True, max_buffers_per_key: int = 8,
                 pinned: bool = False):
        self.enabled = enabled
        self.pinned = pinned
        self._free: Dict[Tuple[Tuple[int, ...], str], List[np.ndarray]] = \
            collections.defaultdict(list)
        self._lock = sanitizer.make_lock("StagingPool._lock")
        self._max = max_buffers_per_key
        self.hits = 0
        self.misses = 0

    def acquire(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        """A host buffer; ``dtype`` is a numpy or torch dtype (a torch
        bfloat16 needs a numpy bfloat16 registered, or raises TypeError)."""
        dtype = numpy_dtype(dtype)
        if not self.enabled:
            self.misses += 1
            return np.empty(shape, dtype)
        key = (tuple(shape), dtype.str)
        with self._lock:
            lst = self._free.get(key)
            if lst:
                self.hits += 1
                return lst.pop()
        self.misses += 1
        return self._new(shape, dtype)

    def _new(self, shape: Tuple[int, ...], dtype) -> np.ndarray:
        if not self.pinned:
            return np.empty(shape, dtype)
        # bfloat16 has no numpy counterpart torch can hand out: allocate
        # its bits and view them as the caller's dtype
        tdt = torch.int16 if dtype.name == "bfloat16" else torch_dtype(dtype)
        t = torch.empty(tuple(shape), dtype=tdt, pin_memory=True)
        return t.numpy().view(dtype)

    def release(self, arr: np.ndarray) -> None:
        if not self.enabled:
            return
        key = (tuple(arr.shape), arr.dtype.str)
        with self._lock:
            lst = self._free[key]
            if len(lst) < self._max:
                lst.append(arr)


class RequestPool:
    """Freelist of request/future objects (paper §4.1.4). ``hits`` counts
    recycled acquires, ``misses`` fresh constructions — surfaced through
    ``Runtime.stats()``."""

    def __init__(self, factory: Callable[[], Any], enabled: bool = True):
        self._factory = factory
        self.enabled = enabled
        self._free: List[Any] = []
        self._lock = sanitizer.make_lock("RequestPool._lock")
        self.hits = 0
        self.misses = 0

    def acquire(self) -> Any:
        if self.enabled:
            with self._lock:
                if self._free:
                    obj = self._free.pop()
                    obj.reset()
                    self.hits += 1
                    return obj
        self.misses += 1
        return self._factory()

    def release(self, obj: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            if len(self._free) < 1024:
                self._free.append(obj)
