"""Device API — the bottom layer of the tasking framework (paper §3.1.5).

Encapsulates vendor-specific device operations behind an abstract class, so
the Core Runtime never touches a backend directly. ``TorchDevice`` is the
PyTorch implementation: one CUDA card, or one logical CPU device.

Transfer engine primitives (paper §3.2.3/§4.1.3): besides the synchronous
``upload``/``download`` pair, devices expose asynchronous variants returning
``TransferHandle``s, plus a direct device→device ``transfer`` that never
bounces through host memory — the GPU-aware-interconnect analogue. The Core
Runtime's per-device transfer queues are built on these primitives.

Torch semantics the runtime relies on
-------------------------------------
Torch tensors are mutable and slices are views, where the JAX arrays of the
reference are immutable. So:

  * ``upload``, ``download``, ``clone`` and ``transfer_from`` always return
    storage of their own, never a view of their argument.
  * ``launch(kernel, args, donate)``: a *donated* argument's storage may be
    written in place by the kernel, and no other argument's may. An output
    that shares storage with a non-donated argument (a view of an input) is
    copied before it is returned, so the runtime never binds an object to
    memory that another object owns.
  * Every tensor a CUDA device hands out carries the CUDA event recorded
    after the work that produced it; ``synchronize``, ``is_ready`` and
    ``completion_waiter`` wait on or query that event.
"""
from __future__ import annotations

import abc
import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import sanitizer

# pseudo-device id for transfer sources not wrapped locally (a payload
# arriving from another rank's runtime) in interconnect observations
FOREIGN = -2

# attribute under which a CUDA device tags a tensor with its ready event
_READY = "_repro_ready"


@dataclasses.dataclass
class DeviceInfo:
    device_id: int
    device_type: str            # 'cpu' | 'gpu'
    memory_capacity: int        # bytes the runtime may use on this device
    name: str = ""


class TransferHandle:
    """Handle on an (a)synchronous copy. ``result()`` blocks until the data
    is resident; ``is_ready()`` polls without blocking (the PREMA
    requirement: status queries must never stall the time-slicing loop)."""

    __slots__ = ("_value", "_ready_fn", "_wait_fn")

    def __init__(self, value: Any, ready_fn: Optional[Callable[[], bool]]
                 = None, wait_fn: Optional[Callable[[], Any]] = None):
        self._value = value
        self._ready_fn = ready_fn
        self._wait_fn = wait_fn

    def is_ready(self) -> bool:
        return self._ready_fn() if self._ready_fn is not None else True

    def result(self) -> Any:
        if self._wait_fn is not None:
            self._wait_fn()
        return self._value


class Device(abc.ABC):
    """Abstract device: (a)synchronous task launch + data management."""

    def __init__(self, info: DeviceInfo):
        self.info = info

    @abc.abstractmethod
    def upload(self, host_array: np.ndarray) -> Any:
        """Device copy of ``host_array``; the host array may be reused as
        soon as this returns."""

    @abc.abstractmethod
    def download(self, dev_array: Any) -> np.ndarray: ...

    def download_into(self, dev_array: Any, out: np.ndarray) -> np.ndarray:
        """Copy a resident array into a caller-provided host buffer — the
        runtime's pooled D2H staging path (chunks of a device array land
        in slices of a StagingPool buffer). Backends with pinned-memory
        DMA override this; the default bounces through ``download``."""
        np.copyto(out, self.download(dev_array))
        return out

    @abc.abstractmethod
    def transfer_from(self, src: Optional["Device"], dev_array: Any) -> Any:
        """Copy ``dev_array`` (resident on ``src``, which may be None when
        the source device is foreign) onto this device without staging
        through host memory (paper Fig. 7: device-aware path)."""

    def upload_async(self, host_array: np.ndarray) -> TransferHandle:
        """Start a host→device copy. Unlike ``upload``, the copy may still
        read ``host_array`` after this returns: the caller leaves the
        buffer untouched until ``result()`` has returned."""
        return TransferHandle(self.upload(host_array))

    def download_async(self, dev_array: Any) -> TransferHandle:
        return TransferHandle(self.download(dev_array))

    def clone(self, dev_array: Any) -> Any:
        """Private on-device copy of a resident array (no host bounce).
        Used to snapshot data that a later in-place write must not reach."""
        return dev_array

    @abc.abstractmethod
    def launch(self, kernel: Callable, args: Tuple[Any, ...],
               donate: Tuple[int, ...] = ()) -> Any: ...

    @abc.abstractmethod
    def synchronize(self, handle: Any) -> Any: ...

    @abc.abstractmethod
    def is_ready(self, handle: Any) -> bool: ...

    def completion_waiter(self, handle: Any) -> Callable[[], Any]:
        """Blocking ready-wait closure for an already-dispatched launch —
        what the progress engine's per-device completion lane runs to
        turn the handle into a completion event (the runtime never polls
        ``is_ready`` in its compute workers anymore). Backends may
        return a cheaper wait than full ``synchronize``."""
        return lambda: self.synchronize(handle)


def transfer(src_dev: Optional[Device], dst_dev: Device,
             dev_array: Any,
             observer: Optional[Callable[[int, int, int, float], None]]
             = None) -> Any:
    """Direct D2D copy: move ``dev_array`` from ``src_dev`` to ``dst_dev``
    with no host bounce. The single entry point every layer above (core
    runtime coherence walk, distributed DIRECT payload path) routes through.
    ``src_dev`` may be None when the source device is not wrapped locally
    (e.g. a payload arriving from another rank's runtime) — such sources
    are reported as ``FOREIGN``.

    ``observer(src_id, dst_id, nbytes, seconds)`` is the interconnect
    stats hook: every caller that owns an ``InterconnectModel`` passes
    its ``observe`` so the one primitive feeds all topology estimates.
    On asynchronously-dispatching backends the sample reflects dispatch +
    enqueue (a lower bound the EWMA smooths)."""
    if src_dev is not None and src_dev.info.device_id == dst_dev.info.device_id:
        return dev_array
    t0 = time.perf_counter() if observer is not None else 0.0
    out = dst_dev.transfer_from(src_dev, dev_array)
    if observer is not None:
        src_id = src_dev.info.device_id if src_dev is not None else FOREIGN
        observer(src_id, dst_dev.info.device_id,
                 int(getattr(dev_array, "nbytes", 0)),
                 time.perf_counter() - t0)
    return out


def _leaves(x: Any) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def _storage(t: torch.Tensor) -> Optional[Tuple[torch.device, int]]:
    if t.numel() == 0:
        return None
    return t.device, t.untyped_storage().data_ptr()


def _unalias(out: Any, args: Tuple[Any, ...], donate: frozenset) -> Any:
    """Copy every output that shares storage with a non-donated argument."""
    foreign = {_storage(a) for i, a in enumerate(args)
               if i not in donate and isinstance(a, torch.Tensor)}
    foreign.discard(None)
    if not foreign:
        return out

    def fix(x):
        if isinstance(x, torch.Tensor):
            return x.clone() if _storage(x) in foreign else x
        if isinstance(x, (tuple, list)):
            return type(x)(fix(v) for v in x)
        return x
    return fix(out)


def _checked(kernel: Callable, donate: frozenset) -> Callable:
    def run(*args):
        return _unalias(kernel(*args), args, donate)
    return run


class TorchDevice(Device):
    """One torch device (a CUDA card or a logical CPU device) wrapped in
    the Device API.

    A CUDA device owns one compute stream and one transfer stream. The
    runtime calls in from several threads and torch's current device and
    stream are thread-local, so every operation enters its stream
    explicitly. Launches return at once; ``is_ready`` polls their event.
    A logical CPU device runs everything synchronously.

    Kernel launches go through a per-(kernel, donation) cache of checked
    launchers — the "custom allocator" knob of paper §4.1.2: with
    ``cache_jit`` each kernel object is resolved once.
    """

    def __init__(self, info: DeviceInfo, torch_device: torch.device,
                 cache_jit: bool = True):
        super().__init__(info)
        self.torch_device = torch.device(torch_device)
        self.cache_jit = cache_jit
        self.is_cuda = self.torch_device.type == "cuda"
        if self.is_cuda:
            self.compute_stream = torch.cuda.Stream(self.torch_device)
            self.transfer_stream = torch.cuda.Stream(self.torch_device)
        # Keyed on the kernel OBJECT (strong ref), never id(kernel): an id
        # can be recycled after the kernel is garbage-collected, silently
        # launching a stale launcher for a new kernel.
        self._kernel_cache: Dict[Tuple[Callable, frozenset], Callable] = {}
        self._lock = sanitizer.make_lock("Device._jit_lock")

    # -- streams and events ---------------------------------------------
    @contextlib.contextmanager
    def _on(self, stream: "torch.cuda.Stream"):
        with torch.cuda.device(self.torch_device), torch.cuda.stream(stream):
            yield

    @staticmethod
    def _record(stream: "torch.cuda.Stream", *tensors: torch.Tensor):
        ev = torch.cuda.Event(blocking=True)
        ev.record(stream)
        for t in tensors:
            setattr(t, _READY, ev)
        return ev

    # -- data movement ----------------------------------------------------
    def upload(self, host_array: np.ndarray) -> torch.Tensor:
        src = convert.to_torch(host_array)
        if not self.is_cuda:
            # from_numpy aliases the numpy buffer, which the runtime recycles
            return src.clone()
        if src.is_pinned():
            out = self._h2d(src)
            getattr(out, _READY).synchronize()   # the caller owns src
            return out
        # private pinned copy from torch's caching host allocator, which
        # keeps the block until the copy below has read it
        return self._h2d(src.pin_memory())

    def upload_async(self, host_array: np.ndarray) -> TransferHandle:
        src = convert.to_torch(host_array)
        if not self.is_cuda or not src.is_pinned():
            return TransferHandle(self.upload(host_array))
        out = self._h2d(src)
        ev = getattr(out, _READY)
        return TransferHandle(out, ev.query, ev.synchronize)

    def _h2d(self, pinned: torch.Tensor) -> torch.Tensor:
        with self._on(self.transfer_stream):
            out = torch.empty(pinned.shape, dtype=pinned.dtype,
                              device=self.torch_device)
            out.copy_(pinned, non_blocking=True)
            ev = self._record(self.transfer_stream, out)
        # kernels read the tensor on the compute stream
        self.compute_stream.wait_event(ev)
        out.record_stream(self.compute_stream)
        return out

    def download(self, dev_array: torch.Tensor) -> np.ndarray:
        out = np.empty(tuple(dev_array.shape),
                       convert.numpy_dtype(dev_array.dtype))
        return self.download_into(dev_array, out)

    def download_into(self, dev_array: torch.Tensor,
                      out: np.ndarray) -> np.ndarray:
        if not (out.flags.c_contiguous and out.flags.writeable):
            raise ValueError("download_into needs a contiguous writeable "
                             "host buffer")
        dst = convert.to_torch(out)         # shares out's memory
        if not self.is_cuda:
            dst.copy_(dev_array)
            return out
        target = dst if dst.is_pinned() else torch.empty(
            dst.shape, dtype=dst.dtype, pin_memory=True)
        with self._on(self.transfer_stream):
            self.transfer_stream.wait_stream(self.compute_stream)
            target.copy_(dev_array, non_blocking=True)
            ev = self._record(self.transfer_stream)
        ev.synchronize()
        if target is not dst:
            dst.copy_(target)
        return out

    def transfer_from(self, src: Optional["Device"],
                      dev_array: torch.Tensor) -> torch.Tensor:
        if not self.is_cuda:
            return dev_array.to(self.torch_device, copy=True)
        if isinstance(src, TorchDevice) and src.is_cuda:
            src_stream = src.transfer_stream
            src_stream.wait_stream(src.compute_stream)
        else:
            src_stream = torch.cuda.current_stream(dev_array.device)
        # a cross-device copy_ runs on the source device's current stream
        # and orders itself against the destination's current stream
        with torch.cuda.stream(src_stream), self._on(self.transfer_stream):
            out = torch.empty(dev_array.shape, dtype=dev_array.dtype,
                              device=self.torch_device)
            out.copy_(dev_array, non_blocking=True)
            ev = self._record(self.transfer_stream, out)
        # the source block must outlive the copy queued on its stream
        dev_array.record_stream(src_stream)
        self.compute_stream.wait_event(ev)
        out.record_stream(self.compute_stream)
        return out

    def clone(self, dev_array: torch.Tensor) -> torch.Tensor:
        if not self.is_cuda:
            return dev_array.clone()
        with self._on(self.compute_stream):
            out = dev_array.clone()
            self._record(self.compute_stream, out)
        return out

    # -- launches -----------------------------------------------------------
    def _get_kernel(self, kernel: Callable,
                    donate: Tuple[int, ...]) -> Callable:
        key = (kernel, frozenset(donate))
        if not self.cache_jit:
            return _checked(*key)
        with self._lock:
            fn = self._kernel_cache.get(key)
            if fn is None:
                fn = _checked(*key)
                self._kernel_cache[key] = fn
        return fn

    def launch(self, kernel: Callable, args: Tuple[Any, ...],
               donate: Tuple[int, ...] = ()) -> Any:
        fn = self._get_kernel(kernel, donate)
        if not self.is_cuda:
            return fn(*args)
        with self._on(self.compute_stream):
            out = fn(*args)
            self._record(self.compute_stream, *_leaves(out))
        return out

    def _events(self, handle: Any) -> list:
        """Ready events of the handle's CUDA tensors. A tensor this device
        did not tag stands for everything queued on its two streams."""
        evs, untagged = [], False
        for t in _leaves(handle):
            if t.device.type == "cuda":
                ev = getattr(t, _READY, None)
                untagged |= ev is None
                if ev is not None:
                    evs.append(ev)
        if untagged:
            evs += [self._record(s) for s in (self.compute_stream,
                                              self.transfer_stream)]
        return evs

    def synchronize(self, handle: Any) -> Any:
        for ev in self._events(handle):
            ev.synchronize()
        return handle

    def is_ready(self, handle: Any) -> bool:
        return all(ev.query() for ev in self._events(handle))


def _host_memory_bytes() -> Optional[int]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def device_capacity(device: torch.device, n_devices: int,
                    fraction: float = 0.75) -> int:
    """Honest per-device capacity: a card reports its memory through
    ``torch.cuda.mem_get_info``; logical CPU devices split the host's
    physical memory. Falls back to a 16 GiB default."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1] * fraction)
    host = _host_memory_bytes()
    if host is not None and n_devices > 0:
        return int(host * fraction / n_devices)
    return int(16 * (1 << 30) * fraction)


def discover_devices(memory_capacity: Optional[int] = None,
                     cache_jit: bool = True, device: str = "cuda",
                     cpu_devices: int = 2) -> List[TorchDevice]:
    """One runtime Device per visible CUDA card, or — with
    ``device="cpu"`` — ``cpu_devices`` logical CPU devices, so the
    multi-device paths (D2D, gravity placement) run without a card.
    ``memory_capacity`` caps the bytes the runtime's memory monitor allows
    per device (None → the capacity the device reports, see
    ``device_capacity``). Asking for CUDA where there is none raises."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "discover_devices(device='cuda'): torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the host")
        tdevs = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        kind = "gpu"
    elif device == "cpu":
        tdevs = [torch.device("cpu")] * cpu_devices
        kind = "cpu"
    else:
        raise ValueError(f"unknown device kind {device!r}")
    devs = []
    for i, td in enumerate(tdevs):
        cap = memory_capacity if memory_capacity is not None \
            else device_capacity(td, len(tdevs))
        name = torch.cuda.get_device_name(td) if kind == "gpu" \
            else f"cpu:{i}"
        devs.append(TorchDevice(
            DeviceInfo(device_id=i, device_type=kind, memory_capacity=cap,
                       name=name), td, cache_jit=cache_jit))
    return devs
