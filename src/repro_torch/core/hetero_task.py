"""hetero_task — device-independent task descriptor (paper §3.1.2).

A task consolidates: the kernel (a Python function on torch tensors — the
portable "dialect" that runs on every device), hetero_object arguments with
access modes, requested processing dimensions (advisory), an optional scratch
request (the shared-memory analogue), explicit dependencies, and a device
*type* — never a device id; the scheduler picks the concrete device.
"""
from __future__ import annotations

import enum
import itertools
from typing import Callable, List, Optional, Tuple

from repro_torch.core.futures import HFuture
from repro_torch.core.hetero_object import HeteroObject

_ids = itertools.count()


class Access(enum.Enum):
    READ = "r"
    WRITE = "w"
    RW = "rw"

    @property
    def reads(self) -> bool:
        return self in (Access.READ, Access.RW)

    @property
    def writes(self) -> bool:
        return self in (Access.WRITE, Access.RW)


class TaskState(enum.Enum):
    CREATED = 0
    SUBMITTED = 1
    BLOCKED = 2
    READY = 3
    RUNNING = 4
    DONE = 5
    FAILED = 6


class ArgRef:
    __slots__ = ("obj", "access")

    def __init__(self, obj: HeteroObject, access: Access):
        self.obj = obj
        self.access = access


class HeteroTask:
    """Chained-call task, mirroring the paper's API:

        task = HeteroTask()
        task.arg(a).read()
        task.arg(c).write()
        task.device('gpu')            # a device TYPE, not an id
        task.set_threads((32,32,1), (32,32,1))   # advisory
        rt.submit(task, kernel)
    """

    def __init__(self, name: str = ""):
        self.id = next(_ids)
        self.name = name or f"task{self.id}"
        self.args: List[ArgRef] = []
        self.device_type: Optional[str] = None   # None = any
        self.grid: Optional[Tuple] = None
        self.block: Optional[Tuple] = None
        self.scratch_bytes: int = 0
        self.explicit_deps: List["HeteroTask"] = []
        self.kernel: Optional[Callable] = None
        self.state = TaskState.CREATED
        self.future = HFuture()
        self.outputs: List[HeteroObject] = []
        # runtime bookkeeping
        self.unresolved: int = 0
        self.dependents: List["HeteroTask"] = []
        self.chosen_device: Optional[int] = None
        # the request it serves (core/spans.py), set at submit
        self.request: Optional[int] = None

    # chained API -----------------------------------------------------------
    class _ArgMode:
        def __init__(self, task: "HeteroTask", obj: HeteroObject):
            self._t, self._o = task, obj

        def read(self):
            self._t.args.append(ArgRef(self._o, Access.READ))
            return self._t

        def write(self):
            self._t.args.append(ArgRef(self._o, Access.WRITE))
            return self._t

        def rw(self):
            self._t.args.append(ArgRef(self._o, Access.RW))
            return self._t

    def arg(self, obj: HeteroObject) -> "_ArgMode":
        return HeteroTask._ArgMode(self, obj)

    def device(self, device_type: Optional[str]) -> "HeteroTask":
        self.device_type = device_type
        return self

    def set_threads(self, grid: Tuple, block: Tuple) -> "HeteroTask":
        self.grid, self.block = grid, block
        return self

    def shared_memory(self, nbytes: int) -> "HeteroTask":
        self.scratch_bytes = nbytes
        return self

    def add_dependency(self, other: "HeteroTask") -> "HeteroTask":
        self.explicit_deps.append(other)
        return self

    # properties --------------------------------------------------------
    @property
    def read_objs(self) -> List[HeteroObject]:
        return [a.obj for a in self.args if a.access.reads]

    @property
    def write_objs(self) -> List[HeteroObject]:
        return [a.obj for a in self.args if a.access.writes]

    def arg_bytes_on(self, device_id: int) -> int:
        return sum(a.obj.nbytes for a in self.args
                   if a.obj.has_copy(device_id))

    def total_arg_bytes(self) -> int:
        return sum(a.obj.nbytes for a in self.args)

    def done(self) -> bool:
        return self.state in (TaskState.DONE, TaskState.FAILED)

    def wait(self, timeout: Optional[float] = None):
        return self.future.get(timeout)

    def __repr__(self):
        return f"HeteroTask({self.name}, state={self.state.name})"
