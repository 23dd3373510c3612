"""Implicit dependency inference (paper §3.1.2–3.1.3).

Assuming tasks are submitted in program order, conflicts are inferred from
argument access modes:

  RAW — a reader depends on the object's last (incomplete) writer
  WAR — a writer depends on every incomplete reader since the last write
  WAW — a writer depends on the last (incomplete) writer

Each object carries ``last_writer`` and ``readers``; edges are recorded as a
counter on the dependent plus a reverse list on the dependency, so completion
is O(out-degree). All calls happen under the runtime's global lock.
"""
from __future__ import annotations

from typing import List, Set

from repro_torch.core.hetero_task import HeteroTask, TaskState


def link(task: HeteroTask, dep: HeteroTask) -> bool:
    """Add edge dep -> task unless dep already finished. Returns True if a
    live edge was created."""
    if dep is task or dep.done():
        return False
    dep.dependents.append(task)
    task.unresolved += 1
    return True


def infer_dependencies(task: HeteroTask) -> int:
    """Wire task into the graph; returns number of unresolved deps."""
    seen: Set[int] = set()
    for ref in task.args:
        obj = ref.obj
        if ref.access.reads:
            lw = obj.last_writer
            if lw is not None and id(lw) not in seen and link(task, lw):
                seen.add(id(lw))
        if ref.access.writes:
            lw = obj.last_writer
            if lw is not None and id(lw) not in seen and link(task, lw):
                seen.add(id(lw))
            for r in list(obj.readers):
                if id(r) not in seen and link(task, r):
                    seen.add(id(r))
    for dep in task.explicit_deps:
        if id(dep) not in seen and link(task, dep):
            seen.add(id(dep))
    # register this task on its objects (program order!)
    for ref in task.args:
        obj = ref.obj
        if ref.access.writes:
            obj.last_writer = task
            obj.readers = set()
        elif ref.access.reads:
            obj.readers.add(task)
    return task.unresolved


def retire(task: HeteroTask) -> List[HeteroTask]:
    """Called on completion (under the runtime lock): clears object refs and
    returns newly-unblocked dependents."""
    for ref in task.args:
        obj = ref.obj
        if obj.last_writer is task:
            obj.last_writer = None
        obj.readers.discard(task)
    ready = []
    for dep in task.dependents:
        dep.unresolved -= 1
        if dep.unresolved == 0 and dep.state == TaskState.BLOCKED:
            ready.append(dep)
    task.dependents = []
    return ready
