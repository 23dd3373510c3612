"""Heterogeneous tasking framework — the paper's primary contribution.

hetero_objects (coherence-tracked data), hetero_tasks (device-type-targeted
tasks with implicit dependency inference), a modular push/pop scheduler, a
memory layer (staging pools, LRU offload), and the Core Runtime gluing them
to the Device API.
"""
from repro_torch.core.futures import HFuture  # noqa: F401
from repro_torch.core.hetero_object import HOST, HeteroObject  # noqa: F401
from repro_torch.core.hetero_task import (Access, HeteroTask,  # noqa: F401
                                          TaskState)
from repro_torch.core.residency import (PLACEMENTS,  # noqa: F401
                                        DataGravityPolicy, LoadOnlyPolicy,
                                        PlacementPolicy, ResidencyLedger)
from repro_torch.core.progress import Lane, ProgressEngine  # noqa: F401
from repro_torch.core.integrity import (ChecksumError,  # noqa: F401
                                        digest_array, verify_array)
from repro_torch.core.lineage import LineageLedger, LineageRecord  # noqa: F401
from repro_torch.core.runtime import (InjectedTaskFault,  # noqa: F401
                                      Runtime, RuntimeConfig)
from repro_torch.core.taskgraph import GraphTracer, TracedGraph  # noqa: F401
from repro_torch.core.topology import (InterconnectModel,  # noqa: F401
                                       LinkEstimate, probe_runtime_links)
from repro_torch.core.scheduler import (SCHEDULERS,  # noqa: F401
                                        FifoScheduler, GravityScheduler,
                                        LeastLoadedScheduler,
                                        LocalityAwareScheduler,
                                        RoundRobinScheduler, Scheduler)
