"""Distributed layer: the message engine (handlers, mobile objects, the
in-process ``Cluster`` of ranks), the runtime collectives over its streams,
the elastic runtime (failure and straggler handling, chunk migration), the
over-decomposition planner, and the SPMD path: a single-controller mesh
with ``shard_map`` (``spmd``) and the patterns lowered onto it
(``collectives``)."""
from repro_torch.distributed.collectives import (  # noqa: F401
    halo_exchange_1d, host_round_trip, ring_permute, spmd_get, spmd_put)
from repro_torch.distributed.collectives_rt import (  # noqa: F401
    CollectiveAborted, CollectiveGroup)
from repro_torch.distributed.elastic import (ElasticController,  # noqa: F401
                                             ElasticRuntime, WorkerHealth)
from repro_torch.distributed.handlers import (handler,  # noqa: F401
                                              registered, resolve)
from repro_torch.distributed.messaging import (Cluster,  # noqa: F401
                                               FaultInjector, HandlerContext,
                                               Message, Rank)
from repro_torch.distributed.mobile_object import (MobileObject,  # noqa: F401
                                                   MobilePtr, OwnerMap,
                                                   block_distribution,
                                                   rebalance_greedy)
from repro_torch.distributed.overdecomp import (Chunk,  # noqa: F401
                                                DecompPlan, microbatch_plan,
                                                plan_decomposition)
from repro_torch.distributed.spmd import (P, Mesh,  # noqa: F401
                                          NamedSharding, Sharded,
                                          device_put, place, shard_map)
