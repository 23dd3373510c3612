"""Distributed layer: the message engine (handlers, mobile objects, the
in-process ``Cluster`` of ranks), the runtime collectives over its streams,
the elastic runtime (failure and straggler handling, chunk migration) and
the over-decomposition planner."""
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
