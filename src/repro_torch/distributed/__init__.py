"""Distributed layer. Only the over-decomposition planner is ported so far;
the message engine, collectives and elasticity follow (ROADMAP Queue 1)."""
from repro_torch.distributed.overdecomp import (Chunk,  # noqa: F401
                                                DecompPlan, microbatch_plan,
                                                plan_decomposition)
