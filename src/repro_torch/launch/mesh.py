"""Mesh construction (``repro/launch/mesh.py`` at the same path): the
smoke mesh over the port's single-controller ``Mesh``. The production
mesh (16 x 16 TPU chips) and the parameter, optimizer, batch and cache
specs wait for mesh placement (ROADMAP.md Queue 1 item 6c'); training
under a mesh splits the batch explicitly (``train.train_step``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.distributed.spmd import Mesh


def make_smoke_mesh(data: int = 1, model: int = 1,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh. ``devices`` lists each shard's device and
    may repeat one (``[torch.device("cpu")] * 4``, four shards on one
    card); by default the first ``data * model`` CUDA cards, one shard
    each."""
    n = data * model
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"a {data}x{model} mesh needs {n} CUDA cards, "
                               f"found {have}: pass devices= to place shards "
                               f"on fewer cards or on the CPU")
        devices = [torch.device("cuda", i) for i in range(n)]
    return Mesh(devices, (data, model), ("data", "model"))
