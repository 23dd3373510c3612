"""SPMD lowering of PREMA's communication patterns
(``repro/distributed/collectives.py`` at the same path).

The JAX package compiles the paper's patterns into the program as
collectives; the port runs them over its single-controller mesh
(``distributed/spmd.py``), whose permutes are device copies ordered by
CUDA events:

  handler payload / put / get  →  ppermute (point-to-point)
  halo exchange (Jacobi)       →  paired ppermutes per face
  reduction handlers           →  psum

The host-staged path of §3.2.3 survives as ``host_round_trip``.
Call the first four inside ``spmd.shard_map``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_numpy, to_torch
from repro_torch.distributed.spmd import axis_index, axis_size, ppermute


def ring_permute(x: torch.Tensor, axis_name: str,
                 shift: int = 1) -> torch.Tensor:
    """Send x to rank+shift (ring) along a mesh axis."""
    n = axis_size(axis_name)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return ppermute(x, axis_name, perm)


def halo_exchange_1d(block: torch.Tensor, axis_name: str, halo: int = 1,
                     wrap: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exchange face slabs with ±1 neighbours along ``axis_name``.
    block: [L, ...] local slab, exchange along dim 0. Returns (lo_halo,
    hi_halo) received from the -1 / +1 neighbours (zeros at the ends
    unless wrap: ``ppermute`` gives zeros to a shard no pair sends to)."""
    n = axis_size(axis_name)
    hi_face = block[-halo:]          # send up
    lo_face = block[:halo]           # send down
    if wrap:
        perm_up = [(i, (i + 1) % n) for i in range(n)]
        perm_dn = [(i, (i - 1) % n) for i in range(n)]
    else:
        perm_up = [(i, i + 1) for i in range(n - 1)]
        perm_dn = [(i, i - 1) for i in range(1, n)]
    from_lo = ppermute(hi_face, axis_name, perm_up)   # my lo halo
    from_hi = ppermute(lo_face, axis_name, perm_dn)   # my hi halo
    return from_lo, from_hi


def spmd_put(x: torch.Tensor, axis_name: str, src: int,
             dst: int) -> torch.Tensor:
    """One-sided put: ``src``'s x replaces ``dst``'s x; other ranks keep
    theirs."""
    moved = ppermute(x, axis_name, [(src, dst)])
    return moved if axis_index(axis_name) == dst else x


def spmd_get(x: torch.Tensor, axis_name: str, src: int) -> torch.Tensor:
    """Every rank receives src's x (get analogue): a one-to-all permute
    that moves the payload once per destination and keeps the source's
    value bit-identical (no add in the path)."""
    n = axis_size(axis_name)
    perm = [(src, d) for d in range(n) if d != src]
    moved = ppermute(x, axis_name, perm)
    return x if axis_index(axis_name) == src else moved


def host_round_trip(x: torch.Tensor,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """Host-staged path (§3.2.3 without GPU-aware interconnect): device →
    host → (network) → host → device (``x``'s own unless given). Used by
    checkpoint/elastic paths. The result never shares ``x``'s memory."""
    host = np.array(to_numpy(x))          # a copy, also of a CPU tensor
    return to_torch(host, device if device is not None else x.device)
