"""Over-decomposition planner (paper §4.4).

Splits a d-dimensional domain into od × n_workers chunks so each worker owns
od chunks: while chunk i computes, chunk i+1's halos are in flight. Provides
the chunk geometry, neighbour topology, and the microbatch analogue for LM
training (global_batch → od microbatches).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Chunk:
    cid: int
    grid_pos: Tuple[int, ...]        # position in the chunk grid
    lo: Tuple[int, ...]              # inclusive start per dim
    hi: Tuple[int, ...]              # exclusive end per dim

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(h - l for l, h in zip(self.lo, self.hi, strict=True))


@dataclasses.dataclass(frozen=True)
class DecompPlan:
    domain: Tuple[int, ...]
    chunk_grid: Tuple[int, ...]
    chunks: Tuple[Chunk, ...]
    over_decomposition: int
    n_workers: int

    def neighbors(self, cid: int) -> Dict[str, Optional[int]]:
        """Face neighbours (±each dim) in the chunk grid, None at boundary."""
        c = self.chunks[cid]
        out: Dict[str, Optional[int]] = {}
        grid = np.array(self.chunk_grid)
        pos = np.array(c.grid_pos)
        strides = np.cumprod([1] + list(grid[::-1][:-1]))[::-1]
        for d in range(len(grid)):
            for sign, tag in ((-1, f"lo{d}"), (+1, f"hi{d}")):
                q = pos.copy()
                q[d] += sign
                if 0 <= q[d] < grid[d]:
                    out[tag] = int((q * strides).sum())
                else:
                    out[tag] = None
        return out

    def owner_of(self, cid: int) -> int:
        return min(cid * self.n_workers // len(self.chunks),
                   self.n_workers - 1)


def _factor_grid(n: int, ndim: int, domain: Sequence[int]) -> Tuple[int, ...]:
    """Near-cubic chunk grid with prod == n, biased to larger domain dims."""
    grid = [1] * ndim
    rem = n
    f = 2
    factors = []
    while rem > 1:
        while rem % f == 0:
            factors.append(f)
            rem //= f
        f += 1
    for p in sorted(factors, reverse=True):
        i = int(np.argmax([domain[d] / grid[d] for d in range(ndim)]))
        grid[i] *= p
    return tuple(grid)


def plan_decomposition(domain: Sequence[int], n_workers: int,
                       over_decomposition: int = 1) -> DecompPlan:
    ndim = len(domain)
    n_chunks = n_workers * over_decomposition
    grid = _factor_grid(n_chunks, ndim, domain)
    assert all(domain[d] % grid[d] == 0 for d in range(ndim)), \
        (domain, grid, "domain must divide the chunk grid")
    sizes = [domain[d] // grid[d] for d in range(ndim)]
    chunks = []
    for cid, pos in enumerate(itertools.product(*[range(g) for g in grid])):
        lo = tuple(pos[d] * sizes[d] for d in range(ndim))
        hi = tuple((pos[d] + 1) * sizes[d] for d in range(ndim))
        chunks.append(Chunk(cid, tuple(pos), lo, hi))
    return DecompPlan(tuple(domain), grid, tuple(chunks),
                      over_decomposition, n_workers)


def microbatch_plan(global_batch: int, over_decomposition: int) -> List[int]:
    """LM-training analogue: microbatch sizes per accumulation step."""
    assert global_batch % over_decomposition == 0
    return [global_batch // over_decomposition] * over_decomposition
