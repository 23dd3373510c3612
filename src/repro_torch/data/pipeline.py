"""Deterministic synthetic token pipeline with host-side sharding
(``repro/data/pipeline.py`` at the same path, in numpy as there).

Production shape: each host process owns a slice of the global batch
(``host_index`` / ``host_count``); batches are generated deterministically
from (seed, step) so restarts resume bit-identically without data-state
checkpoints — the data pipeline is stateless by construction, which is the
cheapest form of fault tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


class SyntheticLM:
    """Markov-ish synthetic LM stream: learnable structure (not pure noise) so
    a few hundred training steps show a decreasing loss curve."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.host_count:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {cfg.host_count} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count
        rng = np.random.default_rng(cfg.seed)
        # fixed sparse bigram table: each token has 8 likely successors
        self._succ = rng.integers(
            0, cfg.vocab, size=(min(cfg.vocab, 4096), 8), dtype=np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """This host's ``tokens`` and ``labels`` (the tokens shifted by
        one), each [local_batch, seq_len] int32, of step ``step``."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 1000 + cfg.host_index)
        b, s = self.local_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b)
        nsucc = self._succ.shape[0]
        for t in range(s):
            cur = toks[:, t] % nsucc
            choice = rng.integers(0, 8, size=b)
            noise = rng.random(b) < 0.1
            nxt = self._succ[cur, choice]
            nxt = np.where(noise, rng.integers(0, cfg.vocab, size=b), nxt)
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
