"""The one traffic generator: it reads a mix's parameters (a file under
``traffic/``) and the run's seed, and makes the inputs the program gets.
Every draw comes from a generator seeded by ``--seed`` and a fixed label,
so the same seed gives the same inputs and every seed the same sizes.
"""
from __future__ import annotations

import random
import zlib
from typing import List

import torch


def stream(seed: int, label: str) -> int:
    """A seed of its own for each kind of draw of one run."""
    return (seed * 1_000_003 + zlib.crc32(label.encode())) % (1 << 63)


def torch_gen(seed: int, label: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, label))


def domain(conf: dict, seed: int, device) -> torch.Tensor:
    """The starting domain of a stencil solve: a cube of side
    ``conf["domain"]`` (a configuration's), uniform in [0, 1)."""
    n = conf["domain"]
    return torch.rand((n, n, n), generator=torch_gen(seed, "domain", device),
                      dtype=getattr(torch, conf["dtype"]), device=device)


def prompts(mix: dict, vocab: int, seed: int, device) -> torch.Tensor:
    """``mix["distinct_batches"]`` batches of ``mix["batch"]`` prompts of
    ``mix["prompt_len"]`` tokens, uniform over the vocabulary:
    [distinct_batches, batch, prompt_len] int64."""
    shape = (mix.get("distinct_batches", 1), mix["batch"], mix["prompt_len"])
    return torch.randint(0, vocab, shape,
                         generator=torch_gen(seed, "prompts", device),
                         device=device)


def sample(seed: int, label: str, population: int, k: int) -> List[int]:
    """``k`` distinct indices of ``range(population)`` drawn from the seed,
    sorted (all of them where k >= population)."""
    rng = random.Random(stream(seed, label))
    return sorted(rng.sample(range(population), min(k, population)))
