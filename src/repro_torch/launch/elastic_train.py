"""Elastic training driver (``repro/launch/elastic_train.py`` at the same
path): failure detection → mesh shrink → restore → continue; growth is the
same flow in reverse.

This is the end-to-end wiring of the fault-tolerance substrate:
``ElasticController`` (health and plans) + ``Checkpointer``
(device-agnostic restore) + the stateless data pipeline (replay from step
counters). Each span trains data-parallel over the ``data`` axis of a
single-controller mesh (``distributed.spmd``): each shard takes its slice
of the fixed global batch and the gradients are averaged by
``spmd.pmean`` (``train_step.make_train_step`` under ``use_sharding``),
where the JAX driver lets GSPMD split the batch. The demo simulates losing
half the shards mid-run and continues on the survivors; the losses do not
depend on the world size (per-step determinism comes from (seed, step)),
up to the order of the float32 sums.

    PYTHONPATH=src python -m repro_torch.launch.elastic_train --device cpu \
        --shards 8 --steps 12 --fail-at 6
"""
from __future__ import annotations

import argparse
import tempfile
from typing import List, Optional, Sequence

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import canon, get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import ElasticController
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.train import batch_on
from repro_torch.models import build_smoke
from repro_torch.models.sharding import use_sharding
from repro_torch.train import (AdamWConfig, TrainConfig, abstract_train_state,
                               init_train_state, make_train_step)


def run_elastic(arch: str = "yi_9b", steps: int = 12, fail_at: int = 6,
                ckpt_dir: Optional[str] = None, seed: int = 0,
                devices: Optional[Sequence] = None):
    """Returns (losses, world_sizes) across the failure boundary.
    ``devices`` lists each shard's device (may repeat one; by default one
    shard per CUDA card); the state lives on the first. ``ckpt_dir``
    defaults to a temporary directory, removed when the run ends."""
    if ckpt_dir is None:
        with tempfile.TemporaryDirectory(prefix="repro_elastic_") as tmp:
            return run_elastic(arch, steps, fail_at, tmp, seed, devices)
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA card: pass devices= (e.g. "
                               "[torch.device('cpu')] * 8)")
    all_devices = [torch.device(d) for d in devices]
    cfg = get_smoke_config(arch)
    model = build_smoke(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr_peak=1e-3, warmup_steps=2,
                                       total_steps=steps))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8, seed=seed))
    ck = Checkpointer(ckpt_dir, keep=2, async_save=False)
    ec = ElasticController(range(len(all_devices)), heartbeat_timeout=1e9)

    losses: List[float] = []
    worlds: List[int] = []

    def train_span(devs, start, end, restore):
        mesh = make_smoke_mesh(len(devs), 1, devices=devs)
        home = devs[0]
        with use_sharding(mesh):
            step_fn = make_train_step(model, tcfg)
            if restore:
                state = ck.restore_latest(abstract_train_state(model), home)
            else:
                state = init_train_state(
                    model, torch.Generator(home).manual_seed(seed), home)
            for i in range(start, end):
                state, metrics = step_fn(state, batch_on(data, i, cfg, home))
                losses.append(float(metrics["loss"]))
                worlds.append(len(devs))
            ck.save(end, state)
        return state

    # healthy span on the full world
    train_span(all_devices, 0, fail_at, restore=False)

    # failure: half the data axis goes silent → shrink plan → resume from
    # the last committed checkpoint on the survivors
    n_dead = len(all_devices) // 2
    for w in range(len(all_devices) - n_dead, len(all_devices)):
        ec.health[w].last_heartbeat = -1.0
        ec.health[w].alive = False
    survivors = [all_devices[w] for w in ec.alive_workers()]
    train_span(survivors, fail_at, steps, restore=True)
    return losses, worlds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--fail-at", type=int, default=6)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shards", type=int, default=8,
                    help="data-parallel shards, all on --device")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run on the host")
    losses, worlds = run_elastic(canon(args.arch), args.steps, args.fail_at,
                                 args.ckpt_dir,
                                 devices=[torch.device(args.device)]
                                 * args.shards)
    for i, (l, w) in enumerate(zip(losses, worlds)):
        marker = "  <- shrunk world" if i and worlds[i - 1] != w else ""
        print(f"step {i:3d} world={w} loss={l:.4f}{marker}")
    print("elastic run complete")
    return losses, worlds


if __name__ == "__main__":
    main()
