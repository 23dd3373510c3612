#!/usr/bin/env python3
"""``chip_smoke.py`` phase 16's train steps on one repeated batch, at other
learning rates, weight dtypes and depths, to tell an effect of the
optimiser from a fault of the bf16 path: yi-9b at full width
(``chip_smoke.train_model``), the batch ``chip_smoke.train_batch`` gives,
``chip_smoke.TRAIN_OPT`` with only ``lr_peak`` changed.

    python3 tools/train_lr_probe.py [--steps 6] \
        [--runs bf16:3e-4:12 bf16:3e-4:8 f32:3e-4:8 f32:1e-4:8]

Each run is ``dtype:lr:layers``. Prints one line per run,
``LR <JSON>`` with its losses and the largest rise from one step to the
next, and first the card's name and power limit. Needs one CUDA card;
float32 at 8 layers holds about 38 GB of state (20 B a parameter).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def run(dtype: str, lr: float, layers: int, steps: int) -> dict:
    from repro_torch.train import AdamWConfig, TrainConfig, make_train_step
    dev = torch.device("cuda")
    model = cs.train_model(layers, DTYPES[dtype])
    batch = cs.train_batch(model.cfg, 0, dev)
    state = cs.fresh_state(model, dev)
    step = make_train_step(model, TrainConfig(
        opt=AdamWConfig(**dict(cs.TRAIN_OPT, lr_peak=lr))))
    losses = []
    for _ in range(steps):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
    del state, step, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"dtype": dtype, "lr_peak": lr, "layers": layers,
            "losses": losses,
            "largest_rise": max([b - a for a, b in zip(losses, losses[1:])]
                                + [0.0])}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=cs.TRAIN_STEPS)
    ap.add_argument("--runs", nargs="+", default=[
        "bf16:3e-4:12", "bf16:3e-4:8", "f32:3e-4:8", "f32:1e-4:8"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    for spec in args.runs:
        dtype, lr, layers = spec.split(":")
        print("LR " + json.dumps(run(dtype, float(lr), int(layers),
                                     args.steps)), flush=True)


if __name__ == "__main__":
    main()
