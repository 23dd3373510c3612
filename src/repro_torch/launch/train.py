"""Training driver (``repro/launch/train.py`` at the same path).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \
        --device cpu --steps 100 --over-decompose 4 --checkpoint-dir /tmp/ck

Runs on the CUDA card unless ``--device cpu`` is given; it never falls
back to the CPU on its own. ``--smoke`` takes the reduced config and
``SMOKE_FLAGS`` (float32 weights); without it the full config with
``DEFAULT_FLAGS`` (bf16 weights, ``remat="dots"``). One device holds the
whole state, or with ``--production-mesh`` the state is drawn straight
onto ``launch.mesh.make_production_mesh`` (every card; two CPU shards with
``--device cpu``) and each step trains tensor-parallel over it
(``train.train_step``), as the JAX driver's jitted step does under
``use_sharding``, every family alike. ``--multi-pod`` trains on
``make_production_mesh(multi_pod=True)``, ``("pod", "data", "model") =
(2, 1, n / 2)`` over the node's cards (four CPU shards with ``--device
cpu``), data-parallel over ``pod``, with no compression, as the JAX
driver sets none.
Fault tolerance: checkpoints every ``--ckpt-every`` steps (async,
rotated), automatic resume from the latest committed step (onto the mesh
by its specs), stateless data pipeline keyed by (seed, step).

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \
        --device cpu --production-mesh --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch whisper-large-v3 --smoke --device cpu --production-mesh \
        --steps 4 --seq-len 32
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \
        --device cpu --production-mesh --multi-pod --steps 2
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import canon, get_config, get_smoke_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.mesh import make_production_mesh, opt_specs
from repro_torch.models import build_model, build_smoke
from repro_torch.models.sharding import use_sharding
from repro_torch.train import (AdamWConfig, TrainConfig, abstract_train_state,
                               init_train_state, make_train_step)


def batch_on(data: SyntheticLM, step: int, cfg, device) -> dict:
    """Step ``step``'s batch on ``device``: tokens and labels, and the zero
    ``vision_embeds`` or ``frames`` the JAX driver feeds a model with that
    frontend."""
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.batch(step).items()}
    b = batch["tokens"].shape[0]
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.zeros(
            (b, cfg.frontend_tokens, cfg.d_model), device=device)
    if cfg.enc_dec:
        batch["frames"] = torch.zeros((b, cfg.encoder_seq, cfg.d_model),
                                      device=device)
    return batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config and SMOKE_FLAGS")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--over-decompose", type=int, default=1,
                    help="microbatches per step (paper over-decomposition)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run on the host")
    device = torch.device(args.device)
    arch = canon(args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    model = build_smoke(cfg) if args.smoke else build_model(cfg)
    mesh = None
    if args.production_mesh:
        shards = 4 if args.multi_pod else 2
        mesh = make_production_mesh(
            multi_pod=args.multi_pod,
            devices=[device] * shards if device.type == "cpu" else None)
    with use_sharding(mesh):
        return _train(args, cfg, model, device, mesh)


def _train(args, cfg, model, device, mesh):
    tcfg = TrainConfig(
        opt=AdamWConfig(lr_peak=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps, weight_decay=0.01),
        over_decompose=args.over_decompose)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                  global_batch=args.global_batch))

    step_fn = make_train_step(model, tcfg)
    state = init_train_state(model, torch.Generator(device).manual_seed(0),
                             device, mesh=mesh)
    start = 0
    ck = None
    if args.checkpoint_dir:
        ck = Checkpointer(args.checkpoint_dir, keep=3)
        latest = ck.latest_step()
        if latest is not None:
            abstract = abstract_train_state(model)
            shardings = None if mesh is None else \
                opt_specs(abstract, model.axes(), mesh, zero=False)
            del state
            state = ck.restore(latest, abstract, device, shardings)
            start = latest
            print(f"resumed from step {latest}")

    t0 = time.perf_counter()
    for i in range(start, args.steps):
        state, metrics = step_fn(state, batch_on(data, i, cfg, device))
        if (i + 1) % args.log_every == 0:
            loss = float(metrics["loss"])          # waits for the step
            dt = (time.perf_counter() - t0) / args.log_every
            tok_s = args.global_batch * args.seq_len / dt
            print(f"step {i+1:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"{dt*1e3:.0f} ms/step {tok_s:.0f} tok/s", flush=True)
            t0 = time.perf_counter()
        if ck and (i + 1) % args.ckpt_every == 0:
            ck.save(i + 1, state)
    if ck:
        ck.save(args.steps, state, block=True)
    print("done")
    return state


if __name__ == "__main__":
    main()
