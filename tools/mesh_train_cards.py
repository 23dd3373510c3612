#!/usr/bin/env python3
"""Train a model at full width over a production mesh with one shard a
card, on a node of four CUDA cards, at depths no single card holds: by
default yi-9b at all 48 of its layers (8.83 B parameters, a 124 GB
training state, about 31 GB a card) over ``("data", "model") = (1, 4)``;
``--arch recurrentgemma-9b`` at all 38 (9.6 B parameters, about 135 GB).
``--mesh POD,DATA,MODEL`` trains over ``("pod", "data", "model")``
instead, ``--zero`` with the moments and master split over ``data`` as
well (ZeRO-1) and ``--compress`` with the int8 error-feedback reduction
over ``pod`` (``compress_pod_grads``, residuals placed). ``--sp`` trains
under the rule ``{"act_seq": "model"}``: sequence parallelism, each card
holding its slice of the sequence between the layers.
``chip_smoke.py`` phases 20, 22 and 24 train them cut to 12, 6 and 1
layers over shards of one card.

    python3 tools/mesh_train_cards.py [--arch yi-9b] [--layers 48]
        [--mesh 1,2,2] [--zero] [--compress] [--sp]
        [--out chiprun_out/mesh_train_cards.json]

For each depth (by default the config's) the state is drawn straight onto
the mesh from the seed (``init_train_state(..., mesh=, zero=, ef_pods=)``:
the one-device draws, shard by shard, each shard making its own moments
and float32 master), then ``make_train_step`` trains on the batch of the
model's ``chip_smoke.MESH_TRAIN_CELLS`` entry (``SyntheticLM``, bf16,
``DEFAULT_FLAGS``), phase 20's ``MESH_TRAIN_STEPS`` steps on the one
repeated batch: ms a step (host clock around steps synchronised on every
card), SPMD rendezvous a step, each card's peak allocation, each shard's
share of the state. With
``--mesh`` the gradients of the first step (``make_mesh_grad_fn``,
uncompressed) are held to one card's at the same depth, computed first on
card 0 with full remat (the same values; a card holds 48 layers'
weights and gradients but not "dots"' saved products): each leaf's cosine
and norm ratio, as phase 20 does. Checks: each shard holds what the specs
give it, the losses are finite, the first within 0.5 of ln V, and they
fall every step; no hand-written kernel launches; with ``--mesh``
phase 20's bounds. A watchdog ends the run with a message after
``WATCHDOG_S`` seconds. Prints each card's name and power limit and one
JSON object (also written to ``--out``). Exits non-zero with fewer than
four cards or on a failed check.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from typing import Optional

# 48 layers' stacked leaves are 4 GB a shard in float32: their reductions
# would otherwise leave the cards' caches too fragmented to hold the next
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CARDS = 4
# seconds after which the run ends with a message (a collective left
# waiting in a backward would otherwise hang it)
WATCHDOG_S = 1500


def sync_all() -> None:
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def one_card_grads(C, arch: str, layers: Optional[int], batch, dev):
    """The gradients of the seeded weights on ``dev`` alone (full remat:
    the values of "dots", less memory), on the host, and the loss."""
    import dataclasses
    from repro_torch.train import make_grad_fn
    from repro_torch.train.optimizer import (global_norm, tree_flatten,
                                             tree_map)
    model = C.train_model(layers, arch=arch)
    model = dataclasses.replace(model, flags=dataclasses.replace(
        model.flags, remat="full"))
    params = tree_map(lambda p: p.detach(), model.init(
        torch.Generator(dev).manual_seed(C.SEED), dev).tree())
    grads, met = make_grad_fn(model)(params, batch)
    out = {"host": [(k, v.to("cpu")) for k, v in tree_flatten(grads)],
           "loss": float(met["ce"] + met["aux"]),
           "grad_norm": float(global_norm(grads))}
    del params, grads, met, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grad_cosines(host, grads, dev) -> dict:
    """Each leaf's cosine and norm ratio of the mesh's gradients against
    one card's (phase 20's numbers)."""
    from repro_torch.train.optimizer import tree_flatten
    cos, ratio = {}, {}
    for (k, a), (_, b) in zip(host, tree_flatten(grads), strict=True):
        a = a.to(dev).float().flatten()
        b = b.full(dev).float().flatten()
        na, nb = a.norm(), b.norm()
        # cuBLAS's dot takes at most 2^31 - 1 elements (a stacked leaf of
        # 48 layers holds more)
        dot = sum(torch.dot(x, y) for x, y in zip(a.split(1 << 30),
                                                  b.split(1 << 30)))
        cos["/".join(k)] = float(dot / (na * nb).clamp_min(1e-30))
        ratio["/".join(k)] = float(nb / na.clamp_min(1e-30))
        del a, b
    return {"min_cosine": min(cos.values()),
            "max_norm_ratio_err": max(abs(x - 1) for x in ratio.values()),
            "cosine": cos}


def train_depth(arch: str, layers: Optional[int], C, check, devices,
                shape=None, zero: bool = False, compress: bool = False,
                sp: bool = False) -> dict:
    """Train ``layers`` of ``arch`` (None: all) over a (1, len(devices))
    mesh of ``devices``, or the ``("pod", "data", "model")`` mesh of
    ``shape`` (the gradients held to one card's), with ``sp`` under the
    sequence-parallel rule; the numbers and checks of the module
    docstring."""
    from repro_torch import kernels as ops
    from repro_torch.configs import get_config
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.sharding import use_sharding
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_mesh_grad_fn, make_train_step)
    dev = devices[0]
    _, bsz, seq = C.MESH_TRAIN_CELLS[arch]
    model = C.train_model(layers, arch=arch)
    cfg = model.cfg
    layers = cfg.n_layers
    batch = C.train_batch(cfg, 0, dev, bsz, seq)
    if shape is None:
        mesh = make_production_mesh(devices=devices)
    else:
        mesh = spmd.Mesh(devices, shape, ("pod", "data", "model"))
    r = {"arch": cfg.name, "layers": layers,
         "config_layers": get_config(arch).n_layers,
         "devices": [str(d) for d in devices], "mesh": dict(mesh.shape),
         "zero": zero, "compress": compress, "sp": sp, "batch": bsz,
         "seq": seq,
         "remat": model.flags.remat, "steps": C.MESH_TRAIN_STEPS}
    cosines = shape is not None
    one = one_card_grads(C, arch, layers, batch, dev) if cosines else None
    t0 = time.perf_counter()
    pods = mesh.shape.get("pod", 1) if compress else 0
    state = init_train_state(model, torch.Generator(dev).manual_seed(C.SEED),
                             dev, ef_pods=pods, mesh=mesh, zero=zero)
    sync_all()
    r["draw_s"] = time.perf_counter() - t0
    r["params"] = sum(math.prod(x.shape) for x in
                      _leaves(state.params))
    r.update(C.state_shares(state, mesh))
    if compress:
        r.update(C.compressed_payload(state))
    rules = {"act_seq": "model"} if sp else None
    if one is not None:
        with use_sharding(mesh, rules):
            grads, met = make_mesh_grad_fn(model)(state.params, batch)
        r.update(one_card_loss=one["loss"],
                 one_card_grad_norm=one["grad_norm"],
                 mesh_loss=float(met["ce"] + met["aux"]),
                 mesh_grad_norm=float(met["grad_norm"]),
                 **grad_cosines(one["host"], grads, dev))
        del grads, met, one
        gc.collect()
    step = make_train_step(model, TrainConfig(opt=C.train_opt(),
                                              compress_pod_grads=compress))
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    losses, ms, rdv = [], [], []
    for _ in range(C.MESH_TRAIN_STEPS):
        with C.counted_rendezvous() as count, use_sharding(mesh, rules):
            t0 = time.perf_counter()
            state, met = step(state, batch)
            sync_all()
            ms.append((time.perf_counter() - t0) * 1e3)
        rdv.append(count[0])
        losses.append(float(met["loss"]))
    r["launches"] = dict(ops.LAUNCHES)
    r["peak_gb_per_card"] = [torch.cuda.max_memory_allocated(d) / 1e9
                             for d in devices]
    r.update(losses=losses, step_ms=ms, rendezvous_per_step=rdv,
             grad_norm=float(met["grad_norm"]),
             ms_per_step=float(np.median(ms[1:] or ms)))
    r["tokens_per_s"] = bsz * seq / r["ms_per_step"] * 1e3
    print(json.dumps({k: v for k, v in r.items() if k != "cosine"}),
          flush=True)
    shares = r["shard_state_gb"]
    check(all(abs(g - shares[0]) < 1e-9 for g in shares)
          and abs(sum(shares) - r["spec_state_gb"] * len(devices))
          <= 1e-6 * sum(shares),
          f"{layers} layers: the shards hold {shares} GB, the specs give "
          f"{r['spec_state_gb']} GB each")
    check(all(math.isfinite(x) for x in losses),
          f"{layers} layers: non-finite loss {losses}")
    check(abs(losses[0] - math.log(cfg.vocab)) <= 0.5,
          f"{layers} layers: the first loss {losses[0]} is not within 0.5 "
          f"of ln {cfg.vocab}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"{layers} layers: the loss does not fall every step: {losses}")
    check(not any(r["launches"].values()),
          f"{layers} layers: launched hand-written kernels {r['launches']}")
    if cosines:
        check(abs(r["mesh_loss"] - r["one_card_loss"])
              <= C.MESH_TRAIN_LOSS_RTOL * r["one_card_loss"],
              f"{layers} layers: the mesh's first loss {r['mesh_loss']} vs "
              f"one card's {r['one_card_loss']}")
        check(r["min_cosine"] >= C.TRAIN_COS_MIN,
              f"{layers} layers: a gradient leaf's cosine with one card's "
              f"is {r['min_cosine']} < {C.TRAIN_COS_MIN}")
        check(r["max_norm_ratio_err"] <= C.MESH_TRAIN_NORM_RTOL,
              f"{layers} layers: a gradient leaf's norm over one card's is "
              f"{r['max_norm_ratio_err']} off 1")
    del state, step, batch, met, mesh
    gc.collect()
    for d in devices:
        with torch.cuda.device(d):
            torch.cuda.empty_cache()
    return r


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--layers", type=int, nargs="+", default=[None])
    ap.add_argument("--mesh", default=None,
                    help="POD,DATA,MODEL over the four cards")
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--sp", action="store_true",
                    help="sequence parallelism: the rule act_seq -> model")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "mesh_train_cards.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"mesh_train_cards: needs {CARDS} CUDA cards", file=sys.stderr)
        return 2
    import chip_smoke as C
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    failures = []

    def check(ok, what):
        if not ok:
            failures.append(what)
            print(f"mesh_train_cards: FAILED: {what}", file=sys.stderr)

    out = {"cards": torch.cuda.device_count(),
           "kind": torch.cuda.get_device_name(0), "torch": torch.__version__}
    devices = [torch.device("cuda", i) for i in range(CARDS)]
    shape = None if args.mesh is None else tuple(
        int(n) for n in args.mesh.split(","))
    with C.watchdog(WATCHDOG_S, "mesh_train_cards"):
        for layers in args.layers:
            try:
                r = train_depth(args.arch, layers, C, check, devices, shape,
                                args.zero, args.compress, args.sp)
                out[f"layers_{r['layers']}"] = r
            except Exception:      # recorded; the next depth still runs
                check(False, f"{layers} layers: {traceback.format_exc()}")
                gc.collect()
                continue
    out["failures"] = failures
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
