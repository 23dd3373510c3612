#!/usr/bin/env python3
"""Serve llama4-scout-17b-16e at full width over a (1, 4) mesh with one
shard a card, on a node of four CUDA cards: first 8 of its 48 layers
(``chip_smoke.py`` phase 19's model and prompts, which that phase serves
over four shards of one card), then all 48 (215.5 GB of bf16 weights,
about 54 GB a card).

    python3 tools/mesh_cards.py [--layers 8 48]
        [--out chiprun_out/mesh_cards.json]

For each depth the weights are drawn straight onto the mesh from the
seed (``Model.init(gen, device, mesh=)``: the one-device draws, shard by
shard), and the Engine under ``use_sharding`` serves 4 prompts of 2048
and 32 decode steps: prefill ms, decode ms a step, SPMD rendezvous a
step, each card's peak allocation, ``flash_attention`` launches (one a
layer and shard in the prefill, none in decode). Checks: each shard's
share of the weights; at 8 layers the prefill's last logits against the
one-device model's on card 0 (routes pinned to it, ``moe_ep``'s drops
dropped there too, relative L2 within ``chip_smoke.MESH_LOGITS_TOL``);
at every depth the greedy tokens against the argmax of a full forward
run on the mesh itself (the dense MoE oracle in each shard's body, with
the served run's routes and drops), at least
``chip_smoke.GREEDY_MIN_AGREEMENT`` of them. Prints each card's name and
power limit and one JSON object (also written to ``--out``). Exits
non-zero with fewer than four cards or on a failed check.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import threading
import time
import traceback

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CARDS = 4


def sync_all() -> None:
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def peak_gb(device) -> float:
    return torch.cuda.max_memory_allocated(device) / 1e9 \
        if device.type == "cuda" else 0.0


def mesh_pinned(pins, keeps):
    """While open, each shard's routing calls (all tokens: the dense
    oracle in a body) take ``pins[n]`` at their n-th call, weighted by
    their own probabilities renormalised over them and times
    ``keeps[n]``; counted per shard thread."""
    from repro_torch.models import moe as M
    route, local = M._route, threading.local()

    def call(router_w, x, mcfg):
        _, _, aux = route(router_w, x, mcfg)
        n = getattr(local, "n", 0)
        local.n = n + 1
        pin = pins[n].to(x.device)
        w = torch.softmax(x.float() @ router_w, dim=-1).gather(-1, pin)
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
        return w * keeps[n].to(x.device), pin, aux

    class _Ctx:
        def __enter__(self):
            M._route = call

        def __exit__(self, *exc):
            M._route = route
    return _Ctx()


def mesh_forward_logits(model, params, mesh, full: torch.Tensor, s: int):
    """The logits [B, n - s + 1, V] of one forward over ``full`` [B, n]
    at positions s - 1 onward, run on the mesh: train mode in each
    shard's body (no kernel: the plain blockwise attention in the largest
    block that divides n, as chip_smoke's full forward), the MoE layers
    through the dense oracle on each shard's experts."""
    from repro_torch.distributed import spmd
    from repro_torch.models import build_model
    from repro_torch.models.sharding import split_axes, split_weights
    from repro_torch.serve.serve_step import _unflatten, flatten
    n = full.shape[1]
    blk = max(d for d in range(1, 513) if n % d == 0)
    fwd = build_model(model.cfg, dataclasses.replace(
        model.flags, moe_mode="dense", use_flash_kernel=False,
        flash_block=blk))
    named = flatten(params)

    split = split_axes(model.axes(), params)

    def body(*leaves):
        p = _unflatten([k for k, _ in named], leaves[:-1])
        with torch.no_grad(), split_weights(split):
            x = fwd.apply(p, {"tokens": leaves[-1]}, mode="train")[0]
            return fwd.unembed(p, x[:, s - 1:])

    out = spmd.shard_map(
        body, mesh, tuple(t.spec for _, t in named) + (spmd.P(),),
        spmd.P(None, None, "model"))(*(t for _, t in named), full)
    return out.full().float()


def serve_depth(cfg, C, check, devices) -> dict:
    """Serve ``cfg`` over a (1, len(devices)) mesh of ``devices``; the
    checks and numbers of the module docstring."""
    from repro_torch import kernels as ops
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_model
    from repro_torch.models.sharding import use_sharding
    dev, layers, mcfg = devices[0], cfg.n_layers, cfg.moe
    model = build_model(cfg)
    b, s, steps = C.SERVE_BATCH, C.SERVE_PROMPT, C.SERVE_STEPS
    tp = len(devices)
    tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                           generator=torch.Generator(dev).manual_seed(
                               C.SEED + 1))
    r = {"arch": cfg.name, "layers": layers, "devices": [str(d) for d in
                                                           devices],
         "batch": b, "prompt": s, "decode_steps": steps}
    want = pins = None
    if layers == C.SCOUT_LAYERS:
        # the one-device reference on card 0 (phase 14's weights), pinned
        # to its own routes, with the mesh's capacity drops
        params1 = model.init(torch.Generator(dev).manual_seed(C.SEED), dev)
        eng1 = Engine(model, params1, b, s + steps)
        with C.routed() as rec:
            eng1.prefill(tokens)
        pins = rec["idx"]
        gid = C.routing_groups(b, s, tp, 0, dev)
        with C.routed(pins, functools.partial(C.capacity_keep, gid=gid,
                                              mcfg=mcfg)):
            want = eng1.prefill(tokens, logits=True)[2]
        want = want.float()
        del eng1, params1, rec
        gc.collect()
        torch.cuda.empty_cache()

    mesh = make_production_mesh(devices=devices)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(C.SEED), dev,
                        mesh=mesh)
    sync_all()
    r["init_s"] = time.perf_counter() - t0
    r.update(C.placed_shares(params, mesh, C.MESH_SHARES))
    check(r["shard_shares"] == C.MESH_SHARES, f"{layers} layers: a shard "
          f"holds {r['shard_shares']}")
    with use_sharding(mesh):
        eng = Engine(model, params, b, s + steps)
        with C.counted_rendezvous() as count:
            nxt, cache = eng.prefill(tokens)
        r["rendezvous_per_prefill"] = count[0]
        with C.counted_rendezvous() as count:
            eng.decode(cache, nxt, s, 2)
        r["rendezvous_per_decode_step"] = count[0] / 2
        del nxt, cache
        sync_all()
        for d in devices:
            if d.type == "cuda":
                torch.cuda.reset_peak_memory_stats(d)
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        nxt, cache = eng.prefill(tokens)
        sync_all()
        t1 = time.perf_counter()
        r["launches_in_prefill"] = dict(ops.LAUNCHES)
        rest = eng.decode(cache, nxt, s, steps)
        sync_all()
        t2 = time.perf_counter()
        r["launches"] = dict(ops.LAUNCHES)
        r["peak_gb_per_card"] = [peak_gb(d) for d in devices]
        r["prefill_ms"] = (t1 - t0) * 1e3
        r["prefill_tok_s"] = b * s / (t1 - t0)
        r["decode_ms_per_step"] = (t2 - t1) * 1e3 / steps
        r["decode_tok_s"] = b * steps / (t2 - t1)
        out = torch.cat([nxt, rest], dim=1)
        del cache, rest
        print(json.dumps(r), flush=True)
        n_flash = layers * tp
        check(r["launches_in_prefill"]["flash_attention"] == n_flash
              == r["launches"]["flash_attention"],
              f"{layers} layers: launches {r['launches']}")
        if want is not None:
            with C.mesh_routes(b, s, tp, pins):
                got = eng.prefill(tokens, logits=True)[2]
            rel = ((got.float() - want).norm() / want.norm()).item()
            r["prefill_logits_vs_one_card"] = {"rel_l2": rel,
                                               "tol": C.MESH_LOGITS_TOL}
            check(rel <= C.MESH_LOGITS_TOL, f"{layers} layers: logits "
                  f"{rel} from one card's")
            del got, want
        with C.mesh_routes(b, s, tp) as mrec:
            again = eng.generate(tokens, steps + 1)
        check(torch.equal(again, out), f"{layers} layers: a second greedy "
              f"run gave other tokens")
        routes = C.mesh_call_routes(mrec, layers, b, s, steps)
        del eng, again, mrec
        full = torch.cat([tokens, out[:, :-1]], dim=1)
        gid = C.routing_groups(b, s, tp, steps, dev)
        pins_full = C.full_forward_pins(routes, layers, b, s, steps)
        keeps = [C.capacity_keep(p, gid, mcfg) for p in pins_full]
        r["dropped_in_served_run"] = sum(int((~k).sum()) for k in keeps)
        t0 = time.perf_counter()
        with mesh_pinned(pins_full, keeps):
            logits = mesh_forward_logits(model, params, mesh, full, s)
        r["full_forward_s"] = time.perf_counter() - t0
    a = C.agreement(logits, out)
    r["greedy_vs_full_forward"] = a
    check(a["agreement"] >= C.GREEDY_MIN_AGREEMENT, f"{layers} layers: "
          f"greedy agreement {a['agreement']}")
    del params, logits, routes, pins_full, keeps, mesh
    gc.collect()
    torch.cuda.empty_cache()
    return r


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[8, 48])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "mesh_cards.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        print(f"mesh_cards: needs {CARDS} CUDA cards", file=sys.stderr)
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
            print(f"mesh_cards: FAILED: {what}", file=sys.stderr)

    out = {"cards": torch.cuda.device_count(),
           "kind": torch.cuda.get_device_name(0), "torch": torch.__version__}
    from repro_torch.configs import get_config
    devices = [torch.device("cuda", i) for i in range(CARDS)]
    for layers in args.layers:
        cfg = dataclasses.replace(get_config(C.SCOUT_ARCH), n_layers=layers)
        try:
            out[f"layers_{layers}"] = serve_depth(cfg, C, check, devices)
        except Exception:      # recorded; the next depth still runs
            check(False, f"{layers} layers: {traceback.format_exc()}")
            gc.collect()
            torch.cuda.empty_cache()
            continue
        print(json.dumps(out[f"layers_{layers}"]), flush=True)
    out["failures"] = failures
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
