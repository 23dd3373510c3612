"""The dry-run: one step of an (arch x shape) cell lowered onto a mesh of
``meta`` shards and counted (``repro/launch/dryrun.py`` at the same path).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b \
        --shape decode_32k --chips 4 [--opt-level opt] [--probe 1]

The JAX package lowers and compiles each cell for a 256-chip TPU mesh and
reads XLA's cost and memory analyses. The port runs eagerly: the cell's
step runs once, at full width and at the cell's own batch and sequence,
over ``launch.mesh.make_production_mesh(devices=[meta] * chips)`` (the
``(1, chips)`` mesh of one node; 8 cards, one HGX H100 node, by default),
under the exact counter of ``repro_torch.opcount``; ``--data D`` gives the
mesh back the data axis JAX's (16, 16) has, ``(D, chips / D)``, so that
ZeRO-1 splits the optimizer state over it, and ``--multi-pod`` lowers on
``(2, D, chips / (2 D))`` (``("pod", "data", "model")``), where the
``compress_pod`` variant averages the gradients over ``pod`` by the int8
error-feedback reduction (its int8 all-gather counted under JAX's
``all-gather``). ``meta`` tensors have
shapes and no storage, so every cell runs on a machine without a card, and
they take the card's route through the model (the kernels' ``meta`` arms,
the card's products): the counts are the card's, which ``chip_smoke.py``
phase 23 checks on an H100.

``lower_cell`` returns JAX's result keys where the meaning carries over:
``flops_per_device`` and ``bytes_per_device`` (shard 0 and the calling
thread, which runs on shard 0's device; ``*_max`` the largest shard),
``argument_size_in_bytes``, ``output_size_in_bytes``,
``alias_size_in_bytes`` (the donated cache or state), ``temp_size_in_bytes``
(the peak of the bytes the step allocates, live at once on shard 0),
``collective_bytes_per_device`` and ``collective_total_bytes``, the
roofline terms at the H100's row of ``launch.roofline.PEAKS``,
``bottleneck``, ``model_flops_per_device`` and ``model_vs_hlo_flops``
(model FLOPs over counted ones). ``run_s`` (the meta run's seconds) stands
for ``lower_s``/``compile_s`` and ``ops_dispatched`` for ``hlo_lines``;
``ops`` and ``kernels`` break shard 0's counts down by name.

The ``opt`` level is the JAX package's: the rule ``"act_seq": "model"``
(``_rules_for``), under which a train or prefill step splits its
activations along the sequence over the model axis, in the Megatron form
(``models.sharding.split_sequence``: each shard holds its slice of the
residual stream between the layers, gathers the sequence before a
column-parallel product and reduce-scatters after a row-parallel one),
and seq-sharded KV decode (``Flags.seq_shard_kv="model"``, the cache's
slots split over the model axis) for a decode cell whose kv heads the
model axis does not divide. ``VARIANTS`` holds the JAX package's named
stacks, the sequence-parallel ones (``sp``, ``dots_sp``, ...) included,
under JAX's names and keywords. A result's file is tagged by its mesh:
``{arch}__{shape}__tp{chips}__{level}`` on ``(1, chips)``, ``pod2`` and
``dp{D}`` before ``tp`` on the others.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import opcount
from repro_torch.configs import (SHAPES_BY_NAME, canon, get_config,
                                 get_smoke_config, shapes_for)
from repro_torch.distributed import spmd
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import (cache_specs, make_production_mesh,
                                     param_specs, place_train_state)
from repro_torch.models import build_model
from repro_torch.models.sharding import use_sharding
from repro_torch.models.transformer import Flags
from repro_torch.serve.serve_step import (abstract_cache, abstract_params,
                                          flatten, make_decode_step,
                                          make_prefill_step)
from repro_torch.train.train_step import (TrainConfig, abstract_train_state,
                                          init_train_state, make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
RESULTS = os.path.join(REPO, "build", "repro_torch", "dryrun")
CARD = "H100"


def _flags_for(seq_shard: bool) -> Flags:
    """The flags every cell lowers with: full remat, expert-parallel MoE,
    bf16 weights, seq-sharded KV over ``data`` where the batch does not
    divide it."""
    return Flags(
        remat="full",
        moe_mode="ep",
        seq_shard_kv="data" if seq_shard else None,
        param_dtype=torch.bfloat16,
        loss_chunk=1024,
        flash_block=512,
    )


def _rules_for(opt_level: str) -> Dict[str, Any]:
    """The logical rules the level adds: the ``opt`` level's sequence-
    parallel activations."""
    if opt_level == "opt":
        return {"act_seq": "model"}
    return {}


# Named stacks of ``build_cell``'s keywords, the JAX package's
VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    # over-decomposition (microbatch pipeline)
    "od2": dict(over_decompose=2),
    "od4": dict(over_decompose=4),
    "od8": dict(over_decompose=8),
    "dots": dict(extra_flags={"remat": "dots"}),
    # sequence parallelism (the act_seq -> model rule), with selective or
    # full remat and over-decomposition
    "dots_sp": dict(extra_flags={"remat": "dots"},
                    extra_rules={"act_seq": "model"}),
    "dots_sp_od4": dict(extra_flags={"remat": "dots"},
                        extra_rules={"act_seq": "model"}, over_decompose=4),
    "dots_sp_od8": dict(extra_flags={"remat": "dots"},
                        extra_rules={"act_seq": "model"}, over_decompose=8),
    "sp": dict(extra_rules={"act_seq": "model"}),
    "sp_od4": dict(extra_rules={"act_seq": "model"}, over_decompose=4),
    "sp_od8": dict(extra_rules={"act_seq": "model"}, over_decompose=8),
    # decode: seq-sharded KV over the model axis (kv-head-replicated archs)
    "kvseq_model": dict(extra_flags={"seq_shard_kv": "model"},
                        cache_seq_axis="model"),
    # mamba2: smaller SSD chunk (halves the decay-matrix traffic)
    "ssd_chunk128": dict(ssd_chunk=128),
    "ssd_chunk128_dots_sp": dict(ssd_chunk=128,
                                 extra_flags={"remat": "dots"},
                                 extra_rules={"act_seq": "model"}),
    "loss_chunk512": dict(extra_flags={"loss_chunk": 512}),
    # int8 + EF compression of the cross-pod gradient reduction (with
    # --multi-pod; train/compression.py). The vocabulary replicated, as
    # JAX's variant keeps it (an XLA limitation there), so that the specs
    # and counts compare with JAX's
    "compress_pod": dict(train_compress=True, extra_rules={"vocab": None}),
}


@dataclasses.dataclass
class Cell:
    """One cell's step, ready to run: ``run()`` takes one step over
    ``mesh`` under the cell's ``rules``; ``args``, ``donated`` and
    ``outputs()`` are its arguments, the donated ones and its results,
    each a tree of ``spmd.Sharded`` or tensors."""
    arch: str
    shape_name: str
    cfg: Any
    shape: Any
    mesh: spmd.Mesh
    over_decompose: int
    seq_shard: bool
    probe: Optional[int]
    step: Callable[[], Any]
    args: Dict[str, Any]
    donated: Dict[str, Any]
    rules: Optional[Dict[str, Any]] = None
    out: Any = None

    def run(self):
        # the rules are read where the step is called (the sequence split)
        with use_sharding(self.mesh, self.rules):
            return self.step()


def _sizes(cfg, probe: Optional[int], ssd_chunk: Optional[int]):
    if probe is not None:
        period = len(cfg.layer_pattern)
        cfg = dataclasses.replace(cfg, n_layers=probe * period,
                                  n_encoder_layers=(probe if cfg.enc_dec
                                                    else 0))
    if ssd_chunk is not None and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk_size=ssd_chunk))
    return cfg


def build_cell(arch: str, shape_name: str, *, chips: int = 8,
               multi_pod: bool = False, data: int = 1,
               opt_level: str = "baseline", over_decompose: int = 1,
               extra_flags: Optional[Dict[str, Any]] = None,
               extra_rules: Optional[Dict[str, Any]] = None,
               probe: Optional[int] = None,
               cache_seq_axis: Optional[str] = None,
               ssd_chunk: Optional[int] = None, train_compress: bool = False,
               batch: Optional[int] = None,
               smoke: bool = False, device="meta",
               gen: Optional[torch.Generator] = None) -> Optional[Cell]:
    """The cell's model, placed state and step over ``chips`` shards of
    ``device`` (the dry-run's ``meta``; on a card with ``gen``, weights
    drawn from it, a zero cache, seeded tokens and lengths of the full
    context), on ``make_production_mesh(multi_pod=, data=)`` under the
    logical rules, the level's (``_rules_for``) and then ``extra_rules``;
    a train cell's optimizer state ZeRO-1 placed, with residuals and the
    compressed step where ``train_compress`` and the mesh has a ``pod``
    axis, as JAX's.
    None for a shape the architecture skips. ``smoke`` takes the reduced
    configuration at the same shapes; ``batch`` cuts the shape's global
    batch."""
    cfg = (get_smoke_config if smoke else get_config)(arch)
    cfg = _sizes(cfg, probe, ssd_chunk)
    shape = SHAPES_BY_NAME[shape_name]
    if shape not in shapes_for(cfg):
        return None
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    device = torch.device(device)
    mesh = make_production_mesh(multi_pod=multi_pod, data=data,
                                devices=[device] * chips)
    seq_shard = (shape.kind == "decode"
                 and shape.global_batch % mesh.shape["data"] != 0)
    flags = _flags_for(seq_shard)
    if opt_level == "opt" and shape.kind == "decode" and not seq_shard \
            and cfg.n_kv_heads % mesh.shape.get("model", 1) != 0 \
            and not cfg.attention_free:
        # hillclimb winner for kv-head-replicated GQA: seq-sharded KV cache
        flags = dataclasses.replace(flags, seq_shard_kv="model")
        cache_seq_axis = cache_seq_axis or "model"
    if extra_flags:
        flags = dataclasses.replace(flags, **extra_flags)
    rules = _rules_for(opt_level)
    if extra_rules:
        rules.update(extra_rules)
    model = build_model(cfg, flags)
    inputs = model.input_specs(shape)
    if device.type != "meta":
        inputs = _real_inputs(inputs, cfg, shape, device, gen)
    with use_sharding(mesh, rules):
        if shape.kind == "train":
            compress = train_compress and "pod" in mesh.shape
            pods = mesh.shape["pod"] if compress else 0
            if device.type == "meta":
                state = place_train_state(
                    abstract_train_state(model, ef_pods=pods),
                    model.axes(), mesh, zero=True)
            else:
                state = init_train_state(model, gen, device, ef_pods=pods,
                                         mesh=mesh, zero=True)
            step = make_train_step(model, TrainConfig(
                over_decompose=over_decompose, compress_pod_grads=compress))
            cell = Cell(arch, shape_name, cfg, shape, mesh,
                        over_decompose, seq_shard, probe,
                        lambda: step(state, inputs),
                        {"state": state, "batch": inputs}, {"state": state},
                        rules)
        else:
            if device.type == "meta":
                abstract = abstract_params(model)
                params = spmd.place(abstract, param_specs(
                    abstract, model.axes(), mesh))
            else:
                params = model.init(gen, device, mesh=mesh)
            abstract = abstract_cache(model, shape.global_batch,
                                      shape.seq_len)
            cspec = cache_specs(abstract, mesh, cfg, seq_shard=seq_shard,
                                seq_axis=cache_seq_axis)
            cache = _zeros(abstract, cspec, device)
            if shape.kind == "prefill":
                fn = make_prefill_step(model, mesh)
                cell = Cell(arch, shape_name, cfg, shape, mesh,
                            over_decompose, seq_shard, probe,
                            lambda: fn(params, inputs, cache),
                            {"params": params, "batch": inputs,
                             "cache": cache}, {"cache": cache}, rules)
            else:
                fn = make_decode_step(model, mesh)
                cell = Cell(arch, shape_name, cfg, shape, mesh,
                            over_decompose, seq_shard, probe,
                            lambda: fn(params, cache, inputs["tokens"],
                                       inputs["lengths"]),
                            {"params": params, "cache": cache,
                             "batch": inputs}, {"cache": cache},
                            rules)
    return cell


def _real_inputs(specs: Dict[str, torch.Tensor], cfg, shape, device,
                 gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Values for ``input_specs`` on a card: tokens and labels drawn from
    ``gen``, decode lengths of the full context less the new token,
    embeddings and frames at the scale the tests draw them (0.02)."""
    out = {}
    for k, v in specs.items():
        if k in ("tokens", "labels"):
            out[k] = torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                   device=device, dtype=v.dtype)
        elif k == "lengths":
            out[k] = torch.full(v.shape, shape.seq_len - 1, dtype=v.dtype,
                                device=device)
        else:
            out[k] = (torch.randn(v.shape, generator=gen, device=device)
                      * 0.02).to(v.dtype)
    return out


def _zeros(abstract, specs, device):
    if isinstance(abstract, dict):
        return {k: _zeros(v, specs[k], device) for k, v in abstract.items()}
    if device.type == "meta":
        # nothing to zero: empty blocks, each shard's own
        mesh, spec = specs.mesh, specs.spec
        local = specs.shard_shape(abstract.shape)
        return spmd.Sharded(mesh, spec, [
            torch.empty(local, dtype=abstract.dtype, device=d)
            for d in mesh.devices], [None] * mesh.size)
    return spmd.zeros(abstract.shape, abstract.dtype, specs)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for _, x in flatten(tree)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    return [tree]


def shard_bytes(tree, shard: int = 0) -> int:
    """The bytes shard ``shard`` holds of ``tree``'s leaves (a placed
    ``Sharded`` its block; a plain tensor, split as ``shard_map`` splits
    it, whole)."""
    total = 0
    for x in _leaves(tree):
        if x is None:
            continue
        t = x.shards[shard] if isinstance(x, spmd.Sharded) else x
        total += t.numel() * t.element_size()
    return total


def count_step(cell: Cell) -> Tuple[opcount.Counter, float]:
    """Run one step of ``cell`` under a fresh counter: (the counter, its
    seconds). The step's results stay in ``cell.out``."""
    counter = opcount.Counter()
    # the collector's full passes over everything made before the step
    # (the placed state's tensors) would slow it by half: they are frozen
    # out of its view; the dispatch's own cycles are still collected
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    try:
        with opcount.counting(counter):
            cell.out = cell.run()
    finally:
        gc.unfreeze()
    return counter, time.perf_counter() - t0


def device0(counter: opcount.Counter, shard: int = 0) -> Dict[str, Any]:
    """Shard ``shard``'s counts, with the calling thread's added to shard
    0's (it runs on shard 0's device)."""
    c = counter.shards.get(shard, opcount.ShardCounts())
    host = counter.shards.get(None, opcount.ShardCounts()) if shard == 0 \
        else opcount.ShardCounts()
    names = set(c.ops) | set(host.ops)
    ops = {n: {"count": c.ops.get(n, 0) + host.ops.get(n, 0),
               "flops": c.op_flops.get(n, 0) + host.op_flops.get(n, 0),
               "bytes": c.op_bytes.get(n, 0) + host.op_bytes.get(n, 0)}
           for n in sorted(names)}
    kernels = {k: dict(v) for k, v in c.kernels.items()}
    for k, v in host.kernels.items():
        kk = kernels.setdefault(k, {"launches": 0, "flops": 0, "bytes": 0})
        for f in kk:
            kk[f] += v[f]
    coll = {k: c.collectives[k] + host.collectives[k]
            for k in opcount.COLLECTIVES}
    return {"flops": c.flops + host.flops, "bytes": c.bytes + host.bytes,
            "ops": ops, "kernels": kernels, "collectives": coll,
            "temp": counter.peak_with_caller.get(shard, 0)}


def lower_cell(arch: str, shape_name: str, *, chips: int = 8,
               multi_pod: bool = False, data: int = 1,
               opt_level: str = "baseline", over_decompose: int = 1,
               extra_flags: Optional[Dict[str, Any]] = None,
               extra_rules: Optional[Dict[str, Any]] = None,
               probe: Optional[int] = None,
               cache_seq_axis: Optional[str] = None,
               ssd_chunk: Optional[int] = None, train_compress: bool = False,
               smoke: bool = False) -> Dict[str, Any]:
    """probe=0: 0-layer model; probe=k: model with exactly k periods (the
    JAX package's probes; here the counts are exact at any depth, so a
    probe only cuts a run's size)."""
    t0 = time.perf_counter()
    cell = build_cell(arch, shape_name, chips=chips, multi_pod=multi_pod,
                      data=data, opt_level=opt_level,
                      over_decompose=over_decompose, extra_flags=extra_flags,
                      extra_rules=extra_rules, probe=probe,
                      cache_seq_axis=cache_seq_axis, ssd_chunk=ssd_chunk,
                      train_compress=train_compress, smoke=smoke)
    if cell is None:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "full-attention arch skips long_500k (see DESIGN)"}
    setup_s = time.perf_counter() - t0
    counter, run_s = count_step(cell)
    return result_of(cell, counter, run_s, setup_s, opt_level)


def result_of(cell: Cell, counter: opcount.Counter, run_s: float,
              setup_s: float, opt_level: str) -> Dict[str, Any]:
    """The result dict of one counted step (module docstring)."""
    cfg, shape, mesh = cell.cfg, cell.shape, cell.mesh
    n_chips = mesh.size
    d0 = device0(counter)
    shards = [device0(counter, i) for i in range(n_chips)]
    rates = R.peaks(CARD)[1]
    result: Dict[str, Any] = {
        "arch": cell.arch, "shape": cell.shape_name,
        "mesh": dict(mesh.shape), "chips": n_chips,
        "opt_level": opt_level, "over_decompose": cell.over_decompose,
        "seq_shard_kv": cell.seq_shard, "probe": cell.probe,
        "n_layers": cfg.n_layers, "period": len(cfg.layer_pattern),
        "setup_s": setup_s, "run_s": run_s,
        "card": R.CARD_NAME, "constants": {
            "peak_flops_bf16": rates.bf16, "peak_flops_fp32": rates.fp32,
            "hbm_bytes_per_s": rates.hbm, "link_bytes_per_s": rates.link},
        "flops_per_device": d0["flops"],
        "bytes_per_device": d0["bytes"],
        "flops_per_device_max": max(s["flops"] for s in shards),
        "bytes_per_device_max": max(s["bytes"] for s in shards),
        "argument_size_in_bytes": shard_bytes(list(cell.args.values())),
        "output_size_in_bytes": shard_bytes(cell.out),
        "alias_size_in_bytes": shard_bytes(list(cell.donated.values())),
        "temp_size_in_bytes": max(s["temp"] for s in shards),
        "collective_bytes_per_device": d0["collectives"],
        "collective_total_bytes": int(sum(d0["collectives"].values())),
        "ops_dispatched": sum(v["count"] for v in d0["ops"].values()),
        "ops": d0["ops"], "kernels": d0["kernels"],
    }
    flops, hbm = result["flops_per_device"], result["bytes_per_device"]
    coll_b = result["collective_total_bytes"]
    result["t_compute"] = flops / rates.bf16 if flops > 0 else None
    result["t_memory"] = hbm / rates.hbm if hbm > 0 else None
    result["t_collective"] = coll_b / rates.link
    terms = {"compute": result["t_compute"] or 0.0,
             "memory": result["t_memory"] or 0.0,
             "collective": result["t_collective"] or 0.0}
    result["bottleneck"] = max(terms, key=terms.get)
    result["step_time_bound_s"] = max(terms.values())
    # model flops: 6·N_active·D(train) / 2·N·D(inference fwd)
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    result["model_flops_per_device"] = mult * n_active * tokens / n_chips
    if flops > 0:
        result["model_vs_hlo_flops"] = result["model_flops_per_device"] / flops
    return result


def result_path(results_dir: str, arch: str, shape: str, chips: int,
                opt: str, probe: Optional[int] = None, *,
                multi_pod: bool = False, data: int = 1) -> str:
    """A result's file: its mesh tagged ``tp{chips}`` on ``(1, chips)``,
    with ``pod2`` and ``dp{data}`` before it on the other meshes."""
    mesh = (("pod2" if multi_pod else "")
            + (f"dp{data}" if data != 1 else "") + f"tp{chips}")
    tag = f"{arch}__{shape}__{mesh}__{opt}"
    if probe is not None:
        tag += f"__probe{probe}"
    return os.path.join(results_dir, tag + ".json")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--multi-pod", action="store_true",
                    help="lower on (2, data, chips / (2 data))")
    ap.add_argument("--data", type=int, default=1,
                    help="the data axis (ZeRO-1 splits the optimizer "
                         "state over it)")
    ap.add_argument("--opt-level", default="baseline",
                    choices=["baseline", "opt"])
    ap.add_argument("--over-decompose", type=int, default=1)
    ap.add_argument("--probe", type=int, default=None)
    ap.add_argument("--variant", default="baseline",
                    choices=sorted(VARIANTS))
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced configuration at the same shapes")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    kw: Dict[str, Any] = dict(chips=args.chips, multi_pod=args.multi_pod,
                              data=args.data,
                              opt_level=args.opt_level,
                              over_decompose=args.over_decompose,
                              probe=args.probe, smoke=args.smoke)
    kw.update(VARIANTS[args.variant])
    res = lower_cell(canon(args.arch), args.shape, **kw)
    res["variant"] = args.variant
    js = json.dumps(res, indent=2, default=str)
    print(js)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(js)


if __name__ == "__main__":
    main()
