"""Roofline analysis of the dry-run's counted cells
(``repro/launch/roofline.py`` at the same path), with an H100 node's
constants.

Three terms per (arch x shape) on the ``(1, chips)`` mesh of one node:

    t_compute    = counted FLOPs per card / the card's bf16 peak
    t_memory     = counted HBM bytes per card / its HBM rate
    t_collective = collective bytes per card / its interconnect rate

The JAX package's analysis corrects XLA's cost model, which counts every
while-loop body once whatever its trip count: probe lowerings at 0 and 1
periods scale the layer scan's body (``corrected_hlo``), and the flash and
loss scans get analytic corrections (``flash_scan_bytes_correction``,
``loss_scan_flops``). The port's dry-run counts an eager run, in which
every layer, block and chunk executes and is counted, so there is nothing
to undo and none of the three is copied: the full-depth count already
equals what the probe correction would give
(``tests/test_torch_dryrun.py`` checks ``c0 + n·(c1 − c0)``). The
analytic FLOP model (``analytic_forward_flops``) is copied and reported
beside the count; for a decode step the two agree exactly.

MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference forward).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--opt opt]

reads ``build/repro_torch/dryrun/`` (``tools/dryrun_sweep.py``), writes
``build/repro_torch/roofline_{level}.json`` and prints the table in
markdown: each cell's three terms, its bound and bottleneck, and its
bytes a card (arguments + temporaries) against the card's 80 GB.

The peaks are datasheet numbers: a bound computed from them is a
prediction, not a measurement.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from repro_torch.configs import (ARCH_IDS, GLOBAL_ATTN, LOCAL_ATTN, RGLRU,
                                 SHAPES_BY_NAME, SSD, ModelConfig,
                                 get_config, shapes_for)


class Rates(NamedTuple):
    fp32: float      # FLOP/s outside the tensor cores
    bf16: float      # FLOP/s on the tensor cores, dense
    hbm: float       # bytes/s
    link: float      # bytes/s each way per card over NVLink


# Published peaks (NVIDIA data sheets, dense): float32 outside the tensor
# cores, bf16 tensor cores, HBM bandwidth, NVLink each way (half the
# datasheet's bidirectional figure: 900 GB/s on the SXM part, 18 links of
# 25 GB/s each way; 600 GB/s over the PCIe and NVL parts' bridges).
# Matched on the name the card gives; the SXM part is the default H100.
PEAKS: Dict[str, Rates] = {
    "H100 PCIe": Rates(51.2e12, 756e12, 2.0e12, 300e9),
    "H100 NVL": Rates(60e12, 835e12, 3.9e12, 300e9),
    "H100": Rates(67e12, 989e12, 3.35e12, 450e9),
}
# the card the dry-run's numbers are for
CARD_NAME = "NVIDIA H100 80GB HBM3, 700 W"
HBM_CAPACITY = 80e9


def peaks(name: str) -> Tuple[str, Rates]:
    """The row of ``PEAKS`` whose fragment ``name`` holds, and its
    fragment."""
    for frag, p in PEAKS.items():
        if frag in name:
            return frag, p
    raise KeyError(f"no published peaks for card {name!r}")


# ---------------------------------------------------------------------------
# analytic FLOP model (forward; totals across the whole job)
# ---------------------------------------------------------------------------

def _layer_kinds(cfg: ModelConfig) -> List[str]:
    return [cfg.layer_pattern[i % len(cfg.layer_pattern)]
            for i in range(cfg.n_layers)]


def analytic_forward_flops(cfg: ModelConfig, shape) -> Dict[str, float]:
    """Returns {'proj':…, 'attn':…, 'mlp':…, 'loss':…, 'total':…} global
    forward FLOPs for one step of the given shape."""
    B, S = shape.global_batch, shape.seq_len
    kind = shape.kind
    D, H, K, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    tokens = B * (S if kind != "decode" else 1)
    f_proj = f_attn = f_mlp = 0.0
    for lk in _layer_kinds(cfg):
        if lk in (GLOBAL_ATTN, LOCAL_ATTN):
            f_proj += tokens * 2 * D * hd * (2 * H + 2 * K)
            if kind == "decode":
                ctx = min(cfg.window, S) if lk == LOCAL_ATTN else S
                f_attn += tokens * 4 * H * hd * ctx
            else:
                ctx = 2 * min(cfg.window, S) if lk == LOCAL_ATTN else S
                f_attn += B * S * 4 * H * hd * ctx  # our lowering: all blocks
            if cfg.moe is not None:
                m = cfg.moe
                f_mlp += tokens * 2 * D * m.num_experts          # router
                mult = 6 if cfg.gated_mlp else 4
                f_mlp += tokens * m.top_k * 1.25 * mult * D * m.d_ff_expert
                if m.d_ff_shared:
                    f_mlp += tokens * mult * D * m.d_ff_shared
            else:
                f_mlp += tokens * (6 if cfg.gated_mlp else 4) * D * cfg.d_ff
        elif lk == SSD:
            sc = cfg.ssm
            di = sc.expand * D
            gn = sc.ngroups * sc.d_state
            nh = di // sc.headdim
            f_proj += tokens * 2 * D * (2 * di + 2 * gn + nh) + \
                tokens * 2 * di * D
            if kind == "decode":
                f_attn += tokens * 4 * nh * sc.headdim * sc.d_state
            else:
                q = min(sc.chunk_size, S)
                f_attn += B * S * 2 * (q * gn + q * di + 2 * di * sc.d_state)
        elif lk == RGLRU:
            w = cfg.rglru.lru_width or D
            bd = w // cfg.n_heads
            f_proj += tokens * (2 * D * w * 2 + 2 * w * D)
            f_attn += tokens * (2 * 2 * w * bd + 10 * w)
            f_mlp += tokens * (6 if cfg.gated_mlp else 4) * D * cfg.d_ff
    if cfg.enc_dec:
        enc_tokens = B * cfg.encoder_seq
        enc_t_pad = cfg.encoder_seq + ((-cfg.encoder_seq) % 128)
        for _ in range(cfg.n_encoder_layers):
            f_proj += enc_tokens * 2 * D * hd * (2 * H + 2 * K) * \
                (1 if kind != "decode" else 0)
            if kind != "decode":
                f_attn += B * cfg.encoder_seq * 4 * H * hd * cfg.encoder_seq
                f_mlp += enc_tokens * 4 * D * cfg.d_ff
        # decoder cross attention
        for _ in range(cfg.n_layers):
            f_proj += tokens * 2 * D * hd * 2 * H    # q,o (kv cached/enc)
            if kind != "decode":
                f_proj += enc_tokens * 2 * D * hd * 2 * K
            f_attn += tokens * 4 * H * hd * enc_t_pad
    # loss / unembed
    if kind == "train":
        f_loss = tokens * 2 * D * cfg.vocab
    else:
        f_loss = B * 2 * D * cfg.vocab       # last position / decode step
    total = f_proj + f_attn + f_mlp + f_loss
    return {"proj": f_proj, "attn": f_attn, "mlp": f_mlp, "loss": f_loss,
            "total": total}


def analytic_total_flops(cfg: ModelConfig, shape, remat: str) -> float:
    fwd = analytic_forward_flops(cfg, shape)["total"]
    if shape.kind != "train":
        return fwd
    mult = 4.0 if remat == "full" else 3.3   # fwd + bwd(2) + recompute
    return fwd * mult


# ---------------------------------------------------------------------------
# table builder
# ---------------------------------------------------------------------------

def _load(results_dir: str, arch: str, shape: str, opt: str, chips: int,
          probe: Optional[int] = None) -> Optional[Dict]:
    tag = f"{arch}__{shape}__tp{chips}__{opt}"
    if probe is not None:
        tag += f"__probe{probe}"
    path = os.path.join(results_dir, tag + ".json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        d = json.load(f)
    return None if ("error" in d or d.get("skipped")) else d


def analyze_cell(results_dir: str, arch: str, shape_name: str,
                 opt: str = "baseline", chips: int = 8,
                 card: str = "H100") -> Optional[Dict[str, Any]]:
    full = _load(results_dir, arch, shape_name, opt, chips)
    if full is None:
        return None
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    chips = full["chips"]
    rates = peaks(card)[1]

    remat = "full"   # both levels keep full remat (see §Perf iteration 2)
    ana_flops = analytic_total_flops(cfg, shape, remat) / chips
    flops = full["flops_per_device"]
    hbm = full["bytes_per_device"]
    coll = full["collective_total_bytes"]

    t_compute = flops / rates.bf16
    t_memory = hbm / rates.hbm
    t_coll = coll / rates.link
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)

    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens \
        / chips
    bound = max(terms.values())
    hints = {
        "compute": "reduce recompute (remat policy) / skip masked attention "
                   "blocks / higher arithmetic-intensity kernel fusion",
        "memory": "sequence-parallel activations, smaller remat window, "
                  "bf16 master-free optimizer or fused loss to cut HBM "
                  "round-trips",
        "collective": "reshard to cut per-layer all-gathers "
                      "(ZeRO placement / SP), fuse small all-reduces, "
                      "overlap collectives behind the scan",
    }
    peak_bytes = (full.get("argument_size_in_bytes") or 0) + \
        (full.get("temp_size_in_bytes") or 0)
    return {
        "arch": arch, "shape": shape_name, "opt": opt, "chips": chips,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "bottleneck": bottleneck,
        "analytic_flops_per_device": ana_flops,
        "counted_flops_per_device": flops,
        "hbm_bytes_per_device": hbm,
        "collective_bytes_per_device": coll,
        "collectives": full.get("collective_bytes_per_device"),
        "model_flops_per_device": model_flops,
        "model_vs_analytic": model_flops / ana_flops if ana_flops else None,
        "model_vs_counted": model_flops / flops if flops else None,
        "step_time_bound_s": bound,
        "roofline_fraction": t_compute / bound if bound else None,
        "memory_temp_bytes": full.get("temp_size_in_bytes"),
        "memory_args_bytes": full.get("argument_size_in_bytes"),
        "memory_peak_bytes": peak_bytes,
        "fits_hbm": peak_bytes <= HBM_CAPACITY,
        "hint": hints[bottleneck],
    }


def build_table(results_dir: str, opt: str = "baseline",
                chips: int = 8) -> List[Dict]:
    rows = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            row = analyze_cell(results_dir, arch, shape.name, opt, chips)
            if row:
                rows.append(row)
    return rows


def main():
    import argparse
    from repro_torch.launch.dryrun import RESULTS
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS)
    ap.add_argument("--opt", default="baseline")
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = build_table(args.results, args.opt, args.chips)
    out = args.out or os.path.join(os.path.dirname(args.results),
                                   f"roofline_{args.opt}.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=2)
    print("| arch | shape | compute ms | memory ms | collective ms | "
          "bound ms | bottleneck | GB a card | fits 80 GB |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for r in rows:
        print(f"| {r['arch']} | {r['shape']} | {r['t_compute_s'] * 1e3:.3f} "
              f"| {r['t_memory_s'] * 1e3:.3f} "
              f"| {r['t_collective_s'] * 1e3:.3f} "
              f"| {r['step_time_bound_s'] * 1e3:.3f} | {r['bottleneck']} "
              f"| {r['memory_peak_bytes'] / 1e9:.2f} "
              f"| {'yes' if r['fits_hbm'] else 'no'} |")


if __name__ == "__main__":
    main()
