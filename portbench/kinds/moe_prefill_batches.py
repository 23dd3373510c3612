"""Traffic kind ``moe_prefill_batches``: ``prefill_batches``' closed loop of
prefill batches (its ``unit`` and ``release``), through a model whose every
feed-forward layer is a routed mixture of experts and whose attention
norms q and k (OLMoE's form), checked against ``reference.moe_lm``.

Mix parameters: those of ``prefill_batches``.

Set-up: the configuration file made into the program's configuration
(``port_config``: the dense keys as ``lm.port_config`` holds them, and
``MOE_KEYS`` against the program's MoE settings), its weights drawn from
the seed (``shapes``: the dense model's leaves without its MLP, the
QK-norm scales, the router in float32 and the stacked experts) and put
into the program's tree by leaf name, then the warm-up batches.

Check: each kept batch through the float32 reference: its first tokens,
last-position logits and every layer's K (after QK-norm and rope) and V,
as ``prefill_batches`` reads them. Also read, printed on standard error
and not compared: ``near_tie_share``, the share of the reference's
(position, layer) rows whose k-th and (k+1)-th router probabilities lie
within ``moe_lm.NEAR_TIE`` of each other, which rounding can reorder.

Counters: ``models.moe.COUNTS`` over the window's batches (a traced run's
profiled batch, before the window, left out).
"""
from __future__ import annotations

import dataclasses
import math
import sys
import types
from typing import Dict, Tuple

import torch

from portbench import generate, lm, weights
from portbench.kinds import prefill_batches
from portbench.reference import moe_lm

# the keys of a configuration file that the program's MoE settings hold
# (``cfg.moe``), and the model keys beyond ``lm.MODEL_KEYS`` it holds
MOE_KEYS = ("num_experts", "top_k", "d_ff_expert", "norm_topk_prob")
EXTRA_KEYS = ("qk_norm", "max_seq")

release = prefill_batches.release


def port_config(conf: dict):
    """The program's configuration of ``conf["model"]`` with the file's
    sizes; every key the file does not list under ``reduced`` must agree
    with the program's registered configuration."""
    base = lm.port_config(conf)
    have = dict({k: getattr(base.moe, k, True) for k in MOE_KEYS},
                **{k: getattr(base, k, False) for k in EXTRA_KEYS})
    differ = {k: (have[k], conf[k]) for k in have
              if conf[k] != have[k] and k not in conf.get("reduced", [])}
    if differ:
        raise ValueError(f"configuration {conf['name']} disagrees with the "
                         f"program's {conf['model']} on (program, file): "
                         f"{differ}")
    moe = dataclasses.replace(base.moe, **{k: conf[k] for k in MOE_KEYS})
    return dataclasses.replace(base, moe=moe,
                               **{k: conf[k] for k in EXTRA_KEYS})


def shapes(cfg: dict) -> Dict[str, tuple]:
    """Leaf name -> (shape, std, dtype name): ``weights.dense_lm_shapes``
    without the MLP, with the QK-norm scales (float32, around 1), the
    router [L, D, E] (float32) and the experts [L, E, D, F], [L, E, F, D],
    each product at 1/sqrt(fan-in)."""
    n, d, e, f = (cfg["n_layers"], cfg["d_model"], cfg["num_experts"],
                  cfg["d_ff_expert"])
    dt = cfg["dtype"]
    out = {k: v for k, v in weights.dense_lm_shapes(cfg).items()
           if not k.startswith("layers.mlp.")}
    out.update({
        "layers.attn.q_norm": ((n, cfg["n_heads"] * cfg["head_dim"]), 0.1,
                               "float32"),
        "layers.attn.k_norm": ((n, cfg["n_kv_heads"] * cfg["head_dim"]),
                               0.1, "float32"),
        "layers.moe.router": ((n, d, e), 1 / math.sqrt(d), "float32"),
        "layers.moe.wi": ((n, e, d, f), 1 / math.sqrt(d), dt),
        "layers.moe.wg": ((n, e, d, f), 1 / math.sqrt(d), dt),
        "layers.moe.wo": ((n, e, f, d), 1 / math.sqrt(f), dt),
    })
    return out


def load(conf: dict, seed: int, device) -> Tuple[object, Dict, Dict]:
    """(the program's model, the drawn weights by leaf name, the program's
    parameter tree holding those same tensors)."""
    from repro_torch.models import build_model
    model = build_model(port_config(conf))
    if model.flags.param_dtype != getattr(torch, conf["dtype"]):
        raise ValueError(f"the program serves {conf['model']} in "
                         f"{model.flags.param_dtype}, the file says "
                         f"{conf['dtype']}")
    w = weights.draw(shapes(conf), seed, device)
    tree = weights.into_tree(w, model.init_abstract().tree())
    return model, w, tree


def setup(run):
    from repro_torch.launch.serve import Engine
    from repro_torch.models import moe
    mix, conf = run.traffic, run.config
    st = types.SimpleNamespace(kept={})
    st.model, st.w, tree = load(conf, run.seed, run.device)
    # a program without the counters gives none to read
    st.counted = dict.fromkeys(getattr(moe, "COUNTS", ()), 0)
    st.prompts = generate.prompts(mix, conf["vocab"], run.seed, run.device)
    st.eng = Engine(st.model, tree, mix["batch"], mix["prompt_len"])
    st.checked = generate.sample(run.seed, "checked-batches",
                                 mix["check_within"], mix["checked_batches"])
    for i in range(mix["warmup_batches"]):
        nxt, cache, last = st.eng.prefill(st.prompts[i % len(st.prompts)],
                                          logits=True)
        nxt.cpu()
    # room for the checked batches' outputs, made now so that keeping them
    # allocates nothing inside the window
    st.room = [(torch.empty_like(last), {k: torch.empty_like(v)
                                         for k, v in cache.items()})
               for _ in st.checked]
    return st


def unit(run, st, i):
    from repro_torch.models import moe
    before = dict(getattr(moe, "COUNTS", {}))
    rec = prefill_batches.unit(run, st, i)
    if run.units or not run.traced:   # not the profiled batch
        for k in st.counted:
            st.counted[k] += moe.COUNTS[k] - before[k]
    return rec


def counters(run, st):
    return dict(st.counted)


def check(run, st):
    conf, lim = run.config, run.traffic["limits"]
    if not st.kept:
        run.problems.append("the window ended before a checked batch")
    got = readings(st, conf, lambda tokens, kept: kept)
    for name, limit in lim.items():
        run.check(name, got[name], limit)
    print(f"near_tie_share (not compared): {got['near_tie_share']!r}",
          file=sys.stderr)


def readings(st, conf, judged) -> dict:
    """``prefill_batches.readings``' numbers against ``moe_lm``, and
    ``near_tie_share``."""
    out = {"logit_gap": 0.0, "logits_rel_err": 0.0, "kv_rel_err": 0.0,
           "first_token_mismatch": 0}
    stats: dict = {}
    for tokens, *kept in st.kept.values():
        s = tokens.shape[1]
        logits, kv = moe_lm.forward(st.w, conf, tokens, [s - 1],
                                    kv_positions=slice(0, s), stats=stats)
        first, last, cache = judged(tokens, kept)
        out["logit_gap"] = max(out["logit_gap"], lm.served_gap(
            logits[:, 0], first[:, 0].to(logits.device)))
        out["logits_rel_err"] = max(out["logits_rel_err"],
                                    lm.rel_err(last, logits))
        out["first_token_mismatch"] += int((first.to(last.device).long()
                                            != last.argmax(-1)).sum())
        for layer, (k, v) in enumerate(kv):
            out["kv_rel_err"] = max(
                out["kv_rel_err"], lm.rel_err(cache["k"][layer][:, :s], k),
                lm.rel_err(cache["v"][layer][:, :s], v))
        del logits, kv
    out["near_tie_share"] = stats.get("near_ties", 0) / max(
        stats.get("rows", 0), 1)
    return out


def control(run, st):
    """The control's readings: the reference in the program's place with
    every bfloat16 product in float8 e4m3 (``moe_lm``'s ``products=
    "fp8"``), on the same prompts."""
    def fp8(tokens, kept):
        s = tokens.shape[1]
        logits, kv = moe_lm.forward(st.w, run.config, tokens, [s - 1],
                                    products="fp8", kv_positions=slice(0, s))
        return (logits.argmax(-1), logits,
                {"k": [k for k, _ in kv], "v": [v for _, v in kv]})
    return readings(st, run.config, fp8)

