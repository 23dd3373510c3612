"""Traffic kind ``prefill_batches``: a closed loop, one client, of prefill
batches through the program's serving engine (``launch.serve.Engine``),
each ``Engine.prefill(tokens, logits=True)`` to the first tokens on the
host. A request's time to first token runs from its batch's submission to
that copy.

Mix parameters: ``batch`` requests of ``prompt_len`` tokens, drawn from the
seed as ``distinct_batches`` batches sent in turn; ``warmup_batches`` sent
in set-up; ``checked_batches`` of the first ``check_within`` batches of the
window (drawn from the seed) kept for the check; ``limits``: a limit for
each number the check compares (``readings``).

Check: each kept batch through the plain float32 reference
(``reference.dense_lm``): its first tokens, its last-position logits and
every layer's K and V at every prompt position.
"""
from __future__ import annotations

import time
import types

import torch

from portbench import generate, lm
from portbench.reference import dense_lm


def setup(run):
    from repro_torch.launch.serve import Engine
    mix, conf = run.traffic, run.config
    st = types.SimpleNamespace(kept={})
    st.model, st.w, tree = lm.load(conf, run.seed, run.device)
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
    tokens = st.prompts[i % len(st.prompts)]
    t0 = time.perf_counter()
    nxt, cache, last = st.eng.prefill(tokens, logits=True)
    first = nxt.cpu()            # the first tokens on the host
    ttft = time.perf_counter() - t0
    if i in st.checked:
        kept_last, kept_cache = st.room[st.checked.index(i)]
        kept_last.copy_(last)
        for k, v in cache.items():
            kept_cache[k].copy_(v)
        st.kept[i] = (tokens, first, kept_last, kept_cache)
    return {"requests": tokens.shape[0], "tokens": tokens.numel(),
            "ttft_s": [ttft] * tokens.shape[0]}


def counters(run, st):
    return {}


def release(run, st):
    st.eng = None


def check(run, st):
    conf, lim = run.config, run.traffic["limits"]
    if not st.kept:
        run.problems.append("the window ended before a checked batch")
    got = readings(st, conf, lambda tokens, kept: kept)
    for name, limit in lim.items():
        run.check(name, got[name], limit)


def readings(st, conf, judged) -> dict:
    """The numbers, over the kept batches, that a check may compare:
    ``judged(tokens, kept)`` gives a batch's first tokens [B, 1], last
    logits [B, 1, V] and cache (K, V [L, B, T, KH, d]) to be judged against
    the float32 reference. ``logit_gap``: the widest gap of a first token
    below the reference's best; ``logits_rel_err``: the largest relative
    error of a batch's last logits; ``kv_rel_err``: of a layer's K or V;
    ``first_token_mismatch``: first tokens on the host that are not the
    best of the logits returned with them (exact: limit 0)."""
    out = {"logit_gap": 0.0, "logits_rel_err": 0.0, "kv_rel_err": 0.0,
           "first_token_mismatch": 0}
    for tokens, *kept in st.kept.values():
        s = tokens.shape[1]
        logits, kv = dense_lm.forward(st.w, conf, tokens, [s - 1],
                                      kv_positions=slice(0, s))
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
    return out


def control(run, st):
    """The control's readings: the reference in the program's place with
    every product in float8 e4m3 (the nearest precision below the
    configuration's bfloat16), on the same prompts."""
    def fp8(tokens, kept):
        s = tokens.shape[1]
        logits, kv = dense_lm.forward(st.w, run.config, tokens, [s - 1],
                                      products="fp8",
                                      kv_positions=slice(0, s))
        return (logits.argmax(-1), logits,
                {"k": [k for k, _ in kv], "v": [v for _, v in kv]})
    return readings(st, run.config, fp8)
