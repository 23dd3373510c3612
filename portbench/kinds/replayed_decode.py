"""Traffic kind ``replayed_decode``: a closed loop of greedy generations
through the program's tasked decode loop (``serve.tasked_decode_loop``),
each on a ``Runtime(trace_graphs=True)`` of its own, as the program's own
tests and its `chip_smoke.py` run the loop, so that after its first windows every
decode step replays as a CUDA graph. (One runtime across generations
fails at the third on this model: the runtime counts every adopted weight
and cache again at each call and, past the card's capacity, tries to
evict a bfloat16 object to the host, which it cannot.) Set-up prefills the
batch's prompts once through ``launch.serve.Engine``; each generation
starts from that state: the cache's slots past the prompt zeroed, every
length reset to the prompt's, the prefill's first tokens fed again.

Mix parameters: ``batch`` requests of ``prompt_len`` tokens (drawn from
the seed), ``gen_steps`` decode steps a generation, ``checked_requests``
(drawn from the seed) run through the reference; ``limits``:
``logit_gap`` (the widest gap by which a served token's reference logit
lies below the reference's best) and ``kv_rel_err`` (the largest relative
error of what the steps wrote to the cache: every layer's K and V of the
checked requests, and layer 0's V of every request).

Check, on the last generation: the loop writes every decoded position's K
and V in place and hands back only the last token, so the tokens it served
are read back from the cache, each the vocabulary entry whose layer-0 V
(worked out by the reference) lies nearest the V written at its position.
The checked requests, prompt and served tokens, then go through the plain
float32 reference (``reference.dense_lm``): the served tokens' logits and
every layer's K and V at the decoded positions.
"""
from __future__ import annotations

import types

import torch

from portbench import generate, lm
from portbench.reference import dense_lm


def setup(run):
    from repro_torch.core import Runtime, RuntimeConfig
    from repro_torch.launch.serve import Engine
    from repro_torch.serve import tasked_decode_loop
    mix, conf = run.traffic, run.config
    st = types.SimpleNamespace(loop=tasked_decode_loop, counts={},
                               runtime=lambda: Runtime(RuntimeConfig(
                                   device="cuda" if run.on_card else "cpu",
                                   cpu_devices=1, trace_graphs=True)))
    st.model, st.w, st.tree = lm.load(conf, run.seed, run.device)
    st.prompts = generate.prompts(mix, conf["vocab"], run.seed,
                                  run.device)[0]
    s = mix["prompt_len"]
    eng = Engine(st.model, st.tree, mix["batch"], s + mix["gen_steps"])
    st.first, st.cache = eng.prefill(st.prompts)
    del eng
    unit(run, st, -1)                 # builds, traces and captures the step
    st.counts = {}
    return st


def unit(run, st, i):
    mix = run.traffic
    s, b = mix["prompt_len"], mix["batch"]
    for leaf in st.cache.values():
        leaf[:, :, s:] = 0
    rt = st.runtime()
    try:
        tok_obj, len_obj, objs = st.loop(
            rt, st.model, st.tree, st.cache, st.first.clone(),
            torch.full((b,), s, dtype=torch.int32, device=st.first.device),
            mix["gen_steps"], timeout=600)
        st.last = torch.from_numpy(tok_obj.get()).reshape(b, 1)
        st.lengths = len_obj.get()
        # the judged output: the cache leaves the loop wrote
        st.written = {k: o.copies[0] for k, o in objs.items()}
        stats = rt.stats()
    finally:
        rt.shutdown()
    for k in ("tasks", "replayed_tasks", "graph_replays"):
        st.counts[k] = st.counts.get(k, 0) + stats[k]
    return {"requests": b, "tokens": b * mix["gen_steps"]}


def counters(run, st):
    return dict(st.counts)


def release(run, st):
    pass


def recover_tokens(w, conf, v0: torch.Tensor) -> tuple:
    """The token whose layer-0 V lies nearest each row of ``v0`` [N, KH*d]
    (bf16, as the program wrote it), and each one's relative distance."""
    with dense_lm.exact_float32():
        x = dense_lm.rms(w["embed"].float(), w["layers.norm1"][0],
                         conf["norm_eps"])
        table = x @ w["layers.attn.wv"][0].float().reshape(x.shape[1], -1)
        t2 = table.square().sum(1)
        best = torch.cat([(t2[None] - 2 * q.float() @ table.T).argmin(dim=1)
                          for q in v0.split(1024)])
        dist = (v0.float() - table[best]).norm(dim=1) \
            / table[best].norm(dim=1)
    return best, dist


def check(run, st):
    mix, conf, lim = run.traffic, run.config, run.traffic["limits"]
    s, n, b = mix["prompt_len"], mix["gen_steps"], mix["batch"]
    k_all, v_all = st.written["k"], st.written["v"]
    kh, d = conf["n_kv_heads"], conf["head_dim"]
    if not (st.lengths == s + n).all():
        run.problems.append(f"lengths after the last generation: "
                            f"{sorted(set(st.lengths.ravel().tolist()))}")
    # the served tokens t_0 .. t_{n-1} sit at positions s .. s+n-1
    v0 = v_all[0][:, s:s + n].reshape(b * n, kh * d)
    served, dist = recover_tokens(st.w, conf, v0)
    served = served.view(b, n)
    kv_err = float(dist.max())
    served = torch.cat([served, st.last.to(served.device)], dim=1)
    st.served = served
    st.rows = generate.sample(run.seed, "checked-requests", b,
                              mix["checked_requests"])
    if not torch.equal(served[:, 0].cpu(), st.first[:, 0].long().cpu()):
        run.problems.append("the first decoded position does not hold the "
                            "prefill's token")
    got = readings(run, st, lambda logits, kv: (
        served[st.rows].to(logits.device),
        [(k_all[layer][st.rows, s:s + n], v_all[layer][st.rows, s:s + n])
         for layer in range(len(kv))]))
    run.check("logit_gap", got["logit_gap"], lim["logit_gap"])
    run.check("kv_rel_err", max(kv_err, got["kv_rel_err"]),
              lim["kv_rel_err"])


def readings(run, st, judged) -> dict:
    """The numbers compared on the checked requests: the float32
    reference runs their prompts and served tokens; ``judged(logits, kv)``
    gives the tokens served at positions s-1 .. s+n-1 and each layer's
    (K, V) at the decoded positions, to be judged against it."""
    mix, conf = run.traffic, run.config
    s, n = mix["prompt_len"], mix["gen_steps"]
    tokens = torch.cat([st.prompts[st.rows], st.served[st.rows, :n]], dim=1)
    logits, kv = dense_lm.forward(st.w, conf, tokens, range(s - 1, s + n),
                                  kv_positions=slice(s, s + n))
    # position s-1 gives t_0 (the prefill's), position s+j gives t_{j+1}
    served, written = judged(logits, kv)
    gap = lm.served_gap(logits, served)
    kv_err = 0.0
    for (k, v), (kw, vw) in zip(kv, written, strict=True):
        kv_err = max(kv_err, lm.rel_err(kw, k), lm.rel_err(vw, v))
    return {"logit_gap": gap, "kv_rel_err": kv_err}


def control(run, st):
    """The control's readings: the reference in the program's place with
    every product in float8 e4m3 (the nearest precision below the
    configuration's bfloat16), at every position of the same prompts and
    served tokens: the gap of the token it puts first, and its K and V."""
    mix = run.traffic
    s, n = mix["prompt_len"], mix["gen_steps"]
    tokens = torch.cat([st.prompts[st.rows], st.served[st.rows, :n]], dim=1)

    def fp8(logits, kv):
        low, low_kv = dense_lm.forward(st.w, run.config, tokens,
                                       range(s - 1, s + n), products="fp8",
                                       kv_positions=slice(s, s + n))
        return low.argmax(-1), low_kv
    return readings(run, st, fp8)
