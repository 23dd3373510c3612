"""The causal attention of the profiled prefill batch (every layer's,
``counts.work.causal_attention_flops``) over the bf16 peak, over the
device time of the kernels that compute it: those the files in
``patterns/flash_roofline/`` name, whatever the implementation."""
from portbench import readers, spec, trace
from portbench.counts import work

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", \
    "prefill_tokens_s"


def read(run):
    pk = readers.peak(run)
    if pk is None or run.trace is None:
        return None
    s, n = trace.matching_s(run.trace, spec.patterns("flash_roofline",
                                                     run.pkg))
    if n == 0:
        return None
    c, mix = run.config, run.traffic
    need = c["n_layers"] * work.causal_attention_flops(
        mix["batch"], mix["prompt_len"], c["n_heads"], c["head_dim"])
    return readers.percent(need / pk["bf16_flop_s"] / s)
