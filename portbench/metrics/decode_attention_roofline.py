"""Decode attention of the profiled generation against the memory
bandwidth: the K and V cache bytes its steps need (every layer, every
request, each step's valid positions read once:
``counts.work.kv_bytes_per_position`` times prompt + i + 1 at step i, the
context of ``decode_generation_bound_s``) over the bandwidth, over the
device time of the kernels that compute it, those the files in
``patterns/decode_attention_roofline/`` name. q and the output are left
out, which can only understate the share. None where no kernel matches."""
from portbench import readers, spec, trace
from portbench.counts import work

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", \
    "decode_tokens_s"


def read(run):
    pk = readers.peak(run)
    if pk is None or run.trace is None:
        return None
    s, n = trace.matching_s(run.trace, spec.patterns(
        "decode_attention_roofline", run.pkg))
    if n == 0:
        return None
    mix = run.traffic
    per_position = work.kv_bytes_per_position(run.config, mix["batch"])
    need = sum(per_position * (mix["prompt_len"] + i + 1)
               for i in range(mix["gen_steps"]))
    return readers.percent(need / pk["hbm_bytes_s"] / s)
