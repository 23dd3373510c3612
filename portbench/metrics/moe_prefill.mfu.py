"""The MoE prefills' share of the card's peak: the FLOPs each batch needs,
each token through its top-k experts only (``counts.moe.prefill_flops``),
over the bf16 peak, over the prefill time by the host clock, summed over
the window's batches. It counts the work the model needs, not what the
program computes."""
from portbench import readers
from portbench.counts import moe

LAYER = "model step"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "prefill_tokens_s"


def read(run):
    pk = readers.peak(run)
    if pk is None:
        return None
    units = readers.timed_units(run)
    mix = run.traffic
    need = len(units) * moe.prefill_flops(run.config, mix["batch"],
                                          mix["prompt_len"])
    return readers.percent(need / pk["bf16_flop_s"] / readers.seconds(units))
