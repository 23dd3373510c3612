"""The prefills' share of the card's peak: the FLOPs each batch needs
(``counts.work.prefill_flops``) over the bf16 peak, over the prefill time
by the host clock, summed over the window's batches."""
from portbench import readers
from portbench.counts import work

LAYER = "model step"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "prefill_tokens_s"


def read(run):
    pk = readers.peak(run)
    if pk is None:
        return None
    units = readers.timed_units(run)
    mix = run.traffic
    need = len(units) * work.prefill_flops(run.config, mix["batch"],
                                           mix["prompt_len"])
    return readers.percent(need / pk["bf16_flop_s"] / readers.seconds(units))
