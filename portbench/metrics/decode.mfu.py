"""The generations' share of the card's peak: each decode step's least
time (the larger of its FLOPs over the bf16 peak and its bytes over the
memory bandwidth: the weights, the cache read and the position written,
``counts.work``), summed over the window's generations, over their time
by the host clock."""
from portbench import readers
from portbench.counts import work

LAYER = "model step"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "decode_tokens_s"


def read(run):
    pk = readers.peak(run)
    if pk is None:
        return None
    units = readers.timed_units(run)
    mix = run.traffic
    bound = work.decode_generation_bound_s(
        run.config, mix["batch"], mix["prompt_len"], mix["gen_steps"], pk)
    return readers.percent(len(units) * bound / readers.seconds(units))
