"""Share of the profiled unit's length (host clock) in which no operation
ran on the cards, averaged over the cards (profiler trace)."""
from portbench import readers, trace

LAYER = "device"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "prefill_tokens_s"


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return readers.percent(trace.idle_share(run.trace))
