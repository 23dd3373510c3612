"""Device milliseconds of the RMS norms (spans ``model.norm``, two a
layer and the final one) of the profiled prefill batch."""
from portbench import program_spans

LAYER = "model step"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", \
    "prefill_tokens_s"


def read(run):
    return program_spans.device_ms(program_spans.named(run, "model.norm"))
