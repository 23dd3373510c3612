"""Host milliseconds the profiled generation spends adopting the weights,
the cache, the tokens and the lengths as the runtime's objects (span
``serve.adopt``)."""
from portbench import program_spans

LAYER = "serving engine"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "decode_tokens_s"


def read(run):
    return program_spans.host_ms(run, ("serve.adopt",))
