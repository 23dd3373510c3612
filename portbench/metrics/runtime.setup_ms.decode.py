"""Host milliseconds the profiled generation spends making and closing its
runtime (spans ``runtime.init``, its link probe included, and
``runtime.shutdown``)."""
from portbench import program_spans

LAYER = "runtime and task-graph replay"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "decode_tokens_s"


def read(run):
    return program_spans.host_ms(run, ("runtime.init", "runtime.shutdown"))
