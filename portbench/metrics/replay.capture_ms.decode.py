"""Host milliseconds the profiled generation spends compiling its recurring
decode window into a task graph, once the window's interpreted tasks have
run, and capturing it as a CUDA graph (spans ``taskgraph.compile`` and
``taskgraph.capture``)."""
from portbench import program_spans

LAYER = "runtime and task-graph replay"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "decode_tokens_s"


def read(run):
    return program_spans.host_ms(run, ("taskgraph.compile",
                                       "taskgraph.capture"))
