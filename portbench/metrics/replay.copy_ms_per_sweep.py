"""Device time of the copies from device memory to device memory in the
profiled solve, summed over the cards, per sweep: chiefly the copy a
replayed window makes of every chunk it writes out of place. The copy
kinds are the patterns in ``patterns/replay.copy_ms_per_sweep/``."""
from portbench import spec, trace

LAYER = "runtime and task-graph replay"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "device_trace", "jacobi_glups"


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    s, _ = trace.matching_s(run.trace, spec.patterns(
        "replay.copy_ms_per_sweep", run.pkg))
    return 1e3 * s / run.units[0]["sweeps"]
