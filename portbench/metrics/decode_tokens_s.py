"""Tokens generated by every generation of the window over the time of
those generations by the host clock, each generation's own set-up (the
reset of its state, the adoption of its objects, the trace and capture of
its steps) included."""
UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(run):
    return sum(u["tokens"] for u in run.units) / sum(
        u["t1"] - u["t0"] for u in run.units)
