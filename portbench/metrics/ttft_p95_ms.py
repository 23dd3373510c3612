"""The 95th percentile (nearest rank) over every request of the window of
the time from its batch's submission to its first token on the host."""
import math

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(run):
    times = sorted(t for u in run.units for t in u["ttft_s"])
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
