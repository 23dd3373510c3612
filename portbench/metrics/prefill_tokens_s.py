"""Prompt tokens of every prefill batch of the window over the window's
length by the host clock."""
UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(run):
    return sum(u["tokens"] for u in run.units) / run.window_s
