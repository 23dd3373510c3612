"""Seconds from the start of set-up to the start of the window: weights and
inputs drawn, the program built and loaded, every shape of the cell
warmed up."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
