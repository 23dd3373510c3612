"""Cell updates of every solve of the window (domain cells x sweeps), in
billions, over the time of those solves by the host clock, upload and
download included."""
UNIT, BETTER, SOURCE = "Gcells/s", "higher", "host_clock"


def read(run):
    cells = sum(u["cells"] for u in run.units)
    return cells / sum(u["t1"] - u["t0"] for u in run.units) / 1e9
