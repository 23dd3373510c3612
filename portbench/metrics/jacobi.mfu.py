"""The solves' share of the cards' peak: the bytes the sweeps need (every
cell read once and written once a sweep, ``counts.work``) over the cards'
summed memory bandwidth, over the solves' time by the host clock (upload
and download included). The stencil is bound by bytes, so this is the
whole solve's roofline share."""
from portbench import readers
from portbench.counts import work

LAYER = "application"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "host_clock", "jacobi_glups"


def read(run):
    pk = readers.peak(run)
    if pk is None:
        return None
    units = readers.timed_units(run)
    need = sum(u["sweeps"] for u in units) * work.stencil_sweep_bytes(
        run.config["domain"])
    return readers.percent(need / (pk["hbm_bytes_s"] * run.cards)
                           / readers.seconds(units))
