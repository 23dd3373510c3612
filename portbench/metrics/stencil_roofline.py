"""The stencil updates of the profiled solve (each chunk and its six faces
read once, the chunk written once, ``counts.work.stencil_chunk_bytes``)
over one card's memory bandwidth, over the device time, summed over the
cards, of the kernels that compute them: those the files in
``patterns/stencil_roofline/`` name."""
from portbench import readers, spec, trace
from portbench.counts import work

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "jacobi_glups"


def read(run):
    pk = readers.peak(run)
    if pk is None or run.trace is None:
        return None
    s, n = trace.matching_s(run.trace, spec.patterns("stencil_roofline",
                                                     run.pkg))
    if n == 0:
        return None
    mix = run.traffic
    shape = work.chunk_shape(run.config["domain"], mix["chunks"])
    need = run.units[0]["sweeps"] * mix["chunks"] * \
        work.stencil_chunk_bytes(shape)
    return readers.percent(need / pk["hbm_bytes_s"] / s)
