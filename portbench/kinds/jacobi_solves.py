"""Traffic kind ``jacobi_solves``: a closed loop of whole Jacobi3D solves,
each ``apps.jacobi3d.run_tasked(u0, sweeps, rt, over_decomposition)`` from
the host domain to the host result (upload, sweeps and download), on one
``Runtime(trace_graphs=True)`` made in set-up over the cell's cards.

The configuration gives the domain (``domain``, the side of the cube, and
``dtype``). Mix parameters: ``sweeps`` a solve, ``chunks`` (the domain
cut into this many chunks; each card's over-decomposition is chunks /
cards), ``warmup_sweeps`` (the set-up's solve, long enough to trace,
compile and capture the window), and ``limits`` (``max_abs_gap``: the
largest |program - exact| a solve's domain may show).

Check: every solve's domain against the exact solution of the same
sweeps (``reference.stencil.exact``, float64).
"""
from __future__ import annotations

import types

import numpy as np
import torch

from portbench import generate
from portbench.reference import stencil


def setup(run):
    from repro_torch.apps.jacobi3d import run_tasked
    from repro_torch.core import Runtime, RuntimeConfig
    mix = run.traffic
    st = types.SimpleNamespace(run_tasked=run_tasked, outs=[])
    st.u0 = generate.domain(run.config, run.seed, run.device).cpu().numpy()
    st.rt = Runtime(RuntimeConfig(
        device="cuda" if run.on_card else "cpu", cpu_devices=run.cards,
        trace_graphs=True))
    if len(st.rt.devices) != run.cards:
        raise RuntimeError(f"the runtime found {len(st.rt.devices)} "
                           f"devices, the cell asks for {run.cards}")
    st.od = mix["chunks"] // run.cards
    run_tasked(st.u0, mix["warmup_sweeps"], st.rt, over_decomposition=st.od)
    st.stats0 = st.rt.stats()
    return st


def unit(run, st, i):
    sweeps = run.traffic["sweeps"]
    st.outs.append(st.run_tasked(st.u0, sweeps, st.rt,
                                 over_decomposition=st.od))
    return {"cells": st.u0.size * sweeps, "sweeps": sweeps}


def counters(run, st):
    now = st.rt.stats()
    return {k: now[k] - st.stats0[k] for k in (
        "tasks", "replayed_tasks", "graph_replays", "graphs_traced",
        "graph_invalidations")}


def release(run, st):
    st.rt.shutdown()
    st.rt = None


def check(run, st):
    want = stencil.exact(torch.from_numpy(st.u0).to(run.device),
                         run.traffic["sweeps"])
    gap = 0.0
    for out in st.outs:
        gap = max(gap, stencil.max_abs_gap(
            torch.from_numpy(np.ascontiguousarray(out)).to(run.device), want))
    run.check("max_abs_gap", gap, run.traffic["limits"]["max_abs_gap"])


def control(run, st):
    """The control's reading: the same sweeps of the same domain in
    bfloat16, the nearest precision below the configuration's float32."""
    u0 = torch.from_numpy(st.u0).to(run.device)
    got = stencil.sweeps(u0, run.traffic["sweeps"], torch.bfloat16)
    want = stencil.exact(u0, run.traffic["sweeps"])
    return {"max_abs_gap": stencil.max_abs_gap(got, want)}
