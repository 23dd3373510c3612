"""Whole runs of the tiny cells (the look for a card skipped) with the
timed path broken underneath: each fault the cell can have must turn
``correct`` false. The program's functions are patched for one run."""
from __future__ import annotations

import pytest
import torch

from portbench.tests.conftest import run_tiny


def _stencil_unchanged(monkeypatch):
    """A sweep that returns its chunk as it was."""
    import repro_torch.apps.jacobi3d as J
    monkeypatch.setattr(J, "stencil_update", lambda u, *faces: u.clone())


def _stencil_altered(monkeypatch):
    """Every update's answer altered in one cell."""
    import repro_torch.apps.jacobi3d as J
    real = J.stencil_update

    def altered(u, *faces):
        out = real(u, *faces)
        out[0, 0, 0] += 1e-3
        return out
    monkeypatch.setattr(J, "stencil_update", altered)


def _halos_left_out(monkeypatch):
    """The exchange between chunks (and between devices) left out: no
    face reaches its neighbour."""
    from repro_torch.core import runtime as R
    real = R.Runtime.run

    def run(self, kernel, args, *a, name="", **kw):
        if name.startswith("halo"):
            return None
        return real(self, kernel, args, *a, name=name, **kw)
    monkeypatch.setattr(R.Runtime, "run", run)


def _broken_decode(monkeypatch, how):
    import repro_torch.serve.serve_step as S
    real = S.make_decode_step

    def make(model, mesh=None):
        step = real(model, mesh)

        def broken(params, cache, tokens, lengths):
            if how == "unchanged":
                return tokens, cache
            tok, cache = step(params, cache, tokens, lengths)
            if how == "token":
                return (tok + 1) % model.cfg.vocab, cache
            # half of the batch left out: its rows' new K and V unwritten
            b = tokens.shape[0]
            rows = torch.arange(b // 2, b, device=tokens.device)
            for leaf in cache.values():
                leaf[:, rows, lengths[b // 2:].long()] = 0
            return tok, cache
        return broken
    monkeypatch.setattr(S, "make_decode_step", make)


def _broken_prefill(monkeypatch, how):
    import repro_torch.launch.serve as E
    real = E.make_prefill_step

    def make(model, mesh=None, logits=False):
        step = real(model, mesh, logits)

        def broken(params, batch, cache):
            if how == "half":
                b = batch["tokens"].shape[0] // 2
                half = dict(batch, tokens=batch["tokens"][:b])
                sub = {k: v[:, :b] for k, v in cache.items()}
                nxt, _, last = step(params, half, sub)
                pad = torch.zeros_like(nxt)
                return (torch.cat([nxt, pad]), cache,
                        torch.cat([last, torch.zeros_like(last)]))
            nxt, cache, last = step(params, batch, cache)
            return (nxt + 1) % model.cfg.vocab, cache, last
        return broken
    monkeypatch.setattr(E, "make_prefill_step", make)


FAULTS = {
    ("jacobi", "state unchanged"): _stencil_unchanged,
    ("jacobi", "answer altered"): _stencil_altered,
    ("jacobi", "exchange left out"): _halos_left_out,
    ("decode", "state unchanged"):
        lambda mp: _broken_decode(mp, "unchanged"),
    ("decode", "token altered"): lambda mp: _broken_decode(mp, "token"),
    ("decode", "half the batch left out"):
        lambda mp: _broken_decode(mp, "half"),
    ("prefill", "token altered"): lambda mp: _broken_prefill(mp, "token"),
    ("prefill", "half the batch left out"):
        lambda mp: _broken_prefill(mp, "half"),
}


def test_sound_runs_are_correct(tiny):
    bench, pkg = tiny
    for cell in ("jacobi", "prefill", "decode"):
        _, out = run_tiny(bench, pkg, cell)
        assert out["correct"] is True, (cell, out["checks"])


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_turns_correct_false(tiny, monkeypatch, cell, fault):
    bench, pkg = tiny
    FAULTS[(cell, fault)](monkeypatch)
    run, out = run_tiny(bench, pkg, cell)
    assert out["correct"] is False, (fault, out["checks"], run.problems)
