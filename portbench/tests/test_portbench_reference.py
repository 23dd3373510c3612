"""The plain references against the program on the same inputs, on the
CPU at a small size: the benchmark's weights loaded into the program's
tree by leaf name and the domain cut into the program's chunks give both
sides the same thing."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from portbench import generate, lm, weights
from portbench.reference import dense_lm, stencil
from portbench.tests.conftest import SMALL_LM, _json, REPO

YI = _json(REPO / "portbench/configs/yi-9b.json")


def _float32_model(conf):
    from repro_torch.models import Model
    from repro_torch.models.transformer import SMOKE_FLAGS
    return Model(lm.port_config(conf), dataclasses.replace(
        SMOKE_FLAGS, param_dtype=torch.float32))


def test_exact_stencil_is_the_iteration():
    u0 = torch.rand((9, 9, 9), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    want = stencil.exact(u0, 40)
    assert stencil.max_abs_gap(stencil.sweeps(u0, 40, torch.float64),
                               want) < 1e-13


@pytest.mark.parametrize("cards", [1, 2])
def test_stencil_reference_holds_the_program(cards):
    from repro_torch.apps.jacobi3d import run_tasked
    from repro_torch.core import Runtime, RuntimeConfig
    conf = dict(_json(REPO / "portbench/configs/jacobi3d-768.json"),
                domain=12)
    u0 = generate.domain(conf, 5, "cpu")
    with Runtime(RuntimeConfig(device="cpu", cpu_devices=cards,
                               trace_graphs=True)) as rt:
        got = run_tasked(u0.numpy(), 25, rt, over_decomposition=8 // cards)
    assert stencil.max_abs_gap(torch.from_numpy(got),
                               stencil.exact(u0, 25)) < 1e-6
    # the plain sweeps in the program's precision agree bit for bit
    assert np.array_equal(got, stencil.sweeps(u0, 25).numpy())


def test_dense_reference_holds_the_program():
    conf = dict(YI, **SMALL_LM, dtype="float32", reduced=sorted(SMALL_LM))
    model = _float32_model(conf)
    w = weights.draw(weights.dense_lm_shapes(conf), 7, "cpu")
    tree = weights.into_tree(w, model.init_abstract().tree())
    tokens = torch.randint(0, conf["vocab"], (2, 24),
                           generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(2, 24, "cpu")
    x, cache = model.apply(tree, {"tokens": tokens}, mode="prefill",
                           cache=cache)
    got = model.unembed(tree, x)
    want, kv = dense_lm.forward(w, conf, tokens, range(24),
                                kv_positions=slice(0, 24))
    assert lm.rel_err(got, want) < 1e-5
    for layer, (k, v) in enumerate(kv):
        assert lm.rel_err(cache["k"][layer], k) < 1e-5
        assert lm.rel_err(cache["v"][layer], v) < 1e-5


def test_weights_go_in_by_name_only():
    conf = dict(YI, **SMALL_LM, dtype="float32")
    model = _float32_model(dict(conf, reduced=sorted(SMALL_LM)))
    w = weights.draw(weights.dense_lm_shapes(conf), 7, "cpu")
    w["layers.attn.wk"] = w["layers.attn.wk"][:, :, :1]
    with pytest.raises(ValueError, match="layers.attn.wk"):
        weights.into_tree(w, model.init_abstract().tree())


def test_config_file_agrees_with_the_program():
    from repro_torch.configs import get_config
    assert lm.port_config(YI) == get_config("yi-9b")
    with pytest.raises(ValueError, match="d_ff"):
        lm.port_config(dict(YI, d_ff=1))


def test_same_seed_same_inputs():
    mix = {"batch": 2, "prompt_len": 8, "distinct_batches": 3}
    a = generate.prompts(mix, 100, 2 ** 31 + 5, "cpu")
    assert torch.equal(a, generate.prompts(mix, 100, 2 ** 31 + 5, "cpu"))
    assert not torch.equal(a, generate.prompts(mix, 100, 2 ** 31 + 6, "cpu"))
    assert generate.sample(9, "x", 64, 4) == generate.sample(9, "x", 64, 4)
