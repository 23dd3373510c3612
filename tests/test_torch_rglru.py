"""Parity of the port's recurrentgemma-9b serving path with the JAX
package's: the RG-LRU layer (``models.rglru``) in train, prefill and
decode, its log-depth scan against a sequential loop, the hybrid stack of
RG-LRU and local attention layers with remainder layers,
``convert.lm_from_jax`` / ``cache_from_jax`` for it, the Engine, the tasked
decode loop and the serve entry point.

The same numpy inputs and the JAX package's own weights go through both,
at the smoke configuration (6 layers: two periods of RG-LRU, RG-LRU, local
of window 16) and an 8-layer variant with two RG-LRU remainder layers. The
JAX oracles run without a mesh.

Also the Engine at prompts at and below the window, for gemma3-27b and
recurrentgemma-9b: held to the argmax of the JAX model's full forward, not
to the JAX Engine, whose ``grow`` pads a ring no longer than the prompt out
to ``max_len`` (or, where batch = prompt length, pads the batch axis).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.configs.base import RGLRUConfig as JRGLRUConfig
from repro.launch.serve import Engine as JEngine
from repro.models import build_smoke as jbuild_smoke
from repro.models import rglru as JR
from repro.models.layers import unbox
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, lm_from_jax, to_numpy, to_torch
from repro_torch.core import Runtime, RuntimeConfig
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Engine as TEngine
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models import rglru as TR
from repro_torch.serve import flatten, tasked_decode_loop

TOL = 1e-4
ARCH = "recurrentgemma_9b"
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _models(arch, n_layers, dtype=jnp.float32):
    """(cfg, JAX model, JAX params, port model, port params)."""
    jcfg = dataclasses.replace(jget_smoke(arch), n_layers=n_layers)
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                               n_layers=n_layers)
    jm = jbuild_smoke(jcfg, param_dtype=dtype)
    jp, _ = unbox(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return (jcfg, jm, jp, tbuild_smoke(tcfg, param_dtype=tdtype),
            lm_from_jax(jax.tree.map(np.asarray, jp)))


@pytest.fixture(params=[6, 8], ids=["6L", "8L_rem"])
def models(request):
    return _models(ARCH, request.param)


def _japply(jm, mode):
    """The JAX model's ``apply`` in ``mode``, jitted (one compile, where
    eager dispatch compiles op by op)."""
    return jax.jit(functools.partial(jm.apply, mode=mode))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the RG-LRU layer
# ---------------------------------------------------------------------------

RCFG = JRGLRUConfig(lru_width=32, conv_width=4)


@functools.lru_cache(maxsize=None)
def _layer_params(dtype=jnp.float32):
    """The JAX layer's weights (d_model 24, width 32, 4 blocks), numpy."""
    init = jax.jit(lambda k: unbox(JR.rglru_init(k, 24, RCFG, 4, dtype))[0])
    return {k: np.asarray(v) for k, v in init(jax.random.PRNGKey(3)).items()}


def _both(params):
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: to_torch(v) for k, v in params.items()})


def _cache(seed, b=2):
    rng = np.random.default_rng(seed)
    return {"conv": rng.standard_normal((b, 3, 32)).astype(np.float32),
            "state": rng.standard_normal((b, 32)).astype(np.float32)}


@pytest.mark.parametrize("mode,s,with_cache", [
    ("train", 24, False), ("prefill", 24, False), ("prefill", 17, True),
    ("decode", 1, True)])
def test_rglru_layer_matches_jax(mode, s, with_cache):
    """Output and new cache within 1e-4 of ``repro.models.rglru``; with a
    cache (a prefill from a non-zero conv and state, or a decode step) the
    port writes it in place and returns it."""
    jp, tp = _both(_layer_params())
    u = np.random.default_rng(s).standard_normal((2, s, 24)).astype(
        np.float32)
    c = _cache(s) if with_cache else None
    layer = jax.jit(functools.partial(JR.rglru_layer, rcfg=RCFG, mode=mode))
    jy, jc = layer(jp, jnp.asarray(u), cache=None if c is None else
                   {k: jnp.asarray(v) for k, v in c.items()})
    tc_in = None if c is None else {k: to_torch(v.copy()) for k, v in c.items()}
    ty, tc = TR.rglru_layer(tp, to_torch(u), rcfg=RCFG, mode=mode,
                            cache=tc_in)
    np.testing.assert_allclose(to_numpy(ty), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    if mode == "train":
        assert tc is None and jc is None
        return
    if with_cache:
        assert tc is tc_in
    assert tc["state"].dtype == torch.float32
    for key in ("conv", "state"):
        np.testing.assert_allclose(to_numpy(tc[key]), np.asarray(jc[key]),
                                   rtol=TOL, atol=TOL)


def test_rglru_scan_equals_sequential():
    """As the JAX package's ``test_rglru_scan_equals_sequential``: the
    prefill's scan gives what one decode step at a time gives, outputs and
    final state, within 1e-4."""
    _, tp = _both(_layer_params())
    u = to_torch(np.random.default_rng(4).standard_normal((2, 40, 24))
                 .astype(np.float32))
    full, fc = TR.rglru_layer(tp, u, rcfg=RCFG, mode="prefill")
    cache = TR.init_rglru_cache(2, 24, RCFG, dtype=torch.float32, device=CPU)
    outs = []
    for t in range(40):
        y, cache = TR.rglru_layer(tp, u[:, t:t + 1], rcfg=RCFG,
                                  mode="decode", cache=cache)
        outs.append(y)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=TOL,
                               atol=TOL)
    for key in ("conv", "state"):
        torch.testing.assert_close(cache[key], fc[key], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s", [1, 2, 5, 4096])
def test_linear_scan_multiplies_the_decays(s):
    """The doubling scan against a float64 loop, at 4096 steps of log a
    near -0.1, where exp of the cumulative log leaves float32's range:
    within 1e-5."""
    rng = np.random.default_rng(s)
    a = np.exp(-rng.uniform(0.05, 0.15, (2, s, 8))).astype(np.float32)
    b = rng.standard_normal((2, s, 8)).astype(np.float32)
    want = np.zeros_like(b, dtype=np.float64)
    h = np.zeros((2, 8))
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = TR.linear_scan(to_torch(a.copy()), to_torch(b.copy()))
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-5)


def test_rglru_init_keeps_its_float32_leaves():
    """Under bf16 weights the biases and ``lam`` stay float32, every leaf
    has the JAX init's shape, and ``lam`` (deterministic) equals the JAX
    init's within 1e-5: log(expm1(x)) at x near 1e-4 takes the last bit
    of the two packages' float32 ``linspace`` into its fifth digit."""
    want = _layer_params(jnp.bfloat16)
    got = TR.rglru_init(torch.Generator().manual_seed(0), 24,
                        tconfigs.RGLRUConfig(lru_width=32, conv_width=4), 4,
                        dtype=torch.bfloat16, device=CPU, lead=(2,))
    assert set(got) == set(want)
    for key, v in got.items():
        assert tuple(v.shape) == (2,) + want[key].shape, key
        f32 = key in ("b_r", "b_i", "lam")
        assert v.dtype == (torch.float32 if f32 else torch.bfloat16), key
        assert (want[key].dtype == np.float32) == f32, key
    np.testing.assert_allclose(to_numpy(got["lam"][1]), want["lam"],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the whole model: layout, conversion, prefill, engine, tasked loop, CLI
# ---------------------------------------------------------------------------

def test_lm_from_jax_keeps_float32_leaves_under_bf16():
    """The hybrid tree (periods "0", "1", "2"; two remainder layers) in
    bf16, as the JAX init lays it out and types it (zeros of its shapes
    and dtypes): norms, RG-LRU biases and ``lam`` stay float32, the rest
    bf16; the cache's RG-LRU state crosses as float32, its conv inputs and
    the local layers' rings as bf16."""
    jcfg = dataclasses.replace(jget_smoke(ARCH), n_layers=8)
    jm = jbuild_smoke(jcfg, param_dtype=jnp.bfloat16)
    shapes = jax.eval_shape(lambda k: unbox(jm.init(k))[0],
                            jax.random.PRNGKey(0))
    tp = lm_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes))
    tm = tbuild_smoke(dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                                          n_layers=8),
                      param_dtype=torch.bfloat16)
    tree = tp.tree()
    assert set(tree) == {"embed", "final_norm", "unembed", "periods",
                         "rem_0", "rem_1"}
    assert set(tree["periods"]) == {"0", "1", "2"}
    assert set(tree["periods"]["2"]) == {"norm1", "attn", "norm2", "mlp"}
    for block in (tree["periods"]["0"], tree["rem_1"]):
        assert set(block) == {"norm1", "rglru", "norm2", "mlp"}
    for name, leaf in flatten(tree):
        f32 = name.rsplit(".", 1)[-1] in ("b_r", "b_i", "lam", "norm1",
                                          "norm2", "final_norm")
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), name
    assert tree["periods"]["0"]["rglru"]["w_r"].shape == (2, 4, 16, 16)
    assert tree["rem_0"]["rglru"]["conv_w"].shape == (4, 64)
    jcache = jm.init_cache(2, 40)
    cache = cache_from_jax(jax.tree.map(np.asarray, jcache))
    assert cache["periods"]["0"]["state"].dtype == torch.float32
    assert cache["periods"]["0"]["conv"].dtype == torch.bfloat16
    assert cache["periods"]["2"]["k"].dtype == torch.bfloat16
    assert cache["rem_1"]["state"].shape == (2, 64)
    mine = tm.init_cache(2, 40, CPU)
    assert [(k, v.shape, v.dtype) for k, v in flatten(mine)] == \
        [(k, v.shape, v.dtype) for k, v in flatten(cache)]


def test_prefill_and_cache_match_jax(models):
    """Prefill hidden states within 1e-4 of ``lm_apply``; the caches (RG-LRU
    conv and state, local rings) equal JAX's through ``cache_from_jax``,
    with and without a capacity cache."""
    cfg, jm, jp, tm, tp = models
    toks = _tokens(1, (2, 40))
    jx, jc, _ = _japply(jm, "prefill")(jp, {"tokens": jnp.asarray(toks)},
                                       cache=jm.init_cache(2, 40))
    tx, tc = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, mode="prefill")
    np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=TOL,
                               atol=TOL)
    want = cache_from_jax(jax.tree.map(np.asarray, jc))
    torch.testing.assert_close(tc, want, rtol=TOL, atol=TOL)
    cap = tm.init_cache(2, 40, CPU)
    tx2, tc2 = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                        mode="prefill", cache=cap)
    assert tc2 is cap and torch.equal(tx2, tx)
    torch.testing.assert_close(tc2, want, rtol=TOL, atol=TOL)


def test_engine_matches_jax_engine_past_the_window():
    """24 decode steps from a 20-token prompt (window 16), 8 layers with
    the remainder: the same tokens as the JAX Engine, and as the argmax of
    a full forward."""
    cfg, jm, jp, tm, tp = _models(ARCH, 8)
    toks = _tokens(2, (2, 20))
    want = np.asarray(JEngine(jm, jp, 2, 44).generate(jnp.asarray(toks), 25))
    got = TEngine(tm, tp, 2, 44).generate(torch.from_numpy(toks), 25)
    np.testing.assert_array_equal(got.numpy(), want)
    full = torch.cat([torch.from_numpy(toks), got[:, :-1]], dim=1)
    hidden, _, _ = tm.apply(tp, {"tokens": full}, mode="train")
    fwd = tm.unembed(tp, hidden)[:, 19:].argmax(dim=-1)
    assert torch.equal(fwd.to(torch.int32), got)


def test_tasked_decode_loop_matches_engine(models):
    """The decode loop as hetero tasks over the mixed cache (RG-LRU conv
    and state, local rings, under ``periods`` and ``rem_{i}``) gives the
    Engine's tokens and caches."""
    cfg, jm, jp, tm, tp = models
    prompt, steps = 20, 6
    toks = torch.from_numpy(_tokens(4, (2, prompt)))
    eng = TEngine(tm, tp, 2, prompt + steps)
    nxt, cache = eng.prefill(toks)
    tasked = jax.tree.map(torch.clone, cache)
    want = eng.decode(cache, nxt, prompt, steps)
    lengths = torch.full((2,), prompt, dtype=torch.int32)
    with Runtime(RuntimeConfig(device="cpu", cpu_devices=2,
                               memory_capacity=1 << 28)) as rt:
        tok_obj, len_obj, c_objs = tasked_decode_loop(
            rt, tm, tp, tasked, nxt.clone(), lengths, steps)
        assert rt.stats()["tasks"] == steps
        assert {"periods.0.state", "periods.1.conv", "periods.2.k"} <= \
            set(c_objs)
        np.testing.assert_array_equal(tok_obj.get(), want[:, -1:].numpy())
        np.testing.assert_array_equal(len_obj.get(),
                                      np.full(2, prompt + steps))
        flat = dict(flatten(cache))
        assert sorted(flat) == sorted(c_objs)
        for key, obj in c_objs.items():
            np.testing.assert_array_equal(obj.get(), flat[key].numpy())


def test_serve_main_runs_recurrentgemma_on_the_cpu(capsys):
    before = dict(LAUNCHES)
    out = tserve.main(["--arch", "recurrentgemma-9b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "20", "--gen",
                       "5"])
    assert tuple(out.shape) == (2, 5)
    assert dict(LAUNCHES) == before               # no kernel on the CPU
    assert "generated (2, 5) on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# prompts at and below the window, against the JAX full forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,batch,prompt", [
    ("gemma3_27b", 2, 12), ("gemma3_27b", 2, 16),
    ("recurrentgemma_9b", 2, 12), ("recurrentgemma_9b", 2, 16),
    ("recurrentgemma_9b", 12, 12)])
def test_engine_at_and_below_the_window_matches_jax_full_forward(
        arch, batch, prompt):
    """The port's Engine (a ring of min(window, max_len) slots) from a
    prompt of 12 or 16 tokens (window 16) decodes to 40 positions, each
    token the argmax of the JAX model's full forward (``mode="train"``)
    over the prompt and the tokens before it; one case has batch = prompt
    length."""
    cfg, jm, jp, tm, tp = _models(arch, 6)
    toks = _tokens(prompt + batch, (batch, prompt))
    gen = 41 - prompt
    got = TEngine(tm, tp, batch, 40).generate(torch.from_numpy(toks), gen)
    full = np.concatenate([toks, got[:, :-1].numpy()], axis=1)
    hidden, _, _ = _japply(jm, "train")(jp, {"tokens": jnp.asarray(full)})
    want = np.asarray(jm.unembed(jp, hidden)[:, prompt - 1:].argmax(axis=-1))
    np.testing.assert_array_equal(got.numpy(), want)
