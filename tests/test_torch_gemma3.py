"""Parity of the port's gemma3-27b serving path with the JAX package's:
``window_attention``, the ``local_attn`` layer and its ring-buffer cache,
``seq_sharded_decode`` over the port's mesh, the transformer's multi-kind
periods and remainder layers, ``convert.lm_from_jax`` / ``cache_from_jax``
for them, and the Engine, the tasked decode loop and the serve entry point.

The same numpy inputs and the JAX package's own weights go through both, at
the smoke configuration (6 layers: five local of window 16, one global) and
an 8-layer variant with two local remainder layers. Prompts are longer than
the window, so the band cuts rows and the decode ring wraps.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.serve import Engine as JEngine
from repro.models import attention as JA
from repro.models import build_smoke as jbuild_smoke
from repro.models.layers import unbox
from repro.models.sharding import use_sharding as juse_sharding
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, lm_from_jax, to_numpy, to_torch
from repro_torch.core import Runtime, RuntimeConfig
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.serve import Engine as TEngine
from repro_torch.models import attention as TA
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models.sharding import use_sharding
from repro_torch.serve import flatten, tasked_decode_loop

TOL = 1e-4
ARCH = "gemma3_27b"
CPU = torch.device("cpu")


def _cfgs(n_layers):
    return (dataclasses.replace(jget_smoke(ARCH), n_layers=n_layers),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH),
                                n_layers=n_layers))


@functools.lru_cache(maxsize=None)
def _models(n_layers):
    """(cfg, JAX model, JAX params, port model, port params)."""
    jcfg, tcfg = _cfgs(n_layers)
    jm = jbuild_smoke(jcfg)
    jp, _ = unbox(jm.init(jax.random.PRNGKey(0)))
    return (jcfg, jm, jp, tbuild_smoke(tcfg),
            lm_from_jax(jax.tree.map(np.asarray, jp)))


@pytest.fixture(params=[6, 8], ids=["6L", "8L_rem"])
def models(request):
    return _models(request.param)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def test_gemma3_configs_equal_the_jax_packages():
    for get_t, get_j in ((tconfigs.get_config, jget_config),
                         (tconfigs.get_smoke_config, jget_smoke)):
        assert dataclasses.asdict(get_t(ARCH)) == \
            dataclasses.asdict(get_j(ARCH))
        assert get_t(ARCH).param_count() == get_j(ARCH).param_count()
    assert tconfigs.get_config("gemma3-27b").n_layers == 62


# ---------------------------------------------------------------------------
# window attention and the local layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [48, 40, 16], ids=["48", "40_ragged", "16"])
def test_window_attention_matches_jax(s):
    rng = np.random.default_rng(s)
    q = rng.standard_normal((2, s, 2, 3, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = JA.window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               positions=jnp.arange(s, dtype=jnp.int32),
                               window=16)
    got = TA.window_attention(to_torch(q), to_torch(k), to_torch(v),
                              positions=torch.arange(s), window=16)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _attn_params(seed, d=48, h=6, kh=2, hd=8):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, h, hd), "wk": (d, kh, hd), "wv": (d, kh, hd),
              "wo": (h, hd, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("s", [40, 12])
def test_local_layer_prefill_writes_the_ring_like_jax(s):
    """The prefill's output, and its ring of the last 16 positions rolled
    to slot p % 16, written in place into a window-sized cache (12: a
    prompt shorter than the window fills slots [0, 12))."""
    p = _attn_params(s)
    x = np.random.default_rng(1).standard_normal((2, s, 48)).astype(
        np.float32)
    kw = dict(kind="local_attn", window=16, rope_theta=10000.0, n_kv_heads=2,
              mode="prefill")
    jy, jc = JA.attention_layer({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), **kw)
    cache = TA.init_attn_cache(2, 16, 2, 8, dtype=torch.float32, device=CPU)
    ty, tc = TA.attention_layer({k: to_torch(v) for k, v in p.items()},
                                to_torch(x), cache=cache, **kw)
    assert tc is cache
    np.testing.assert_allclose(to_numpy(ty), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    w = min(16, s)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_numpy(cache[key][:, :w]),
                                   np.asarray(jc[key]), rtol=TOL, atol=TOL)
        assert not cache[key][:, w:].any()


def test_local_layer_decode_writes_slot_pos_mod_window_like_jax():
    """Ragged lengths below, at and past the window: each request writes
    slot lengths[b] % 16 and attends the last min(pos + 1, 16) slots."""
    p = _attn_params(5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 1, 48)).astype(np.float32)
    kc, vc = (rng.standard_normal((4, 16, 2, 8)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([3, 15, 16, 45], np.int32)
    kw = dict(kind="local_attn", window=16, rope_theta=10000.0, n_kv_heads=2,
              mode="decode")
    jy, jc = JA.attention_layer(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        lengths=jnp.asarray(lengths),
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, **kw)
    cache = {"k": to_torch(kc.copy()), "v": to_torch(vc.copy())}
    ty, tc = TA.attention_layer({k: to_torch(v) for k, v in p.items()},
                                to_torch(x), lengths=torch.from_numpy(lengths),
                                cache=cache, **kw)
    assert tc is cache
    np.testing.assert_allclose(to_numpy(ty), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_numpy(cache[key]), np.asarray(jc[key]),
                                   rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# sequence-sharded decode over the port's mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis,shape,b,t,n_valid", [
    ("data", (4, 1), 1, 64, 50),      # valid ends inside shard 3
    ("data", (2, 1), 2, 48, 13),      # shard 1 holds no valid slot
    ("model", (2, 2), 4, 32, 20),     # seq over model, batch over data
])
def test_seq_sharded_decode_matches_decode_attention(axis, shape, b, t,
                                                     n_valid):
    rng = np.random.default_rng(t)
    q = rng.standard_normal((b, 2, 2, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, t, 2, 16)).astype(np.float32)
              for _ in range(2))
    valid = np.broadcast_to(np.arange(t)[None, :] < n_valid, (b, t))
    want = np.asarray(JA.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        valid=jnp.asarray(valid)))
    args = (to_torch(q), to_torch(kc), to_torch(vc))
    mesh = make_smoke_mesh(*shape, devices=[CPU] * (shape[0] * shape[1]))
    with use_sharding(mesh):
        got = TA.seq_sharded_decode(*args, valid=torch.from_numpy(valid.copy()),
                                    axis=axis)
    np.testing.assert_allclose(to_numpy(got), want, rtol=1e-5, atol=1e-5)


def test_seq_sharded_decode_gate_takes_plain_decode():
    """No mesh, an axis of size 1, or T not divisible: plain decode."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 2, 2, 8)).astype(np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((1, 30, 2, 8)).astype(
        np.float32)) for _ in range(2))
    valid = torch.arange(30)[None, :] < 21
    want = TA.decode_attention(q, kc, vc, valid=valid)
    assert torch.equal(TA.seq_sharded_decode(q, kc, vc, valid=valid), want)
    for shape in ((1, 2), (4, 1)):        # data of size 1; 30 % 4 != 0
        with use_sharding(make_smoke_mesh(*shape, devices=[CPU] * 4
                                          if shape == (4, 1) else [CPU] * 2)):
            got = TA.seq_sharded_decode(q, kc, vc, valid=valid)
        assert torch.equal(got, want), shape


# ---------------------------------------------------------------------------
# the whole model: layout, prefill, decode, engine, tasked loop, CLI
# ---------------------------------------------------------------------------

def test_lm_from_jax_keeps_periods_and_remainders(models):
    cfg, jm, jp, tm, tp = models
    tree = tp.tree()
    rems = [f"rem_{i}" for i in range(cfg.n_layers % 6)]
    assert set(tree) == {"embed", "final_norm", "unembed", "periods", *rems}
    assert sorted(tree["periods"], key=int) == [str(j) for j in range(6)]
    assert tree["periods"]["5"]["attn"]["wq"].shape == (1, 64, 4, 16)
    for r in rems:
        assert tree[r]["attn"]["wq"].shape == (64, 4, 16)
    cache = tm.init_cache(2, 40, CPU)
    assert cache["periods"]["5"]["k"].shape == (1, 2, 40, 2, 16)   # global
    assert cache["periods"]["0"]["k"].shape == (1, 2, 16, 2, 16)   # ring
    for r in rems:
        assert cache[r]["k"].shape == (2, 16, 2, 16)


def test_prefill_and_cache_match_jax(models):
    """Prefill hidden states within 1e-4 of ``lm_apply``; the caches
    (global KV of length S, local rings) equal JAX's through
    ``cache_from_jax``, with and without a capacity cache."""
    cfg, jm, jp, tm, tp = models
    toks = _tokens(1, (2, 40))
    jx, jc, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="prefill",
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


def test_greedy_decode_past_the_window_matches_jax(models):
    """24 decode steps from a 20-token prompt (window 16): the same tokens
    as the JAX Engine, and as the argmax of a full forward."""
    cfg, jm, jp, tm, tp = models
    toks = _tokens(2, (2, 20))
    want = np.asarray(JEngine(jm, jp, 2, 44).generate(jnp.asarray(toks), 25))
    got = TEngine(tm, tp, 2, 44).generate(torch.from_numpy(toks), 25)
    np.testing.assert_array_equal(got.numpy(), want)
    full = torch.cat([torch.from_numpy(toks), got[:, :-1]], dim=1)
    hidden, _, _ = tm.apply(tp, {"tokens": full}, mode="train")
    fwd = tm.unembed(tp, hidden)[:, 19:].argmax(dim=-1)
    assert torch.equal(fwd.to(torch.int32), got)


def test_seq_shard_kv_decode_matches_jax_under_use_sharding():
    """``Flags.seq_shard_kv="data"`` on a 2-shard mesh (8 layers, with the
    remainder), batch 3, which ``data`` does not divide: the Engine places
    the weights and splits every attention cache's slots over ``data``
    (each shard holds T / 2 of them), so the global layers decode over
    their shard's slots and combine the partials across ``data``; the
    tokens equal the JAX Engine's under ``use_sharding`` and the unsharded
    run's."""
    cfg, jm, jp, tm, tp = _models(8)
    tcfg = tm.cfg
    toks = _tokens(3, (3, 20))
    jm2 = jbuild_smoke(cfg, seq_shard_kv="data")
    jmesh = JMesh(np.array(jax.devices()[:2]).reshape(2, 1),
                  ("data", "model"))
    with juse_sharding(jmesh):
        want = np.asarray(JEngine(jm2, jp, 3, 44).generate(
            jnp.asarray(toks), 25))
    tm2 = tbuild_smoke(tcfg, seq_shard_kv="data")
    with use_sharding(make_smoke_mesh(2, 1, devices=[CPU] * 2)):
        eng = TEngine(tm2, tp, 3, 44)
        nxt, cache = eng.prefill(torch.from_numpy(toks))
        for name, leaf in flatten(cache):
            t_dim = len(leaf.shape) - 3
            assert all(s.shape[t_dim] * 2 == leaf.shape[t_dim]
                       for s in leaf.shards), name
        got = torch.cat([nxt, eng.decode(cache, nxt, 20, 24)], dim=1)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = TEngine(tm, tp, 3, 44).generate(torch.from_numpy(toks), 25)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_tasked_decode_loop_matches_engine(models):
    """The decode loop as hetero tasks over the nested cache (rings and
    global caches of mixed lengths) gives the Engine's tokens and caches."""
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
        assert "periods.5.k" in c_objs and "periods.0.v" in c_objs
        np.testing.assert_array_equal(tok_obj.get(), want[:, -1:].numpy())
        np.testing.assert_array_equal(len_obj.get(),
                                      np.full(2, prompt + steps))
        flat = dict(flatten(cache))
        assert sorted(flat) == sorted(c_objs)
        for key, obj in c_objs.items():
            np.testing.assert_array_equal(obj.get(), flat[key].numpy())


def test_kernel_flag_matches_jax_pallas_flag():
    """``use_flash_kernel`` sends the global layer through the kernel's
    wrapper (its plain version on the CPU) as ``use_pallas_flash`` sends
    it through the Pallas kernel (interpret mode); the local layers take
    the window path in both."""
    jcfg, tcfg = _cfgs(6)
    jm = jbuild_smoke(jcfg, use_pallas_flash=True)
    jp, _ = unbox(jm.init(jax.random.PRNGKey(0)))
    tm = tbuild_smoke(tcfg, use_flash_kernel=True)
    tp = lm_from_jax(jax.tree.map(np.asarray, jp))
    toks = _tokens(5, (2, 128))
    jx = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode="train")[0]
    tx = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, mode="train")[0]
    np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=2e-4,
                               atol=2e-4)


def test_serve_main_runs_gemma3_on_the_cpu(capsys):
    n = LAUNCHES["flash_attention"]
    out = tserve.main(["--arch", "gemma3-27b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "40", "--gen", "24"])
    assert tuple(out.shape) == (2, 24)
    assert LAUNCHES["flash_attention"] == n       # no kernel on the CPU
    assert "generated (2, 24) on cpu" in capsys.readouterr().out
