"""Parity of the port's MoE path (``repro_torch.models.moe``, ``MoEConfig``,
the MoE branch of ``models.transformer``, ``convert.lm_from_jax`` and the
serving entry points) with the JAX package's: routing, the dense oracle,
the expert-parallel path on the port's CPU meshes against JAX's on the two
host devices ``conftest.py`` pins, and the olmoe and llama4-scout smoke
models. Inputs come from numpy seeds; float32 within 1e-5 unless stated.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as PS

from repro.configs import MoEConfig as JMoEConfig
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import build_smoke as jbuild_smoke
from repro.models import moe as JM
from repro.models.layers import unbox
from repro.models.sharding import use_sharding as juse_sharding
from repro_torch import configs as tconfigs
from repro_torch.configs import MoEConfig
from repro_torch.convert import cache_from_jax, lm_from_jax, to_numpy, to_torch
from repro_torch.core import Runtime, RuntimeConfig
from repro_torch.distributed import spmd
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.serve import Engine as TEngine
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models import moe as TM
from repro_torch.models.sharding import use_sharding
from repro_torch.serve import tasked_decode_loop

TOL = 1e-5
CPU = torch.device("cpu")
ARCHS = ("olmoe_1b_7b", "llama4_scout_17b_a16e")


def _moe_params(d, mcfg, gated, dtype=jnp.float32, seed=0):
    """JAX ``moe_init`` weights as numpy (JAX's own config type)."""
    jcfg = JMoEConfig(**dataclasses.asdict(mcfg))
    p, _ = unbox(JM.moe_init(jax.random.PRNGKey(seed), d, jcfg, gated,
                             dtype=dtype))
    return jcfg, jax.tree.map(np.asarray, p)


def _t(tree):
    return jax.tree.map(to_torch, tree)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tmesh(data, model):
    return make_smoke_mesh(data, model, devices=[CPU] * (data * model))


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_moe_configs_equal_the_jax_packages(arch):
    for get_t, get_j in ((tconfigs.get_config, jget_config),
                         (tconfigs.get_smoke_config, jget_smoke)):
        t, j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert isinstance(t.moe, MoEConfig)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


def test_moe_param_counts():
    olmoe = tconfigs.get_config("olmoe-1b-7b")
    scout = tconfigs.get_config("llama4-scout-17b-16e")
    assert olmoe.param_count() == 6_919_094_272
    assert olmoe.active_param_count() == 1_279_852_544
    assert scout.param_count() == 107_769_856_000
    assert scout.active_param_count() == 17_168_957_440
    # a config without MoE counts every parameter as active
    yi = tconfigs.get_config("yi-9b")
    assert yi.active_param_count() == yi.param_count()


# ---------------------------------------------------------------------------
# routing and the dense oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,k", [(8, 2), (4, 1), (64, 8)])
def test_route_matches_jax(e, k):
    mcfg = MoEConfig(num_experts=e, top_k=k, d_ff_expert=8)
    jcfg, p = _moe_params(32, mcfg, True)
    x = _x(e, (48, 32))
    jw, ji, ja = JM._route(jnp.asarray(p["router"]), jnp.asarray(x), jcfg)
    tw, ti, ta = TM._route(to_torch(p["router"]), to_torch(x), mcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(to_numpy(tw), np.asarray(jw), rtol=TOL,
                               atol=TOL)
    assert abs(ta.item() - float(ja)) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 24])
@pytest.mark.parametrize("gated", [True, False])
def test_moe_dense_matches_jax(gated, shared, dtype):
    """Gated (SwiGLU) and GELU experts, with and without a shared expert;
    bf16 within 2e-2 (the combine and the expert products round to bf16
    in other orders)."""
    mcfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                     d_ff_shared=shared)
    jcfg, p = _moe_params(16, mcfg, gated, dtype=jnp.dtype(dtype))
    x = _x(1, (2, 12, 16)).astype(jnp.dtype(dtype))
    jo, ja = JM.moe_dense(p, jnp.asarray(x), jcfg, gated)
    to, ta = TM.moe_dense(_t(p), to_torch(x), mcfg, gated)
    assert to.dtype == to_torch(x).dtype and to.shape == x.shape
    tol = TOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to_numpy(to).astype(np.float32),
                               np.asarray(jo, np.float32), rtol=tol, atol=tol)
    assert abs(ta.item() - float(ja)) <= 1e-6


def test_moe_dense_routing_invariants():
    """The counterpart of the JAX package's test: the output keeps x's
    shape, the aux loss is non-negative, the routing weights of a token sum
    to 1 and every index names an expert."""
    mcfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=16)
    _, p = _moe_params(8, mcfg, True)
    x = to_torch(_x(2, (2, 8, 8)))
    out, aux = TM.moe_dense(_t(p), x, mcfg, True)
    assert out.shape == x.shape
    assert aux.item() >= 0
    w, idx, _ = TM._route(to_torch(p["router"]), x.reshape(-1, 8), mcfg)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert int(idx.max()) < mcfg.num_experts and int(idx.min()) >= 0


def test_slot_ranks_follow_token_order():
    """A stable sort: each assignment's slot counts the earlier ones (in
    token, then k order) to its expert."""
    idx = torch.tensor([[2, 0], [0, 1], [2, 1], [0, 2]])
    want = torch.tensor([[0, 0], [1, 0], [1, 1], [2, 2]])
    assert torch.equal(TM.slot_ranks(idx, 3), want)
    assert TM.capacity(16, MoEConfig(4, 2, 8), 0.05) == 4
    assert TM.capacity(16, MoEConfig(4, 2, 8), 1.25) == 12


# ---------------------------------------------------------------------------
# the expert-parallel path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.05, 8.0])
def test_ep_local_capacity_matches_jax(cf):
    """``_ep_local`` on a 1x1 mesh, as the JAX package's tiny-capacity test
    runs it: the same output as JAX's at capacity factor 0.05 (drops) and
    8.0 (none), finite, and smaller in magnitude with the drops."""
    mcfg = MoEConfig(num_experts=4, top_k=2, d_ff_expert=8)
    jcfg, p = _moe_params(8, mcfg, True)
    xf = _x(3, (16, 8))
    jmesh = jax.make_mesh((1,), ("model",))

    def jrun(factor):
        body = lambda xl: JM._ep_local(p, xl, jcfg, True, "model", factor)[0]
        return np.asarray(jax.shard_map(body, mesh=jmesh, in_specs=PS(),
                                        out_specs=PS(), check_vma=False)(
            jnp.asarray(xf)))

    def trun(factor):
        body = lambda xl: TM._ep_local(_t(p), xl, mcfg, True, "model",
                                       factor)[0]
        return spmd.shard_map(body, _tmesh(1, 1), in_specs=spmd.P(),
                              out_specs=spmd.P())(to_torch(xf)).full()

    got = trun(cf)
    np.testing.assert_allclose(to_numpy(got), jrun(cf), rtol=TOL, atol=TOL)
    assert bool(torch.isfinite(got).all())
    if cf < 1:
        assert got.abs().sum() < trun(8.0).abs().sum()


# (batch, seq, x seed): the seq-sharded form (S = 16 over two shards) and
# the decode form (S = 1, every model shard routes all tokens), each
# dropping assignments at capacity factor 1.25
EP_FORMS = {"seq_sharded": (4, 16, 1), "decode": (8, 1, 4)}


@pytest.mark.parametrize("form", sorted(EP_FORMS))
def test_moe_ep_matches_jax_on_two_shards(form):
    """``moe_ep`` on the port's (1, 2) CPU mesh against JAX ``moe_ep`` on a
    (1, 2) mesh of the two host devices, at capacity factor 1.25 with
    assignments dropped: output and aux within 1e-5."""
    b, s, seed = EP_FORMS[form]
    mcfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32)
    jcfg, p = _moe_params(16, mcfg, True)
    x = _x(seed, (b, s, 16))
    tp = _t(p)
    # the drops, by the capacity rule over each shard's tokens
    slices = np.split(x, 2, axis=1) if s % 2 == 0 else [x]
    cap = TM.capacity(b * s // len(slices), mcfg, 1.25)
    drops = sum(int((TM.slot_ranks(TM._route(
        tp["router"], to_torch(sl).reshape(-1, 16), mcfg)[1], 8) >= cap)
        .sum()) for sl in slices)
    assert drops > 0
    jmesh = JMesh(np.array(jax.devices()[:2]).reshape(1, 2),
                  ("data", "model"))
    with juse_sharding(jmesh):
        jo, ja = jax.jit(lambda p_, x_: JM.moe_ep(p_, x_, jcfg, True))(
            p, jnp.asarray(x))
    with use_sharding(_tmesh(1, 2)):
        to, ta = TM.moe_ep(tp, to_torch(x), mcfg, True)
    np.testing.assert_allclose(to_numpy(to), np.asarray(jo), rtol=TOL,
                               atol=TOL)
    assert abs(ta.item() - float(ja)) <= 1e-6
    # the drops change the result: the dense oracle keeps every assignment
    assert not torch.allclose(to, TM.moe_dense(tp, to_torch(x), mcfg,
                                               True)[0], atol=1e-3)


@pytest.mark.parametrize("s", [16, 1])
def test_moe_ep_matches_dense_oracle(s):
    """``moe_ep`` on a (2, 4) port mesh (CPU shards repeat) against JAX
    ``moe_dense`` at capacity factor 8 (no drops), the JAX package's
    multi-device setting: within 1e-4."""
    mcfg = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32)
    jcfg, p = _moe_params(16, mcfg, True)
    x = _x(5, (4, s, 16))
    want, _ = JM.moe_dense(p, jnp.asarray(x), jcfg, True)
    with use_sharding(_tmesh(2, 4)):
        got, aux = TM.moe_ep(_t(p), to_torch(x), mcfg, True,
                             capacity_factor=8.0)
    assert got.shape == x.shape and aux.dim() == 0
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_moe_ep_falls_back_to_dense_where_jax_does():
    """No mesh, a model axis of 1, or experts that do not divide over it:
    the dense oracle, bit for bit."""
    mcfg = MoEConfig(num_experts=6, top_k=2, d_ff_expert=8, d_ff_shared=8)
    _, p = _moe_params(8, mcfg, True)
    tp, x = _t(p), to_torch(_x(6, (2, 8, 8)))
    want = TM.moe_dense(tp, x, mcfg, True)
    for mesh in (None, _tmesh(2, 1), _tmesh(1, 4)):
        with use_sharding(mesh):
            got = TM.moe_ep(tp, x, mcfg, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    """(cfg, JAX model, JAX params, jitted JAX apply by mode, port model,
    port params) under the smoke flags (dense MoE)."""
    cfg = jget_smoke(arch)
    jm = jbuild_smoke(cfg)
    jp, _ = unbox(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    assert tm.flags.moe_mode == "dense" == jm.flags.moe_mode
    japply = {mode: jax.jit(functools.partial(jm.apply, mode=mode))
              for mode in ("train", "prefill", "decode")}
    return cfg, jm, jp, japply, tm, lm_from_jax(jax.tree.map(np.asarray, jp))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_forward_matches_jax(arch):
    cfg, jm, jp, japply, tm, tp = _models(arch)
    toks = _tokens(0, (2, 24))
    jx = japply["train"](jp, {"tokens": jnp.asarray(toks)})[0]
    tx, _, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, mode="train")
    np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(to_numpy(tm.unembed(tp, tx)),
                               np.asarray(jm.unembed(jp, jx)), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    """A prefill into a capacity cache, then decode steps from it: hidden
    states and caches within 1e-4 of the JAX model's at every step."""
    cfg, jm, jp, japply, tm, tp = _models(arch)
    b, s, steps = 2, 20, 4
    toks = _tokens(1, (b, s))
    jx, jc, _ = japply["prefill"](jp, {"tokens": jnp.asarray(toks)},
                                  cache=jm.init_cache(b, s + steps))
    # the JAX prefill returns the prompt's KV [L, B, S, KH, D]; its Engine
    # pads that to capacity before decoding
    jc = jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, steps),
                                            (0, 0), (0, 0))), jc)
    tc = tm.init_cache(b, s + steps, CPU)
    tx, tc = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                      mode="prefill", cache=tc)
    np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=1e-4,
                               atol=1e-4)
    cur = np.asarray(jm.unembed(jp, jx[:, -1:])).argmax(-1).astype(np.int32)
    for i in range(steps):
        lengths = np.full((b,), s + i, np.int32)
        torch.testing.assert_close(
            tc, cache_from_jax(jax.tree.map(np.asarray, jc)), rtol=1e-4,
            atol=1e-4)
        jx, jc, _ = japply["decode"](jp, {"tokens": jnp.asarray(cur),
                                          "lengths": jnp.asarray(lengths)},
                                     cache=jc)
        tx, tc = tm.apply(tp, {"tokens": torch.from_numpy(cur),
                               "lengths": torch.from_numpy(lengths)},
                          mode="decode", cache=tc)
        np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=1e-4,
                                   atol=1e-4)
        cur = np.asarray(jm.unembed(jp, jx)).argmax(-1).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_generate_matches_jax_full_forward(arch):
    """The port's greedy tokens equal the argmax of the JAX model's full
    forward over prompt + generated tokens (the JAX Engine's own end-to-end
    test fails on this tree, so it is not the reference)."""
    cfg, jm, jp, japply, tm, tp = _models(arch)
    prompt, gen = 16, 8
    toks = _tokens(2, (3, prompt))
    out = TEngine(tm, tp, 3, prompt + gen).generate(torch.from_numpy(toks),
                                                   gen)
    assert out.dtype == torch.int32 and out.shape == (3, gen)
    full = np.concatenate([toks, out[:, :-1].numpy()], axis=1)
    jx = japply["train"](jp, {"tokens": jnp.asarray(full)})[0]
    want = np.asarray(jm.unembed(jp, jx[:, prompt - 1:])).argmax(-1)
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_tasked_decode_loop_matches_engine(arch):
    """The decode loop as hetero tasks on a two-device CPU runtime gives
    the Engine's tokens and KV cache, bit for bit."""
    cfg, jm, jp, japply, tm, tp = _models(arch)
    prompt, steps = 16, 5
    toks = torch.from_numpy(_tokens(3, (2, prompt)))
    eng = TEngine(tm, tp, 2, prompt + steps)
    nxt, cache = eng.prefill(toks)
    tasked_cache = {k: v.clone() for k, v in cache.items()}
    want = eng.decode(cache, nxt, prompt, steps)
    lengths = torch.full((2,), prompt, dtype=torch.int32)
    with Runtime(RuntimeConfig(device="cpu", cpu_devices=2,
                               memory_capacity=1 << 28)) as rt:
        tok_obj, len_obj, c_objs = tasked_decode_loop(
            rt, tm, tp, tasked_cache, nxt.clone(), lengths, steps)
        assert rt.stats()["tasks"] == steps
        np.testing.assert_array_equal(tok_obj.get(), want[:, -1:].numpy())
        for key in ("k", "v"):
            np.testing.assert_array_equal(c_objs[key].get(),
                                          cache[key].numpy())


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-16e"])
def test_serve_main_runs_moe_on_the_cpu(arch, capsys):
    before = dict(LAUNCHES)
    out = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    assert tuple(out.shape) == (2, 4)
    assert dict(LAUNCHES) == before               # no kernel on the CPU
    assert "generated (2, 4) on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def test_lm_from_jax_carries_the_moe_block():
    """The MoE block keeps its leading layer axis, the shared expert's
    subtree and its dtypes: under bf16 weights the router stays float32.
    A subtree with a leaf the port does not know is refused."""
    cfg = jget_smoke("llama4_scout_17b_a16e")
    jm = jbuild_smoke(cfg, param_dtype=jnp.bfloat16)
    jp, _ = unbox(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    np_tree = jax.tree.map(np.asarray, jp)
    tree = lm_from_jax(np_tree).tree()
    layers = tree["layers"]
    assert set(layers) == {"norm1", "attn", "norm2", "moe"}
    moe = layers["moe"]
    assert set(moe) == {"router", "wi", "wo", "wg", "shared"}
    assert set(moe["shared"]) == {"wi", "wo", "wg"}
    e, d, f = (cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
    assert moe["router"].shape == (cfg.n_layers, d, e)
    assert moe["router"].dtype == torch.float32
    assert moe["wi"].shape == (cfg.n_layers, e, d, f)
    assert moe["wo"].shape == (cfg.n_layers, e, f, d)
    for key in ("wi", "wo", "wg"):
        assert moe[key].dtype == torch.bfloat16, key
        assert moe["shared"][key].dtype == torch.bfloat16, key
    block = dict(np_tree["periods"][0])
    block["moe"] = dict(block["moe"], bias=np.zeros(2, np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm_from_jax(dict(np_tree, periods=(block,)))
