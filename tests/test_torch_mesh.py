"""Mesh placement in the port (``repro_torch.models.sharding``,
``launch.mesh``, ``distributed.spmd.place``, the tensor- and
expert-parallel layers and the serving steps under ``use_sharding``)
against the JAX package: the logical axes tree, the parameter, optimizer,
batch and cache specs leaf for leaf on JAX meshes of the two host devices
``conftest.py`` pins (and ``resolve_spec`` / ``zero_shard`` on stand-in
meshes of production shapes), ``constrain``, each shard's share of the
placed weights, and the smoke models served over (1, 2) and (1, 4) meshes
of CPU shards against the one-device Engine (float32 logits within 1e-5,
tokens equal) and the argmax of the JAX model's full forward.
"""
import contextlib
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
from repro.launch import mesh as JLM
from repro.models import build_smoke as jbuild_smoke
from repro.models import moe as JM
from repro.models import sharding as JS
from repro.models.layers import boxed_abstract, unbox
from repro.train.optimizer import AdamWState as JAdamWState
from repro.train.optimizer import TrainState as JTrainState
from repro_torch import configs as tconfigs
from repro_torch.convert import (cache_tree_from_jax, lm_placed_from_jax,
                                 lm_tree_from_jax, to_torch)
from repro_torch.distributed import spmd
from repro_torch.launch import mesh as TLM
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Engine
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models import moe as TM
from repro_torch.models import sharding as TS
from repro_torch.serve import make_decode_step, tasked_decode_loop
from repro_torch.train import abstract_train_state

TOL = 1e-5
CPU = torch.device("cpu")
ARCHS = tconfigs.ARCH_IDS
# served on a mesh: attention (global, local and global, with the vision
# embeddings), dense MLP, MoE, the SSD stack (replicated), RG-LRU with local
# attention, and the encoder-decoder (its frames in ``extra``)
SERVED = ("yi_9b", "phi4_mini_3_8b", "codeqwen15_7b", "gemma3_27b",
          "pixtral_12b", "olmoe_1b_7b", "llama4_scout_17b_a16e",
          "mamba2_370m", "recurrentgemma_9b", "whisper_large_v3")
MESHES = ((1, 2), (1, 4))


def _jmesh(data, model):
    return JMesh(np.array(jax.devices()[:2]).reshape(data, model),
                 ("data", "model"))


def _tmesh(data, model):
    return TLM.make_smoke_mesh(data, model, devices=[CPU] * (data * model))


class _Shape:
    """A stand-in mesh: JAX's ``resolve_spec`` and ``zero_shard`` read
    only ``.shape``."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))


def _spec(s):
    """A JAX ``NamedSharding`` / ``PartitionSpec`` or the port's, as a
    tuple."""
    return tuple(getattr(s, "spec", s))


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch, smoke=True):
    cfg = jget_smoke(arch) if smoke else jget_config(arch)
    jm = jbuild_smoke(cfg)
    return jm, boxed_abstract(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _specs(tree):
    """A nested dict of the port's shardings as tuples."""
    return {k: _specs(v) if isinstance(v, dict) else _spec(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# logical axes and the spec builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_axes_tree_equals_jaxs(arch):
    """``Model.axes()`` is JAX's ``unbox(model.init(key))[1]`` in the
    port's layout, leaf for leaf, and names every leaf of the weights."""
    _, (_, jaxes) = _jax_abstract(arch)
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    got = tm.axes()
    assert got == lm_tree_from_jax(jaxes)
    params = dict(_leaves(tm.init(None, "meta").tree()))
    axes = dict(_leaves(got))
    assert sorted(params) == sorted(axes)
    for path, leaf in params.items():
        assert len(axes[path]) == leaf.dim(), path


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jaxs(arch, shape):
    jm, (jabs, jaxes) = _jax_abstract(arch)
    want = lm_tree_from_jax(JLM.param_specs(jabs, jaxes, _jmesh(*shape)),
                            _spec)
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    params = tm.init(torch.Generator().manual_seed(0), "meta").tree()
    got = TLM.param_specs(params, tm.axes(), _tmesh(*shape))
    assert _specs(got) == want


@pytest.mark.parametrize("zero", [True, False])
@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
@pytest.mark.parametrize("arch", ["yi_9b", "llama4_scout_17b_a16e",
                                  "mamba2_370m"])
def test_opt_specs_equal_jaxs(arch, shape, zero):
    """ZeRO-1: m, v and master take the data axis on their first free
    dim that it divides; the weights keep their specs."""
    jm, (jabs, jaxes) = _jax_abstract(arch)
    f32 = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                       jabs)
    jstate = JTrainState(params=jabs, opt=JAdamWState(
        step=jax.ShapeDtypeStruct((), jnp.int32), m=f32, v=f32, master=f32))
    want = JLM.opt_specs(jstate, jaxes, _jmesh(*shape), zero=zero)
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    got = TLM.opt_specs(abstract_train_state(tm), tm.axes(), _tmesh(*shape),
                        zero=zero)
    for part in ("m", "v", "master"):
        assert _specs(getattr(got.opt, part)) == \
            lm_tree_from_jax(getattr(want.opt, part), _spec)
    assert _specs(got.params) == lm_tree_from_jax(want.params, _spec)
    assert _spec(got.opt.step) == _spec(want.opt.step) == ()


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
def test_batch_specs_equal_jaxs(shape):
    for batch in (1, 2, 4):
        for kind in ("train", "prefill", "decode"):
            want = JLM.batch_specs(kind, _jmesh(*shape), batch)
            got = TLM.batch_specs(kind, _tmesh(*shape), batch)
            assert {k: _spec(v) for k, v in got.items()} == \
                {k: _spec(v) for k, v in want.items()}


# (batch, seq_shard, seq_axis): batch over the data axes, or T over data
# where the batch does not divide (long-context decode), or T over model;
# T over a data axis the batch already takes is no spec (JAX raises)
CACHE_CASES = ((4, False, None), (1, True, None), (4, False, "model"),
               (3, True, "model"))


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jaxs(arch, shape):
    jcfg = jget_smoke(arch)
    jm = jbuild_smoke(jcfg)
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    cases = CACHE_CASES + (((1, False, "data"),) if shape[0] > 1 else ())
    for b, seq_shard, seq_axis in cases:
        jabs = jax.eval_shape(lambda: jm.init_cache(b, 64))
        want = JLM.cache_specs(jabs, _jmesh(*shape), jcfg,
                               seq_shard=seq_shard, seq_axis=seq_axis)
        got = TLM.cache_specs(tm.init_cache(b, 64, "meta"), _tmesh(*shape),
                              tm.cfg, seq_shard=seq_shard, seq_axis=seq_axis)
        assert cache_tree_from_jax(want, _spec) == _specs(got), \
            (b, seq_shard, seq_axis)


STANDINS = (((1, 4), ("data", "model")), ((16, 16), ("data", "model")),
            ((2, 16, 16), ("pod", "data", "model")))


@pytest.mark.parametrize("arch", ["llama4_scout_17b_a16e", "gemma3_27b",
                                  "recurrentgemma_9b", "mamba2_370m"])
@pytest.mark.parametrize("standin", STANDINS, ids=["1x4", "16x16",
                                                   "2x16x16"])
def test_resolve_spec_and_zero_shard_at_production_shapes(standin, arch):
    """Every leaf of a full-size config (its axes and shape) resolves to
    JAX's spec, and ZeRO-1 adds the data axes where JAX's does, on
    stand-ins of the (1, 4), (16, 16) and (2, 16, 16) meshes."""
    shape, names = standin
    mesh = _Shape(shape, names)
    tm = tbuild_smoke(tconfigs.get_config(arch))
    params = dict(_leaves(tm.init(None, "meta").tree()))
    zaxes = tuple(a for a in ("pod", "data") if a in names)
    for path, ax in _leaves(tm.axes()):
        leaf = params[path]
        got = TS.resolve_spec(ax, shape=tuple(leaf.shape), mesh=mesh)
        want = JS.resolve_spec(ax, shape=tuple(leaf.shape), mesh=mesh)
        assert tuple(got) == tuple(want), (ax, leaf.shape)
        assert tuple(TLM.zero_shard(got, tuple(leaf.shape), mesh, zaxes)) \
            == tuple(JLM.zero_shard(want, tuple(leaf.shape), mesh, zaxes))


def test_production_mesh_keeps_jaxs_axis_names():
    mesh = TLM.make_production_mesh(devices=[CPU] * 4)
    assert mesh.shape == {"data": 1, "model": 4}
    mesh = TLM.make_production_mesh(multi_pod=True, devices=[CPU] * 4)
    assert mesh.shape == {"pod": 2, "data": 1, "model": 2}
    mesh = TLM.make_production_mesh(multi_pod=True, devices=[CPU] * 8,
                                    data=2)
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    with pytest.raises(ValueError, match="even"):
        TLM.make_production_mesh(multi_pod=True, devices=[CPU] * 3)


# ---------------------------------------------------------------------------
# constrain and placement
# ---------------------------------------------------------------------------

def test_constrain_keeps_values_and_lays_out_sharded_ones():
    x = torch.arange(4 * 8 * 6, dtype=torch.float32).view(4, 8, 6)
    assert TS.constrain(x, "act_batch", None, "act_heads") is x   # no mesh
    mesh = _tmesh(2, 2)
    with TS.use_sharding(mesh):
        assert TS.constrain(x, "act_batch") is x           # a plain tensor
        rep = spmd.device_put(x, mesh, spmd.P())
        # adds axes: each shard slices what it holds
        got = TS.constrain(rep, "act_batch", None, "act_heads")
        assert tuple(got.spec) == ("data", None, "model")
        assert got.shards[3].shape == (2, 8, 3)
        assert torch.equal(got.full(), x)
        assert got.shards[1].data_ptr() == \
            rep.shards[1][:, :, 3:].data_ptr()
        # drops one and moves another: gathered and split again
        back = TS.constrain(got, None, "act_heads")
        assert tuple(back.spec) == (None, "model")
        assert torch.equal(back.full(), x)
        # a dim the axis does not divide stays whole (resolve_spec)
        odd = spmd.device_put(x[:3], mesh, spmd.P())
        assert tuple(TS.constrain(odd, "act_batch").spec) == ()

        def body(xs):
            assert TS.constrain(xs, "act_batch") is xs
            return xs
        spmd.shard_map(body, mesh, spmd.P("data"), spmd.P("data"))(x)
        ns = TS.named_sharding(mesh, "act_batch", "act_mlp", shape=(4, 6))
        assert ns == spmd.NamedSharding(mesh, spmd.P("data", "model"))
        assert ns.shard_shape((4, 6)) == (2, 3)


def test_placed_weights_hold_each_shards_share():
    """llama4-scout's smoke config on (1, 4): a shard holds 1 of the 4
    experts, 2 of the 8 query heads, 64 of the 256 vocabulary rows, and
    every kv head (2 kv heads do not divide 4); the router splits with the
    experts. Placing moves each leaf whole to the shards' blocks."""
    arch = "llama4_scout_17b_a16e"
    jm, _ = _jax_abstract(arch)
    jp, _ = unbox(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    jp = jax.tree.map(np.asarray, jp)
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    mesh = _tmesh(1, 4)
    placed = lm_placed_from_jax(jp, tm, mesh)
    lay = placed["layers"]
    for i in range(4):
        assert lay["moe"]["wi"].shards[i].shape == (3, 1, 64, 128)
        assert lay["moe"]["router"].shards[i].shape == (3, 64, 1)
        assert lay["attn"]["wq"].shards[i].shape == (3, 64, 2, 8)
        assert lay["attn"]["wo"].shards[i].shape == (3, 2, 8, 64)
        assert lay["attn"]["wk"].shards[i].shape == (3, 64, 2, 8)
        assert placed["embed"].shards[i].shape == (64, 64)
        assert lay["moe"]["shared"]["wi"].shards[i].shape == (3, 64, 32)
    assert tuple(lay["attn"]["wk"].spec) == ()
    full = lm_tree_from_jax(jp, to_torch)
    for path, leaf in _leaves(placed):
        want = functools.reduce(lambda t, k: t[k], path, full)
        assert torch.equal(leaf.full(), want), path
        split = any(leaf.spec)
        share = sum(t.numel() for t in leaf.shards)
        assert share == want.numel() * (1 if split else 4), path
        if split:   # the shards' blocks are copies of their own
            assert len({t.data_ptr() for t in leaf.shards}) == 4


def test_split_axes_are_read_off_the_specs():
    """The logical axes the layers treat as split come from the placed
    weights' specs: llama4-scout's smoke config splits its heads,
    experts, MLP columns and vocabulary over (1, 4) and replicates its 2
    kv heads; over (1, 1) nothing splits. ``is_split`` answers inside
    ``split_weights`` only. An axis split in one leaf and not in another
    is refused."""
    tm = tbuild_smoke(tconfigs.get_smoke_config("llama4_scout_17b_a16e"))
    tree = tm.init(torch.Generator().manual_seed(0), CPU).tree()
    for shape, want in (((1, 4), {"heads", "experts", "mlp", "vocab"}),
                        ((1, 1), set())):
        mesh = _tmesh(*shape)
        split = TS.split_axes(tm.axes(),
                              TLM.param_specs(tree, tm.axes(), mesh))
        assert split == want
        with TS.split_weights(split):
            assert all(TS.is_split(a) for a in want)
            assert not TS.is_split("kv_heads")
    assert not TS.is_split("heads")
    mesh = _tmesh(1, 2)
    specs = {"a": spmd.NamedSharding(mesh, spmd.P("model")),
             "b": spmd.NamedSharding(mesh, spmd.P())}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TS.split_axes({"a": ("heads",), "b": ("heads",)}, specs)


@pytest.mark.parametrize("shape", MESHES)
def test_init_on_a_mesh_draws_the_one_device_weights(shape):
    """``Model.init`` with a mesh draws the same values, in the same
    order, as without one, straight into each shard's blocks."""
    tm = tbuild_smoke(tconfigs.get_smoke_config("llama4_scout_17b_a16e"))
    want = tm.init(torch.Generator().manual_seed(3), CPU).tree()
    got = tm.init(torch.Generator().manual_seed(3), CPU,
                  mesh=_tmesh(*shape))
    specs = TLM.param_specs(want, tm.axes(), _tmesh(*shape))
    got = dict(_leaves(got))
    assert sorted(got) == sorted(p for p, _ in _leaves(want))
    for path, w in _leaves(want):
        g = got[path]
        assert torch.equal(g.full(), w), path
        assert tuple(g.spec) == tuple(
            functools.reduce(lambda t, k: t[k], path, specs).spec)


# ---------------------------------------------------------------------------
# serving on a mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    """(JAX model, JAX weights as numpy, jitted JAX train forward, port
    model, port weights) for the smoke config; the MoE layers through
    ``moe_ep`` on both sides."""
    jm = jbuild_smoke(jget_smoke(arch), moe_mode="ep")
    jp, _ = unbox(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    jp = jax.tree.map(np.asarray, jp)
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch), moe_mode="ep")
    from repro_torch.convert import lm_from_jax
    return jm, jp, tm, lm_from_jax(jp)


def _groups(b, s, steps, data, model):
    """The tokens each shard routes together in a served prefill of S
    positions and ``steps`` decode steps, as rows of one forward over
    [B, S + steps] (b-major): each data shard's requests, split into the
    model shards' slices of S where they divide (decode: every model
    shard routes all of them)."""
    n = s + steps
    bl = b // data
    gid = np.zeros((b, n), np.int64)
    seq = s % model == 0 and s >= model
    for i in range(b):
        for t in range(n):
            if t < s:
                part = t // (s // model) if seq else 0
            else:
                part = model + t - s
            gid[i, t] = (i // bl) * (model + steps) + part
    return gid.reshape(-1)


def _kept(idx, gid, mcfg, xp, cf=1.25):
    """Which assignments [T, k] the capacity rule keeps (``xp``: torch or
    jax.numpy, traceable): in each group of tokens, those whose slot (the
    assignments to the same expert before them, in token then k order)
    lies below the capacity of the group's token count."""
    keep = []
    order = np.argsort(gid, kind="stable")
    for g in np.unique(gid):
        rows = np.nonzero(gid == g)[0]
        flat = idx[rows].reshape(-1)
        onehot = (flat[:, None] == xp.arange(mcfg.num_experts)[None, :])
        rank = (xp.cumsum(onehot.astype(xp.int32) if xp is jnp
                          else onehot.int(), 0) - 1)
        rank = (rank * onehot).sum(-1)
        keep.append((rank < TM.capacity(len(rows), mcfg, cf)).reshape(
            len(rows), -1))
    keep = xp.concatenate(keep, 0) if xp is jnp else torch.cat(keep, 0)
    inverse = np.argsort(order)
    return keep[inverse]


@contextlib.contextmanager
def _ep_drops(route_mod, gid_of, mcfg, xp):
    """While open, ``route_mod._route`` zeroes the weight of every
    assignment ``moe_ep`` drops (``gid_of()``: the routing groups of the
    call's tokens), so that the dense oracle computes what a mesh's
    ``moe_ep`` does. Counts the drops the port's calls see."""
    route, count = route_mod._route, [0]

    def call(router_w, x, mcfg_):
        w, idx, aux = route(router_w, x, mcfg_)
        keep = _kept(idx, gid_of(), mcfg, xp)
        if xp is torch:
            count[0] += int((~keep).sum())
        return w * keep.astype(w.dtype) if xp is jnp \
            else w * keep.to(w.dtype), idx, aux

    route_mod._route = call
    try:
        yield count
    finally:
        route_mod._route = route


def _frames(cfg, b, seed=9):
    """An encoder-decoder's frames [B, encoder_seq, D] at 0.1 scale, as
    ``tests/test_arch_smoke.py`` draws them."""
    return 0.1 * torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32))


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "1x4"])
@pytest.mark.parametrize("arch", SERVED)
def test_served_on_a_mesh_equals_one_device_and_jax(arch, shape):
    """The Engine under ``use_sharding`` of a CPU mesh: the prefill's last
    logits within 1e-5 of the one-device Engine's and the greedy tokens
    equal, with the assignments ``moe_ep`` drops dropped in the one-device
    run too; and the tokens are the argmax of the JAX model's full forward
    over prompt + tokens (the same drops). The weights and the cache lie
    on the mesh by their specs."""
    jm, jp, tm, tp = _models(arch)
    cfg = tm.cfg
    b, s, gen = 4, 16, 6
    toks = torch.from_numpy(_tokens(7, (b, s)))
    extra = {}
    if cfg.frontend == "vision":
        extra["vision_embeds"] = 0.02 * torch.from_numpy(
            np.random.default_rng(8).standard_normal(
                (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        extra["frames"] = _frames(cfg, b)
    mesh = _tmesh(*shape)
    with TS.use_sharding(mesh):
        eng = Engine(tm, tp, b, s + gen)
        assert all(isinstance(t, spmd.Sharded) for _, t in _leaves(eng.params))
        nxt, cache, logits = eng.prefill(toks, extra, logits=True)
        for _, t in _leaves(cache):
            assert isinstance(t, spmd.Sharded) and t.mesh is mesh
        out = eng.generate(toks, gen, extra)
    assert out.dtype == torch.int32 and out.shape == (b, gen)
    # the one-device Engine's prefill and steps, routing groups by call
    gid = _groups(b, s, gen - 1, *shape).reshape(b, -1)
    pos = [None]            # the decode step's position, None in prefill
    drops = contextlib.nullcontext([0]) if cfg.moe is None else _ep_drops(
        TM, lambda: gid[:, :s].reshape(-1) if pos[0] is None
        else gid[:, pos[0]], cfg.moe, torch)
    one = Engine(tm, tp, b, s + gen)
    with drops as dropped:
        want_next, cache1, want_logits = one.prefill(toks, extra,
                                                     logits=True)
        want, nxt1 = [want_next], want_next
        lengths = torch.full((b,), s, dtype=torch.int32)
        step = make_decode_step(tm)
        for i in range(gen - 1):
            pos[0] = s + i
            nxt1, cache1 = step(tp, cache1, nxt1, lengths)
            lengths = lengths + 1
            want.append(nxt1)
    torch.testing.assert_close(logits, want_logits, rtol=TOL, atol=TOL)
    assert torch.equal(nxt, want_next)
    assert torch.equal(out, torch.cat(want, dim=1))
    if cfg.moe is not None:
        assert dropped[0] > 0
    # the JAX model's full forward, with the same drops
    full = np.concatenate([toks.numpy(), out[:, :-1].numpy()], axis=1)
    jbatch = {"tokens": jnp.asarray(full)}
    jbatch.update({k: jnp.asarray(v.numpy()) for k, v in extra.items()})
    jdrops = contextlib.nullcontext() if cfg.moe is None else _ep_drops(
        JM, lambda: gid.reshape(-1), cfg.moe, jnp)
    with jdrops, JS.use_sharding(None):
        jx = jax.jit(functools.partial(jm.apply, mode="train"))(
            jp, jbatch)[0]
        jwant = np.asarray(jm.unembed(jp, jx[:, s - 1:])).argmax(-1)
    np.testing.assert_array_equal(out.numpy(), jwant)


def test_serve_main_on_a_production_mesh_of_cpu_shards(capsys):
    out = tserve.main(["--arch", "llama4-scout-17b-16e", "--smoke",
                       "--device", "cpu", "--production-mesh", "--batch",
                       "2", "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


# whisper's smoke config with 258 vocabulary rows: split over (1, 2),
# replicated over (1, 4) (258 % 4 = 2), as whisper-large-v3's 51,866 are
WHISPER_258 = dataclasses.replace(
    tconfigs.get_smoke_config("whisper_large_v3"), vocab=258)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "1x4"])
def test_whisper_served_where_the_vocabulary_splits_and_where_not(shape):
    """The encoder-decoder with a vocabulary that divides the model axis
    of (1, 2) and not that of (1, 4): the lookup, the logits and the
    greedy token vocab-parallel on the first, plain on the second. The
    prefill's last logits within 1e-5 of the one-device Engine's, the
    tokens equal; the cross cache holds each shard's kv heads."""
    tm = tbuild_smoke(WHISPER_258)
    tp = tm.init(torch.Generator().manual_seed(4), CPU)
    b, s, gen = 4, 16, 6
    toks = torch.from_numpy(_tokens(5, (b, s), vocab=258))
    extra = {"frames": _frames(tm.cfg, b, seed=6)}
    mesh = _tmesh(*shape)
    with TS.use_sharding(mesh):
        eng = Engine(tm, tp, b, s + gen)
        want_split = {"heads", "kv_heads", "mlp"} | (
            {"vocab"} if shape[1] == 2 else set())
        assert TS.split_axes(tm.axes(), eng.params) == want_split
        nxt, cache, logits = eng.prefill(toks, extra, logits=True)
        ck = cache["decoder"]["cross"]["k"]
        assert ck.shards[0].shape[-2] == tm.cfg.n_kv_heads // shape[1]
        out = eng.generate(toks, gen, extra)
    one = Engine(tm, tp, b, s + gen)
    want_next, _, want_logits = one.prefill(toks, extra, logits=True)
    torch.testing.assert_close(logits, want_logits, rtol=TOL, atol=TOL)
    assert torch.equal(nxt, want_next)
    assert torch.equal(out, one.generate(toks, gen, extra))


def test_rglru_gates_refuse_a_shard_of_part_of_a_block():
    """recurrentgemma's smoke config has 4 gate blocks of 16 channels: over
    (1, 8) a shard's 8 channels are half a block, which the layer refuses
    with a pointer to ROADMAP.md, serving and training alike."""
    from repro_torch.train import make_mesh_grad_fn
    tm = tbuild_smoke(tconfigs.get_smoke_config("recurrentgemma_9b"))
    tp = tm.init(torch.Generator().manual_seed(0), CPU)
    mesh = _tmesh(1, 8)
    toks = torch.from_numpy(_tokens(3, (2, 8)))
    with TS.use_sharding(mesh):
        eng = Engine(tm, tp, 2, 10)
        assert "lru" in TS.split_axes(tm.axes(), eng.params)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eng.prefill(toks)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_mesh_grad_fn(tm)(eng.params, {
                "tokens": toks, "labels": toks})


def test_tasked_decode_loop_on_a_mesh_says_so():
    tm = tbuild_smoke(tconfigs.get_smoke_config("yi_9b"))
    tp = tm.init(torch.Generator().manual_seed(0), CPU)
    with TS.use_sharding(_tmesh(1, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tasked_decode_loop(None, tm, tp, {}, torch.zeros(2, 1),
                               torch.zeros(2), 1)
