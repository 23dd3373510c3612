"""Sequence parallelism in the port: the rule ``"act_seq": "model"`` made
explicit in the ``shard_map`` step bodies (``models.sharding.
split_sequence``, ``spmd.psum_scatter``), on meshes of CPU shards at the
smoke configurations (float32).

Held: one train step of five families on a (1, 2) mesh under the rule
against the JAX package's step jitted under ``use_sharding`` of a (1, 2)
JAX mesh with the same rule (``test_torch_mesh_train.py``'s tolerances:
the loss within relative 1e-5, the gradient norm within relative 1e-4,
the parameters and moments after the update within 1e-5); the port's
gradients under the rule against its own without, leaf by leaf, on the
routes that step leaves out (norm scales included: their gradient is
the sum of the slices' parts); the prefill's last logits and cache under
the rule against the prefill without it within 1e-5, every family, the
kernels' routes and the window path included, with no all-reduce of an activation; a decode step's
counts unchanged by the rule; over-decomposition, ZeRO-1 on the
multi-pod mesh and the compressed cross-pod step under the rule; and the
dry-run's ``opt`` level and ``sp`` stacks against JAX's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_smoke_config as jget_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch import dryrun as jdryrun
from repro.models import build_smoke as jbuild_smoke
from repro.models import sharding as JS
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import opcount
from repro_torch.convert import train_state_from_jax, \
    train_state_placed_from_jax
from repro_torch.distributed import spmd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as TLM
from repro_torch.launch.serve import Engine
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models import sharding as TS
from repro_torch.train import (TrainConfig, init_train_state,
                               make_mesh_grad_fn, make_train_step)
from repro_torch.train.optimizer import tree_flatten

# test_torch_mesh_train.py's tolerances
LOSS_TOL = 1e-5        # ce + aux, relative
GRAD_TOL = 1e-4        # the gradient norm and each leaf, relative (L2)
MOMENT_TOL = 1e-5      # parameters and moments after one update, absolute
PREFILL_TOL = 1e-5     # logits and cache against the prefill without SP

CPU = torch.device("cpu")
SP = {"act_seq": "model"}
ARCHS = ("yi_9b", "gemma3_27b", "olmoe_1b_7b", "llama4_scout_17b_a16e",
         "mamba2_370m", "recurrentgemma_9b", "whisper_large_v3",
         "pixtral_12b")
# the serving path's routes: the kernels' wrappers (their plain versions
# on a CPU tensor) and expert parallelism
SERVE_FLAGS = dict(use_flash_kernel=True, use_ssd_kernel=True,
                   moe_mode="ep")


def _tmesh(data, model):
    return TLM.make_smoke_mesh(data, model, devices=[CPU] * (data * model))


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _full(tree):
    return [(k, v.full() if isinstance(v, spmd.Sharded) else v)
            for k, v in tree_flatten(tree)]


def _batch(cfg, b=4, s=32, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        # over the first positions: a slice that holds part of them
        batch["vision_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = (0.1 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_states_close(got, want):
    for part in ("params", "m", "v", "master"):
        g = got.params if part == "params" else getattr(got.opt, part)
        w = want.params if part == "params" else getattr(want.opt, part)
        for (k, a), (_, b) in zip(_full(g), _full(w), strict=True):
            torch.testing.assert_close(a, b, rtol=0, atol=MOMENT_TOL,
                                       msg=f"{part} {k}")


def _jit(fn, *args):
    """``jax.jit(fn)(*args)``, compiled at XLA's backend optimization
    level 0: the same operations, in less of LLVM's time."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})(*args)


def _counted(fn, *args):
    counter = opcount.Counter()
    with opcount.counting(counter):
        out = fn(*args)
    return out, counter


# ---------------------------------------------------------------------------
# the reduce-scatter
# ---------------------------------------------------------------------------

def test_psum_scatter_gives_each_slice_psums_bits():
    """Over 4 shards, each shard's slice of ``psum_scatter`` along a
    middle dim is bit for bit its slice of ``psum``; the payload is the
    operand's, counted under ``reduce-scatter``."""
    n = 4
    mesh = spmd.Mesh([CPU] * n, (n,), ("a",))
    x = torch.randn((n, 3, 4 * n, 5), generator=torch.Generator()
                    .manual_seed(3))

    def body(t):
        s = spmd.psum_scatter(t[0], "a", 1)
        whole = spmd.psum(t[0], "a")
        i = spmd.axis_index("a")
        return torch.equal(s, whole[:, 4 * i:4 * i + 4]) * \
            torch.ones((1,))
    same, counter = _counted(spmd.shard_map(body, mesh, spmd.P("a"),
                                            spmd.P("a")), x)
    assert bool(same.full().all())
    for i in range(n):
        c = counter.shards[i].collectives
        assert c["reduce-scatter"] == 3 * 4 * n * 5 * 4
        assert c["all-reduce"] == 3 * 4 * n * 5 * 4
    assert counter.peak_all >= max(counter.peak_with_caller[i]
                                   for i in range(n))


# ---------------------------------------------------------------------------
# the train step under the rule: against JAX's and against the port's own
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi_9b", "olmoe_1b_7b", "mamba2_370m",
                                  "recurrentgemma_9b", "whisper_large_v3"])
def test_sp_step_equals_jax_sp_step_on_a_jax_mesh(arch, monkeypatch):
    """One step of the port on a (1, 2) mesh of CPU shards under the rule
    (the JAX state placed by ``train_state_placed_from_jax``) against
    JAX's jitted step under ``use_sharding`` of a (1, 2) JAX mesh with the
    same rule, from the same state and ``SyntheticLM`` batch: the loss,
    the gradient norm, the updated parameters and moments. The port's
    step reduce-scatters over the model axis."""
    cfg = jget_smoke(arch)
    jm = jbuild_smoke(cfg)
    jstate = _jit(functools.partial(jinit_train_state, jm),
                  jax.random.PRNGKey(0))
    batch = JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                     global_batch=8, seed=3)).batch(0)
    if cfg.enc_dec:
        batch["frames"] = (0.1 * np.random.default_rng(4).standard_normal(
            (8, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    jmesh = JMesh(np.array(jax.devices()[:2]).reshape(1, 2),
                  ("data", "model"))
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    mesh = _tmesh(1, 2)
    host = jax.tree.map(np.asarray, jstate)
    placed = train_state_placed_from_jax(host, tm, mesh)
    with JS.use_sharding(jmesh, SP):
        jnew, jmet = _jit(jmake_train_step(jm, JTrainConfig()), jstate,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    axes = []
    psum_scatter = spmd.psum_scatter
    monkeypatch.setattr(spmd, "psum_scatter", lambda x, axis, dim: (
        axes.append(axis), psum_scatter(x, axis, dim))[1])
    with TS.use_sharding(mesh, SP):
        assert TS.sequence_axis(mesh, 8, 32) == "model"
        tnew, tmet = make_train_step(tm, TrainConfig())(placed, tbatch)
    assert axes and set(axes) == {"model"}
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
        LOSS_TOL * float(jmet["loss"])
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
        GRAD_TOL * float(jmet["grad_norm"])
    _assert_states_close(tnew, train_state_from_jax(
        jax.tree.map(np.asarray, jnew)))


# the routes the step against JAX's leaves out: the families it does not
# train and the MoE layers' expert parallelism (its smoke models take the
# dense oracle)
GRAD_ROUTES = (("gemma3_27b", "dense"), ("pixtral_12b", "dense"),
               ("llama4_scout_17b_a16e", "dense"),
               ("llama4_scout_17b_a16e", "ep"), ("olmoe_1b_7b", "ep"))


@pytest.mark.parametrize("arch,mode", GRAD_ROUTES)
def test_sp_gradients_equal_the_step_without_the_rule(arch, mode):
    """The tensor-parallel gradients on a (1, 2) mesh under the rule
    against the same step without it, every leaf within relative L2 1e-4:
    the norm scales' too, whose gradient under the rule is the sum of the
    slices' parts (the ``psum`` over the model axis of a replicated
    leaf)."""
    cfg = tconfigs.get_smoke_config(arch)
    mesh = _tmesh(1, 2)
    batch = _batch(cfg)
    model = tbuild_smoke(cfg, moe_mode=mode)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             CPU, mesh=mesh)
    want, want_m = make_mesh_grad_fn(model)(state.params, batch)
    with TS.use_sharding(mesh, SP):
        got, got_m = make_mesh_grad_fn(model)(state.params, batch)
    for k in ("ce", "aux", "grad_norm"):
        assert abs(float(got_m[k]) - float(want_m[k])) <= \
            LOSS_TOL * max(abs(float(want_m[k])), 1e-30), k
    worst = {"/".join(k): _rel(g, w) for (k, g), (_, w) in
             zip(_full(got), _full(want), strict=True)}
    assert any("norm" in k for k in worst)
    assert max(worst.values()) <= GRAD_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:4]


# ---------------------------------------------------------------------------
# serving: the prefill splits, the decode does not
# ---------------------------------------------------------------------------

# every family over (1, 2); over (1, 4) the global attention's and the
# window path's
PREFILL_CASES = [(arch, (1, 2)) for arch in ARCHS] + [
    ("yi_9b", (1, 4)), ("gemma3_27b", (1, 4))]


@pytest.mark.parametrize("arch,shape", PREFILL_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for a, s in PREFILL_CASES])
def test_sp_prefill_equals_the_prefill_without_the_rule(arch, shape):
    """The Engine's prefill under the rule (the kernels' routes, expert
    parallelism; gemma3's local layers through the window path) against
    the same prefill without it on the same mesh: the last logits, the
    next token and every cache leaf within 1e-5. Under the rule the
    row-parallel sums are reduce-scattered: no all-reduce of a [B, S, D]
    activation is left."""
    cfg = tconfigs.get_smoke_config(arch)
    tm = tbuild_smoke(cfg, **SERVE_FLAGS)
    tp = tm.init(torch.Generator().manual_seed(1), CPU)
    b, s = 4, 32
    batch = _batch(cfg, b, s, seed=5)
    toks = batch.pop("tokens")
    extra = {k: v for k, v in batch.items() if k != "labels"}
    mesh = _tmesh(*shape)
    with TS.use_sharding(mesh):
        nxt, cache, logits = Engine(tm, tp, b, s + 4).prefill(
            toks, extra, logits=True)
    with TS.use_sharding(mesh, SP):
        eng = Engine(tm, tp, b, s + 4)
        (got_nxt, got_cache, got), counter = _counted(
            functools.partial(eng.prefill, logits=True), toks, extra)
    torch.testing.assert_close(got, logits, rtol=PREFILL_TOL,
                               atol=PREFILL_TOL)
    assert torch.equal(got_nxt, nxt)
    for (k, a), (_, w) in zip(_full(got_cache), _full(cache), strict=True):
        torch.testing.assert_close(a, w, rtol=PREFILL_TOL, atol=PREFILL_TOL,
                                   msg=str(k))
    for i in range(mesh.size):
        c = counter.shards[i].collectives
        assert c["reduce-scatter"] > 0
        assert c["all-reduce"] < b * s * cfg.d_model * 4, c


def test_decode_is_untouched_by_the_rule():
    """A decode step (S = 1, which the model axis does not divide) under
    the rule counts the same operators, bytes and collectives as without
    it, and the greedy tokens of both are equal."""
    cfg = tconfigs.get_smoke_config("yi_9b")
    tm = tbuild_smoke(cfg)
    tp = tm.init(torch.Generator().manual_seed(2), CPU)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32))
    mesh = _tmesh(1, 2)
    runs = []
    for rules in (None, SP):
        with TS.use_sharding(mesh, rules):
            eng = Engine(tm, tp, 4, 24)
            nxt, cache = eng.prefill(toks)
            out, counter = _counted(eng.decode, cache, nxt, 16, 4)
            runs.append((out, counter.summary()))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    assert TS.sequence_axis(mesh, 4, 1) is None


# ---------------------------------------------------------------------------
# over-decomposition, ZeRO-1 and the compressed step under the rule
# ---------------------------------------------------------------------------

def test_sp_od4_and_multi_pod_zero1_compose_with_the_rule():
    """The ``sp_od4`` stack (four microbatches) on (1, 2), and one step on
    the multi-pod mesh (pod, data, model) = (2, 2, 2) with the moments
    and master split over ``data`` (ZeRO-1), each against the same step
    without the rule: the loss and the state after the update. Then the
    compressed cross-pod step on that mesh: the loss and gradient norm
    (the int8 rounding of a value within noise of a half step may go
    either way)."""
    cfg = tconfigs.get_smoke_config("yi_9b")
    model = tbuild_smoke(cfg)
    batch = _batch(cfg, b=8)
    gen = torch.Generator
    for mesh, tcfg, kw in (
            (_tmesh(1, 2), TrainConfig(over_decompose=4), {}),
            (spmd.Mesh([CPU] * 8, (2, 2, 2), ("pod", "data", "model")),
             TrainConfig(), dict(zero=True)),
            (spmd.Mesh([CPU] * 8, (2, 2, 2), ("pod", "data", "model")),
             TrainConfig(compress_pod_grads=True),
             dict(zero=True, ef_pods=2))):
        out = []
        for rules in (None, SP):
            state = init_train_state(model, gen().manual_seed(0), CPU,
                                     mesh=mesh, **kw)
            with TS.use_sharding(mesh, rules):
                out.append(make_train_step(model, tcfg)(state, batch))
        (want, wm), (got, gm) = out
        assert abs(float(gm["loss"]) - float(wm["loss"])) <= \
            LOSS_TOL * float(wm["loss"])
        assert abs(float(gm["grad_norm"]) - float(wm["grad_norm"])) <= \
            GRAD_TOL * float(wm["grad_norm"])
        if not tcfg.compress_pod_grads:
            _assert_states_close(got, want)


# ---------------------------------------------------------------------------
# the dry-run's opt level and sp stacks
# ---------------------------------------------------------------------------

def test_rules_and_variants_equal_jaxs():
    """``_rules_for`` gives JAX's rules at both levels, and ``VARIANTS``
    holds JAX's named stacks under JAX's keywords, one for one."""
    for level in ("baseline", "opt"):
        assert dryrun._rules_for(level) == jdryrun._rules_for(level)
    assert dryrun.VARIANTS == jdryrun.VARIANTS


def test_sp_train_cell_reduce_scatters_and_holds_fewer_temporaries():
    """A smoke ``sp`` train cell (yi-9b ``train_4k``, one layer, batch 8,
    over (1, 2) meta shards) counts reduce-scatter bytes and holds fewer
    peak temporaries than its baseline; the ``opt`` level is the same
    step as the ``sp`` stack."""
    kw = dict(chips=2, probe=1, smoke=True, batch=8,
              extra_flags={"flash_block": 4096})
    res = {}
    for name, extra in (("baseline", {}), ("sp", dryrun.VARIANTS["sp"]),
                        ("opt", {"opt_level": "opt"})):
        cell = dryrun.build_cell("yi_9b", "train_4k", **kw, **extra)
        res[name] = dryrun.result_of(cell, *dryrun.count_step(cell), 0.0,
                                     "baseline")
    sp, base = res["sp"], res["baseline"]
    assert sp["collective_bytes_per_device"]["reduce-scatter"] > 0
    assert base["collective_bytes_per_device"]["reduce-scatter"] == 0
    assert sp["temp_size_in_bytes"] < base["temp_size_in_bytes"]
    for k in ("flops_per_device", "bytes_per_device", "temp_size_in_bytes",
              "collective_bytes_per_device"):
        assert res["opt"][k] == sp[k], k


def test_the_rule_on_a_state_that_is_not_placed_says_so():
    """An unplaced state runs no tensor-parallel body: under the rule its
    step raises with a pointer to ROADMAP.md rather than run the
    sequence whole."""
    cfg = tconfigs.get_smoke_config("yi_9b")
    model = tbuild_smoke(cfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), CPU)
    mesh = _tmesh(1, 2)
    with TS.use_sharding(mesh, SP):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_step(model, TrainConfig())(state, _batch(cfg))
