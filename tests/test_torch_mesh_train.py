"""Training in the port under a mesh (``repro_torch.train.train_step`` on a
placed ``TrainState``, the differentiable collectives of
``distributed.spmd``, ``launch.mesh.place_train_state``, the checkpointer
and ``launch.train --production-mesh``) on meshes of CPU shards, at the
smoke configurations (float32, ``SMOKE_FLAGS``).

The tensor-parallel step is held to the port's one-device step, leaf for
leaf, at ``test_torch_train.py``'s tolerances: the loss within relative
1e-5, every gradient leaf (gathered) within relative L2 1e-4, the
gradient norm within relative 1e-6 and the state after one update
(parameters, moments) within 1e-5 absolute; MoE through ``moe_ep`` with
the one-device oracle dropping what the mesh drops. At (1, 2) it is held
to the JAX package's step jitted under ``use_sharding`` of a JAX mesh of
the two host devices ``conftest.py`` pins. Each collective's gradient is
held to autograd of its one-device form in float64 (1e-12).
"""
import contextlib
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.configs import get_smoke_config as jget_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_smoke as jbuild_smoke
from repro.models import sharding as JS
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import Checkpointer
from repro_torch.convert import (train_state_from_jax,
                                 train_state_placed_from_jax, to_numpy)
from repro_torch.distributed import spmd
from repro_torch.launch import mesh as TLM
from repro_torch.launch import train as ttrain
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models import moe as TM
from repro_torch.train import (AdamWConfig, TrainConfig, abstract_train_state,
                               init_train_state, make_grad_fn,
                               make_mesh_grad_fn, make_train_step)
from repro_torch.train.optimizer import global_norm, tree_flatten

# test_torch_train.py's tolerances
LOSS_TOL = 1e-5        # ce + aux, relative
GRAD_TOL = 1e-4        # each gradient leaf, relative L2
ADAM_TOL = 1e-6        # the gradient norm, relative
MOMENT_TOL = 1e-5      # parameters and moments after one update, absolute
COLLECTIVE_TOL = 1e-12  # a collective's gradient in float64

CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(0)
# the families that train on a mesh: attention (global; local and global),
# MoE, the SSD stack (replicated), RG-LRU with local attention, and the
# encoder-decoder
ARCHS = ("yi_9b", "gemma3_27b", "olmoe_1b_7b", "llama4_scout_17b_a16e",
         "mamba2_370m", "recurrentgemma_9b", "whisper_large_v3")
MESHES = ((1, 2), (1, 4), (2, 2))
# the JAX package's defaults, as test_torch_train.py's step against JAX
# takes them: the first update moves a parameter by at most about the
# learning rate (3e-6), since Adam's first step is g / (|g| + eps), which
# rounding can move by O(1) where g is near zero; the moments (0.1 g and
# 0.05 g^2 of the clipped gradient) carry the comparison
OPT = AdamWConfig()
# test_torch_train.py's over-decomposition step, whose parameters move
# enough for its bounds to mean something
OD_OPT = AdamWConfig(lr_peak=2e-3, warmup_steps=5, total_steps=500,
                     weight_decay=0.0)


def _tmesh(data, model):
    return TLM.make_smoke_mesh(data, model, devices=[CPU] * (data * model))


def _batch(cfg, b=4, s=32, seed=0):
    """Seeded tokens and labels (and the vision embeddings or an
    encoder-decoder's frames at 0.1 scale)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = _frames(cfg, b, rng)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _frames(cfg, b, rng):
    return (0.1 * rng.standard_normal(
        (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _value(x):
    return x.full() if isinstance(x, spmd.Sharded) else x


def _full(tree):
    return [(k, _value(v)) for k, v in tree_flatten(tree)]


def _leaves(tree):
    return [x for _, x in tree_flatten(tree)]


def _states(model, mesh):
    """The one-device state and the same state drawn onto ``mesh``."""
    one = init_train_state(model, torch.Generator().manual_seed(0), CPU)
    placed = init_train_state(model, torch.Generator().manual_seed(0), CPU,
                              mesh=mesh)
    for (k, a), (_, b) in zip(tree_flatten(one.params),
                              _full(placed.params)):
        assert torch.equal(a, b), k
    return one, placed


def _assert_grads_close(got, want, got_m, want_m):
    loss = float(want_m["ce"] + want_m["aux"])
    assert abs(float(got_m["ce"] + got_m["aux"]) - loss) <= \
        LOSS_TOL * abs(loss)
    got = dict(_full(got))
    worst = {"/".join(k): _rel(got[k], w) for k, w in tree_flatten(want)}
    assert max(worst.values()) <= GRAD_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:4]
    gn = float(global_norm(want))
    assert abs(float(got_m["grad_norm"]) - gn) <= ADAM_TOL * gn


def _assert_states_close(got, want):
    for part in ("params", "m", "v", "master"):
        g = got.params if part == "params" else getattr(got.opt, part)
        w = want.params if part == "params" else getattr(want.opt, part)
        for (k, a), (_, b) in zip(_full(g), _full(w)):
            torch.testing.assert_close(a, b, rtol=0, atol=MOMENT_TOL,
                                       msg=f"{part} {k}")
    assert int(_value(got.opt.step)) == int(_value(want.opt.step))


# ---------------------------------------------------------------------------
# the step on a mesh against the one-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_equals_one_device_step(arch, shape):
    """The tensor-parallel gradients (gathered) and one whole step on a
    placed state against the one-device ones from the same weights and
    batch; every shard's replicated leaves hold the same bits after it."""
    cfg = tconfigs.get_smoke_config(arch)
    model = tbuild_smoke(cfg)
    mesh = _tmesh(*shape)
    one, placed = _states(model, mesh)
    batch = _batch(cfg)
    want, want_m = make_grad_fn(model)(one.params, batch)
    want_m["grad_norm"] = global_norm(want)
    got, got_m = make_mesh_grad_fn(model)(placed.params, batch)
    _assert_grads_close(got, want, got_m, want_m)
    step = make_train_step(model, TrainConfig(opt=OPT))
    one, m1 = step(one, batch)
    placed, mm = step(placed, batch)
    assert abs(float(mm["loss"]) - float(m1["loss"])) <= \
        LOSS_TOL * float(m1["loss"])
    _assert_states_close(placed, one)
    for _, leaf in tree_flatten(placed.params):
        if not any(leaf.spec):
            assert all(torch.equal(t, leaf.shards[0]) for t in leaf.shards)


def _keep_and_aux(router_w, x, idx, gid, mcfg):
    """The one-device oracle's routing made ``moe_ep``'s over a mesh:
    within each group of tokens (``gid``: one shard's slice), an
    assignment whose slot (the assignments to its expert before it, in
    token then k order) reaches the capacity at 1.25 is dropped, and the
    load-balance loss is the mean of the groups' own."""
    probs = torch.softmax(x.float() @ router_w, dim=-1)
    keep = torch.zeros(idx.shape, dtype=torch.bool)
    aux = []
    for g in torch.unique(gid):
        rows = torch.nonzero(gid == g)[:, 0]
        onehot = (idx[rows].reshape(-1, 1)
                  == torch.arange(mcfg.num_experts)).int()
        rank = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
        keep[rows] = (rank < TM.capacity(len(rows), mcfg, 1.25)).view(
            len(rows), -1)
        aux.append(TM.balance_loss(probs[rows], idx[rows], mcfg))
    return keep, torch.stack(aux).mean()


@contextlib.contextmanager
def _ep_reference(gid, mcfg):
    """While open, ``moe._route`` (the dense oracle's routing, one device)
    takes ``_keep_and_aux``'s drops and loss; counts the drops."""
    route, count = TM._route, [0]

    def call(router_w, x, mcfg_):
        w, idx, _ = route(router_w, x, mcfg_)
        keep, aux = _keep_and_aux(router_w, x, idx, gid, mcfg)
        count[0] += int((~keep).sum())
        return w * keep.to(w.dtype), idx, aux

    TM._route = call
    try:
        yield count
    finally:
        TM._route = route


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "1x4", "2x2"])
@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "llama4_scout_17b_a16e"])
def test_moe_ep_mesh_gradients_equal_one_device_with_the_drops(arch, shape):
    """MoE layers through ``moe_ep`` in train mode (each model shard
    routes its slice of S, exchanges by ``all_to_all``, drops past the
    capacity): the loss and gradients against the one-device oracle that
    drops the same assignments and averages the shards' load-balance
    losses, as ``moe_ep`` does."""
    cfg = tconfigs.get_smoke_config(arch)
    model = tbuild_smoke(cfg, moe_mode="ep")
    data, tp = shape
    mesh = _tmesh(*shape)
    one, placed = _states(model, mesh)
    batch = _batch(cfg)
    b, s = batch["tokens"].shape
    bi, si = np.meshgrid(np.arange(b), np.arange(s), indexing="ij")
    gid = torch.from_numpy(((bi // (b // data)) * tp
                            + si // (s // tp)).reshape(-1))
    with _ep_reference(gid, cfg.moe) as dropped:
        want, want_m = make_grad_fn(model)(one.params, batch)
    assert dropped[0] > 0
    want_m["grad_norm"] = global_norm(want)
    got, got_m = make_mesh_grad_fn(model)(placed.params, batch)
    _assert_grads_close(got, want, got_m, want_m)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recomputation_on_a_mesh_changes_no_gradient(remat):
    """Under ``Flags.remat`` the backward recomputes each layer and each
    loss chunk (chunks of 16), issuing their collectives again on every
    shard: the gradients equal the one-device step's."""
    cfg = tconfigs.get_smoke_config("llama4_scout_17b_a16e")
    model = tbuild_smoke(cfg, remat=remat, loss_chunk=16)
    one, placed = _states(model, _tmesh(1, 2))
    batch = _batch(cfg)
    want, want_m = make_grad_fn(model)(one.params, batch)
    want_m["grad_norm"] = global_norm(want)
    got, got_m = make_mesh_grad_fn(model)(placed.params, batch)
    _assert_grads_close(got, want, got_m, want_m)


@pytest.mark.parametrize("arch,remat", [
    ("recurrentgemma_9b", "full"), ("recurrentgemma_9b", "dots"),
    ("whisper_large_v3", "full")])
def test_recomputation_of_rglru_and_the_encoder_decoder(arch, remat):
    """The same for the RG-LRU stack (its gates' gather and ``out``'s
    ``psum`` issued again in the backward) and for the encoder-decoder,
    which recomputes every encoder and decoder layer under any remat but
    "none", as the JAX package's ``jax.checkpoint`` of both scans does."""
    cfg = tconfigs.get_smoke_config(arch)
    model = tbuild_smoke(cfg, remat=remat, loss_chunk=16)
    one, placed = _states(model, _tmesh(1, 2))
    batch = _batch(cfg)
    want, want_m = make_grad_fn(model)(one.params, batch)
    want_m["grad_norm"] = global_norm(want)
    got, got_m = make_mesh_grad_fn(model)(placed.params, batch)
    _assert_grads_close(got, want, got_m, want_m)


# whisper's smoke config with 258 vocabulary rows: split over (1, 2),
# replicated over (1, 4), as whisper-large-v3's 51,866 are
WHISPER_258 = dataclasses.replace(
    tconfigs.get_smoke_config("whisper_large_v3"), vocab=258)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)], ids=["1x2", "1x4"])
def test_whisper_trains_where_the_vocabulary_splits_and_where_not(shape):
    """One step of the encoder-decoder whose vocabulary divides the model
    axis of (1, 2) (the lookup and the loss vocab-parallel, ``embed`` and
    ``unembed`` split) and not that of (1, 4) (both replicated, their
    gradients summed over the shards): the gradients and the updated
    state against the one-device step."""
    model = tbuild_smoke(WHISPER_258)
    mesh = _tmesh(*shape)
    one, placed = _states(model, mesh)
    split = shape[1] == 2
    assert bool(any(placed.params["embed"].spec)) == split
    assert bool(any(placed.params["unembed"].spec)) == split
    batch = _batch(WHISPER_258)
    want, want_m = make_grad_fn(model)(one.params, batch)
    want_m["grad_norm"] = global_norm(want)
    got, got_m = make_mesh_grad_fn(model)(placed.params, batch)
    _assert_grads_close(got, want, got_m, want_m)
    step = make_train_step(model, TrainConfig(opt=OPT))
    one, m1 = step(one, batch)
    placed, mm = step(placed, batch)
    assert abs(float(mm["loss"]) - float(m1["loss"])) <= \
        LOSS_TOL * float(m1["loss"])
    _assert_states_close(placed, one)


def test_over_decomposition_on_a_mesh():
    """od=2 on a (1, 2) mesh: the one-device od=2 step within the
    tolerances above, and the mesh's od=1 step within the over-
    decomposition bounds of ``test_torch_train.py`` (ce 1e-3, parameters
    5e-3)."""
    cfg = tconfigs.get_smoke_config("yi_9b")
    model = tbuild_smoke(cfg)
    mesh = _tmesh(1, 2)
    batch = _batch(cfg)
    one, placed = _states(model, mesh)
    step2 = make_train_step(model, TrainConfig(opt=OPT, over_decompose=2))
    one, m1 = step2(one, batch)
    placed, m2 = step2(placed, batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= \
        LOSS_TOL * float(m1["loss"])
    _assert_states_close(placed, one)
    _, od2 = _states(model, mesh)
    _, od1 = _states(model, mesh)
    od2, m2 = make_train_step(model, TrainConfig(
        opt=OD_OPT, over_decompose=2))(od2, batch)
    od1, m1 = make_train_step(model, TrainConfig(opt=OD_OPT))(od1, batch)
    assert abs(float(m2["ce"]) - float(m1["ce"])) < 1e-3
    assert max(float((a - b).abs().max()) for (_, a), (_, b) in
               zip(_full(od2.params), _full(od1.params))) < 5e-3


# ---------------------------------------------------------------------------
# against JAX's step on a JAX mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi_9b", "olmoe_1b_7b", "mamba2_370m",
                                  "recurrentgemma_9b", "whisper_large_v3"])
def test_mesh_step_equals_jax_step_on_a_jax_mesh(arch):
    """One step of the port on a (1, 2) mesh of CPU shards (the JAX
    state placed by ``train_state_placed_from_jax``) against JAX's jitted
    step under ``use_sharding`` of a (1, 2) JAX mesh, from the same state
    and ``SyntheticLM`` batch (an encoder-decoder's with seeded frames):
    the loss, the gradient norm, and the updated parameters and
    moments."""
    cfg = jget_smoke(arch)
    jm = jbuild_smoke(cfg)
    jstate = jinit_train_state(jm, KEY)
    data = JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=8, seed=3))
    batch = data.batch(0)
    if cfg.enc_dec:
        batch["frames"] = _frames(cfg, 8, np.random.default_rng(4))
    jmesh = JMesh(np.array(jax.devices()[:2]).reshape(1, 2),
                  ("data", "model"))
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    placed = train_state_placed_from_jax(jax.tree.map(np.asarray, jstate),
                                         tm, _tmesh(1, 2))
    with JS.use_sharding(jmesh):
        jnew, jmet = jax.jit(jmake_train_step(jm, JTrainConfig()))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tmet = make_train_step(tm, TrainConfig())(
        placed, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
        LOSS_TOL * float(jmet["loss"])
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
        GRAD_TOL * float(jmet["grad_norm"])
    want = train_state_from_jax(jax.tree.map(np.asarray, jnew))
    _assert_states_close(tnew, want)


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------

N = 4


COLLECTIVES = {
    # name: (body on one shard's x, the same on the stacked [N, ...] x)
    "psum": (lambda x: spmd.psum(x, "a"),
             lambda x: x.sum(0, keepdim=True).expand_as(x)),
    "pmean": (lambda x: spmd.pmean(x, "a"),
              lambda x: x.mean(0, keepdim=True).expand_as(x)),
    "all_gather": (lambda x: spmd.all_gather(x, "a"),
                   lambda x: x[None].expand((N,) + x.shape)),
    "all_to_all": (lambda x: spmd.all_to_all(x, "a", 1, 0, tiled=True),
                   lambda x: x.view(N, 3, N, 2).permute(2, 0, 1, 3)
                   .reshape(N, N * 3, 2)),
    "psum_scatter": (lambda x: spmd.psum_scatter(x, "a", 1),
                     lambda x: x.sum(0).view(3, N, 2).permute(1, 0, 2)),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collective_gradients_equal_autograd_of_one_device(name):
    """Each collective in a differentiable ``shard_map`` over 4 shards:
    its values and its input's gradient (its adjoint, run by each shard
    in its own thread) against the one-device form of the same function
    on the stacked shards, in float64."""
    body, plain = COLLECTIVES[name]
    mesh = spmd.Mesh([CPU] * N, (N,), ("a",))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((N, 3, 2 * N if name in ("all_to_all", "psum_scatter")
                     else 5),
                    generator=g, dtype=torch.float64)
    want_y = plain(x)
    cot = torch.randn(want_y.shape, generator=g, dtype=torch.float64)
    xs = x.clone().requires_grad_()
    y = spmd.shard_map(lambda t: body(t[0])[None], mesh, spmd.P("a"),
                       spmd.P("a"))(xs).full()
    got = torch.autograd.grad((y * cot).sum(), xs)[0]
    xw = x.clone().requires_grad_()
    want = torch.autograd.grad((plain(xw) * cot).sum(), xw)[0]
    torch.testing.assert_close(y.detach(), want_y, rtol=0,
                               atol=COLLECTIVE_TOL)
    torch.testing.assert_close(got, want, rtol=0, atol=COLLECTIVE_TOL)


def test_ppermute_refuses_a_tensor_that_requires_grad():
    """``ppermute`` has no adjoint (only the halo exchange, never
    differentiated, sends by it): in a differentiable ``shard_map`` it
    raises rather than return a copy that silently carries no gradient;
    without grad it still sends, by [(0, 1), (0, 2), (3, 0)]."""
    mesh = spmd.Mesh([CPU] * N, (N,), ("a",))
    x = torch.randn((N, 3, 5), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    run = spmd.shard_map(
        lambda t: spmd.ppermute(t[0], "a", [(0, 1), (0, 2), (3, 0)])[None],
        mesh, spmd.P("a"), spmd.P("a"))
    with pytest.raises(RuntimeError, match="not differentiable"):
        run(x.clone().requires_grad_())
    want = torch.stack([x[3], x[0], x[0], torch.zeros_like(x[0])])
    torch.testing.assert_close(run(x).full(), want, rtol=0, atol=0)


def test_pmax_carries_no_gradient_and_the_loss_is_vocab_parallel():
    """``pmax`` returns a tensor without autograd history; the vocab-
    parallel cross-entropy (``layers.softmax_cross_entropy`` inside a
    body whose weights split ``vocab``), its max taken by ``pmax``, has
    the whole-vocabulary loss's value and gradient within 1e-6 (the loss
    takes its logits in float32)."""
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import split_weights
    mesh = spmd.Mesh([CPU] * N, (N,), ("model",))
    g = torch.Generator().manual_seed(2)
    logits = 4 * torch.randn((2, 5, 8 * N), generator=g, dtype=torch.float32)
    labels = torch.randint(0, 8 * N, (2, 5), generator=g)
    seen = []

    def body(lg, lb):
        seen.append(spmd.pmax(lg.amax(), "model").requires_grad)
        with split_weights(frozenset({"vocab"})):
            loss = L.softmax_cross_entropy(lg, lb)
        return (loss / N)[None]      # replicated: its parts sum to it

    lv = logits.clone().requires_grad_()
    loss = spmd.shard_map(body, mesh, (spmd.P(None, None, "model"),
                                       spmd.P()), spmd.P("model"))(lv, labels)
    got = torch.autograd.grad(loss.full().sum(), lv)[0]
    assert seen == [False] * N
    lw = logits.clone().requires_grad_()
    want_loss = L.softmax_cross_entropy(lw, labels)
    want = torch.autograd.grad(want_loss, lw)[0]
    assert abs(float(loss.full().sum().detach())
               - float(want_loss.detach())) <= 1e-6
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_backward_runs_on_each_shards_thread_with_detached_posts():
    """Inside a training body autograd's multithreaded backward is off,
    every collective (the forward's and the adjoints' in the backward)
    is made from its own shard's worker thread, and no posted tensor
    carries autograd history."""
    cfg = tconfigs.get_smoke_config("llama4_scout_17b_a16e")
    model = tbuild_smoke(cfg, moe_mode="ep", remat="dots", loss_chunk=16)
    _, placed = _states(model, _tmesh(1, 2))
    exchange, calls = spmd._exchange, []
    from repro_torch.train import train_step as TS
    shard_grads = TS._shard_grads

    def counting(t):
        posted = exchange(t)
        calls.append((threading.current_thread().name,
                      spmd._ctx().index,
                      all(p.t.grad_fn is None and not p.t.requires_grad
                          for p in posted),
                      torch.is_grad_enabled()))
        return posted

    modes = []

    def grads(*a, **k):
        modes.append(torch._C._is_multithreading_enabled())
        return shard_grads(*a, **k)

    spmd._exchange, TS._shard_grads = counting, grads
    try:
        make_mesh_grad_fn(model)(placed.params, _batch(cfg))
    finally:
        spmd._exchange, TS._shard_grads = exchange, shard_grads
    assert modes == [False, False]
    assert all(name == f"shard{i}" for name, i, _, _ in calls)
    assert all(detached for _, _, detached, _ in calls)
    # the adjoints ran too: collectives made in the backward (grad off)
    assert any(not grad for *_, grad in calls)


# ---------------------------------------------------------------------------
# the plumbing: placement, checkpoints, the driver
# ---------------------------------------------------------------------------

def test_placed_state_checkpoint_restores_on_any_mesh(tmp_path):
    """A state trained a step on (1, 2), saved, restores on (1, 4) (each
    leaf by ``opt_specs(zero=False)``, each shard a tensor of its own)
    and on one device, every leaf bit for bit; the moments and master
    lie as their parameters, and a step from the restored (1, 4) state
    equals one from the (1, 2) state. A ZeRO-1 state with residuals
    trained a compressed step on (2, 2, 2) restores onto (1, 2) and onto
    (2, 2, 2) bit for bit, and steps on from the latter as it would
    have."""
    cfg = tconfigs.get_smoke_config("llama4_scout_17b_a16e")
    model = tbuild_smoke(cfg)
    _, placed = _states(model, _tmesh(1, 2))
    step = make_train_step(model, TrainConfig(opt=OPT))
    placed, _ = step(placed, _batch(cfg))
    ck = Checkpointer(str(tmp_path), keep=1, async_save=False)
    ck.save(1, placed, block=True)
    abstract = abstract_train_state(model)
    mesh4 = _tmesh(1, 4)
    on4 = ck.restore(1, abstract, shardings=TLM.opt_specs(
        abstract, model.axes(), mesh4, zero=False))
    one = ck.restore(1, abstract, CPU)
    for got in (on4, one):
        _assert_states_close(got, placed)
        for (k, a), (_, b) in zip(_full(got.params), _full(placed.params)):
            assert torch.equal(a, b), k
    for (k, p), (_, m) in zip(tree_flatten(on4.params),
                              tree_flatten(on4.opt.m)):
        assert p.mesh is mesh4 and tuple(p.spec) == tuple(m.spec), k
        assert not spmd.shares(p)
    batch = _batch(cfg, seed=1)
    on4, m4 = step(on4, batch)
    placed, m2 = step(placed, batch)
    assert abs(float(m4["loss"]) - float(m2["loss"])) <= \
        LOSS_TOL * float(m2["loss"])
    _assert_states_close(on4, placed)
    # a ZeRO-1 state with residuals, stepped compressed on (2, 2, 2),
    # restores onto (1, 2) (no pod axis: the residuals' leading dim
    # replicated) and back onto (2, 2, 2), every leaf bit for bit
    mesh8 = spmd.Mesh([CPU] * 8, (2, 2, 2), ("pod", "data", "model"))
    zstate = init_train_state(model, torch.Generator().manual_seed(0), CPU,
                              mesh=mesh8, zero=True, ef_pods=2)
    zstep = make_train_step(model, TrainConfig(opt=OPT,
                                               compress_pod_grads=True))
    zstate, _ = zstep(zstate, _batch(cfg))
    ck.save(2, zstate, block=True)
    abstract = abstract_train_state(model, ef_pods=2)
    for mesh, zero in ((_tmesh(1, 2), False), (mesh8, True)):
        got = ck.restore(2, abstract, shardings=TLM.opt_specs(
            abstract, model.axes(), mesh, zero=zero))
        for part in ("params", "m", "v", "master", "ef"):
            g = got.params if part == "params" else (
                got.ef if part == "ef" else getattr(got.opt, part))
            w = zstate.params if part == "params" else (
                zstate.ef if part == "ef" else getattr(zstate.opt, part))
            for (k, a), (_, b) in zip(_full(g), _full(w), strict=True):
                assert torch.equal(a, b), (part, k)
        assert all(x.mesh is mesh for x in _leaves(got.ef))
    again, _ = zstep(got, _batch(cfg, seed=1))
    zstate, _ = zstep(zstate, _batch(cfg, seed=1))
    _assert_states_close(again, zstate)


def test_each_shard_holds_its_share_of_the_state():
    """yi-9b's smoke state on (1, 4): a shard holds a quarter of the
    split leaves and all of the replicated ones (the norms), for the
    weights, moments and master alike."""
    model = tbuild_smoke(tconfigs.get_smoke_config("yi_9b"))
    one, placed = _states(model, _tmesh(1, 4))
    for part in ("m", "v", "master"):
        for (k, a), (_, p) in zip(tree_flatten(getattr(placed.opt, part)),
                                  tree_flatten(placed.params)):
            assert tuple(a.spec) == tuple(p.spec) and a.shape == p.shape, k
            assert a.dtype == torch.float32
    for (k, w), (_, p) in zip(tree_flatten(one.params),
                              tree_flatten(placed.params)):
        share = w.numel() // (4 if any(p.spec) else 1)
        assert all(t.numel() == share for t in p.shards), k
    assert tuple(placed.params["embed"].spec) == ("model",)
    assert tuple(placed.params["layers"]["norm1"].spec) == ()


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-large-v3"])
def test_train_main_trains_rglru_and_whisper_on_a_production_mesh(arch,
                                                                  capsys):
    """``launch.train --production-mesh --device cpu`` for the RG-LRU
    stack and the encoder-decoder (zero frames, as the JAX driver feeds):
    finite losses, the state placed over two CPU shards."""
    state = ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--production-mesh", "--seq-len", "32",
                         "--log-every", "1", "--steps", "2"])
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "nan" not in out
    leaf = state.params["embed"]
    assert isinstance(leaf, spmd.Sharded) and leaf.mesh.shape == {
        "data": 1, "model": 2}


@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "whisper_large_v3"])
def test_elastic_driver_shrinks_rglru_and_whisper(arch, tmp_path):
    """``launch.elastic_train.run_elastic`` for the RG-LRU stack and the
    encoder-decoder: 4 data-parallel shards, 2 of them fail at step 2,
    the run restores and finishes on 2; the losses equal an uninterrupted
    2-shard run's at ``test_torch_train_driver.py``'s rtol 1e-4."""
    from repro_torch.launch.elastic_train import run_elastic
    losses, worlds = run_elastic(arch, steps=4, fail_at=2,
                                 ckpt_dir=str(tmp_path / "a"),
                                 devices=[CPU] * 4)
    assert worlds == [4, 4, 2, 2], worlds
    want, _ = run_elastic(arch, steps=4, fail_at=4,
                          ckpt_dir=str(tmp_path / "b"), devices=[CPU] * 2)
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_train_main_on_a_production_mesh_of_cpu_shards(capsys, tmp_path):
    """``launch.train --production-mesh --device cpu`` trains over two CPU
    shards and resumes from its checkpoint onto the mesh; the state is
    placed."""
    args = ["--arch", "yi-9b", "--smoke", "--device", "cpu",
            "--production-mesh", "--seq-len", "32", "--log-every", "1",
            "--checkpoint-dir", str(tmp_path)]
    state = ttrain.main(args + ["--steps", "4"])
    leaf = state.params["embed"]
    assert isinstance(leaf, spmd.Sharded) and leaf.mesh.shape == {
        "data": 1, "model": 2}
    state = ttrain.main(args + ["--steps", "5"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step     5 loss=" in out
    assert int(state.opt.step.full()) == 5


def test_what_does_not_train_on_a_mesh_says_so():
    """A multi-pod mesh over an odd number of cards, and the compressed
    cross-pod step on a placed state over a mesh without a ``pod`` axis,
    raise with what they need."""
    with pytest.raises(ValueError, match="even"):
        TLM.make_production_mesh(multi_pod=True, devices=[CPU] * 3)
    model = tbuild_smoke(tconfigs.get_smoke_config("yi_9b"))
    _, placed = _states(model, _tmesh(1, 2))
    with pytest.raises(ValueError, match="pod axis"):
        make_train_step(model, TrainConfig(opt=OPT, compress_pod_grads=True))(
            placed, _batch(model.cfg))


def test_train_main_on_a_multi_pod_mesh_of_cpu_shards(capsys):
    """``launch.train --production-mesh --multi-pod --device cpu`` trains
    over ``("pod", "data", "model") = (2, 1, 2)`` CPU shards, data-parallel
    over ``pod``, uncompressed as the JAX driver: finite losses."""
    state = ttrain.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                         "--production-mesh", "--multi-pod", "--seq-len",
                         "32", "--log-every", "1", "--steps", "2"])
    out = capsys.readouterr().out
    assert "step     2 loss=" in out and "nan" not in out
    assert state.params["embed"].mesh.shape == {"pod": 2, "data": 1,
                                                "model": 2}
    assert state.ef is None


def test_a_state_whose_shards_share_tensors_is_refused():
    """``place_train_state`` gives every shard tensors of its own; a leaf
    placed as for serving (a replicated leaf shared by the shards on one
    device) would be updated once a shard, and the step refuses it."""
    model = tbuild_smoke(tconfigs.get_smoke_config("yi_9b"))
    one = init_train_state(model, torch.Generator().manual_seed(0), CPU)
    mesh = _tmesh(1, 2)
    state = TLM.place_train_state(one, model.axes(), mesh)
    assert not any(spmd.shares(x) for _, x in tree_flatten(state.params))
    spec = TLM.param_specs(one.params, model.axes(), mesh)["final_norm"]
    state.params["final_norm"] = spmd.place(
        {"x": one.params["final_norm"]}, {"x": spec})["x"]
    assert spmd.shares(state.params["final_norm"])
    with pytest.raises(ValueError, match="share"):
        make_train_step(model, TrainConfig(opt=OPT))(state,
                                                     _batch(model.cfg))


def test_placed_state_from_jax_holds_jaxs_values():
    """``train_state_placed_from_jax`` places every leaf of a JAX state
    by its parameter's spec, the values JAX's."""
    cfg = jget_smoke("olmoe_1b_7b")
    jstate = jax.tree.map(np.asarray, jinit_train_state(jbuild_smoke(cfg),
                                                        KEY))
    tm = tbuild_smoke(tconfigs.get_smoke_config("olmoe_1b_7b"))
    placed = train_state_placed_from_jax(jstate, tm, _tmesh(1, 2))
    want = train_state_from_jax(jstate)
    for part in ("params", "m", "v", "master"):
        g = placed.params if part == "params" else getattr(placed.opt, part)
        w = want.params if part == "params" else getattr(want.opt, part)
        for (k, a), (_, b) in zip(_full(g), tree_flatten(w)):
            np.testing.assert_array_equal(to_numpy(a), to_numpy(b),
                                          err_msg=f"{part} {k}")
