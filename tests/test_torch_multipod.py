"""The multi-pod mesh in the port (``("pod", "data", "model")``): ZeRO-1
over ``data`` (``init_train_state(..., zero=True)``,
``place_train_state(zero=True)``) and the int8 error-feedback reduction
over ``pod`` on a placed state (``TrainConfig(compress_pod_grads=True)``,
``train.compression.compressed_pmean`` on a shard's slice of a leaf), on
meshes of CPU shards at the smoke configurations (float32).

Held to the JAX package's compressed step jitted under ``use_sharding`` of
an Auto ``jax.sharding.Mesh``: (2, 2, 2) over eight host devices in one
child process for the whole file (the suite's process has two), and (2,
1, 1) over the suite's two in-process; the loss within relative 1e-5,
the gradient norm within relative 1e-4 and the state after the step
(parameters, moments, master, residuals) within 1e-5 absolute,
``test_torch_mesh_train.py``'s tolerances. One allowance: an element
whose quantization is a tie within float32 noise (its scaled value half
a step from two integers) may round the other way in the two packages,
whose in-pod gradients differ in their last bits (MKL's and XLA's sums
even differ from one process to the next). There the two residuals are
each other's negatives, half a step off zero, and that parameter element
is left out of the comparison; such ties are at most 1 in 10^4 of the
residuals' elements. The ZeRO-1 step equals the unsplit step bit for bit,
and a leaf split mid-block quantizes as JAX's whole leaf does.
"""
import os
import subprocess
import sys
import textwrap

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
from repro.train.compression import \
    compressed_mean_stacked as jcompressed_mean_stacked
from repro_torch import configs as tconfigs
from repro_torch.convert import (to_numpy, to_torch, train_state_from_jax,
                                 train_state_placed_from_jax)
from repro_torch.distributed import spmd
from repro_torch.launch import mesh as TLM
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train import compression as TC
from repro_torch.train.optimizer import tree_flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_torch_mesh_train.py's tolerances
LOSS_TOL = 1e-5        # ce + aux, relative
GRAD_TOL = 1e-4        # the gradient norm, relative
MOMENT_TOL = 1e-5      # the state after one step, absolute
# the share of residual elements whose quantization may be a tie that the
# two packages break apart (module docstring)
TIE_SHARE = 1e-4
CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(0)
AXES = ("pod", "data", "model")
PARTS = ("params", "m", "v", "master", "ef")


def _tmesh(shape):
    return spmd.Mesh([CPU] * int(np.prod(shape)), shape, AXES)


def _jax_batch(cfg):
    return JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=8, seed=3)).batch(0)


def _jstate(arch, pods):
    return jinit_train_state(jbuild_smoke(jget_smoke(arch)), KEY,
                             ef_pods=pods)


def _value(x):
    return x.full() if isinstance(x, spmd.Sharded) else x


def _leaves(tree):
    return [x for _, x in tree_flatten(tree)]


def _part(state, part):
    if part == "params":
        return state.params
    return state.ef if part == "ef" else getattr(state.opt, part)


# one child process for the file: JAX's compressed step on an Auto
# (2, 2, 2) mesh of eight host devices, its new state and metrics saved
_CHILD = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.data import DataConfig, SyntheticLM
from repro.models import build_smoke
from repro.models.sharding import use_sharding
from repro.train import TrainConfig, init_train_state, make_train_step
out = {}
for arch in sys.argv[2:]:
    cfg = get_smoke_config(arch)
    m = build_smoke(cfg)
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2),
                ("pod", "data", "model"))
    state = init_train_state(m, jax.random.PRNGKey(0), ef_pods=2)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=8, seed=3)).batch(0)
    with use_sharding(mesh):
        new, met = jax.jit(make_train_step(
            m, TrainConfig(compress_pod_grads=True)))(
                state, {k: jnp.asarray(v) for k, v in batch.items()})
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray,
                                                             new))[0]
    for path, leaf in flat:
        out[arch + "/s" + jax.tree_util.keystr(path)] = leaf
    for k, v in met.items():
        out[arch + "/m/" + k] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""
CHILD_ARCHS = ("yi_9b",)


@pytest.fixture(scope="module")
def jax_222(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax222") / "steps.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_CHILD),
                          path, *CHILD_ARCHS], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(path))


def _from_saved(saved, arch, pods):
    """JAX's new state and metrics for ``arch`` from the child's file, in
    the structure of the same state made here."""
    tree = jax.tree.map(np.asarray, _jstate(arch, pods))
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    new = jax.tree_util.tree_unflatten(treedef, [
        saved[arch + "/s" + jax.tree_util.keystr(p)] for p, _ in flat])
    metrics = {k.split("/")[-1]: v for k, v in saved.items()
               if k.startswith(arch + "/m/")}
    return new, metrics


def _port_step(arch, shape, zero=True):
    """The port's compressed step on a ``shape`` mesh of CPU shards from
    JAX's initial state and batch."""
    cfg = jget_smoke(arch)
    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    placed = train_state_placed_from_jax(
        jax.tree.map(np.asarray, _jstate(arch, shape[0])), tm,
        _tmesh(shape), zero=zero)
    return make_train_step(tm, TrainConfig(compress_pod_grads=True))(
        placed, {k: torch.from_numpy(v)
                 for k, v in _jax_batch(cfg).items()})


def _ties(got_ef, want_ef):
    """The parameter elements where the two packages rounded a tie apart
    (module docstring): per leaf, a mask of the parameter's shape."""
    masks, ties, total = {}, 0, 0
    for (k, a), (_, b) in zip(tree_flatten(got_ef), tree_flatten(want_ef),
                              strict=True):
        a = _value(a)
        off = (a - b).abs() > MOMENT_TOL
        assert bool(((a + b).abs()[off] <= MOMENT_TOL).all()), \
            (k, a[off][:4], b[off][:4])
        ties += int(off.sum())
        total += off.numel()
        masks[k] = off.any(dim=0)
    assert ties <= TIE_SHARE * total, (ties, total)
    return masks


def _assert_matches_jax(got, metrics, jnew, jmet):
    assert abs(float(metrics["loss"]) - float(jmet["loss"])) <= \
        LOSS_TOL * float(jmet["loss"])
    assert abs(float(metrics["grad_norm"]) - float(jmet["grad_norm"])) <= \
        GRAD_TOL * float(jmet["grad_norm"])
    want = train_state_from_jax(jnew)
    masks = _ties(got.ef, want.ef)
    for part in PARTS:
        for (k, a), (_, b) in zip(tree_flatten(_part(got, part)),
                                  tree_flatten(_part(want, part)),
                                  strict=True):
            keep = ~masks[k]
            a = _value(a)
            if part == "ef":
                keep = keep.expand_as(a)
            torch.testing.assert_close(a[keep], b[keep], rtol=0,
                                       atol=MOMENT_TOL, msg=f"{part} {k}")
    assert int(_value(got.opt.step)) == int(want.opt.step)


# ---------------------------------------------------------------------------
# the compressed ZeRO-1 step against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", CHILD_ARCHS)
def test_compressed_zero1_step_on_2x2x2_equals_jax(arch, jax_222):
    """(a) One step of the port on a (2, 2, 2) mesh of CPU shards,
    compressed over ``pod`` and ZeRO-1 over ``data``, from JAX's state
    and ``SyntheticLM`` batch, against JAX's jitted compressed step on an
    Auto (2, 2, 2) JAX mesh of eight host devices (the child process):
    loss, gradient norm, parameters, moments, master and residuals."""
    got, metrics = _port_step(arch, (2, 2, 2))
    assert any(tuple(m.spec) != tuple(p.spec) for m, p in zip(
        _leaves(got.opt.m), _leaves(got.params)))
    _assert_matches_jax(got, metrics, *_from_saved(jax_222, arch, 2))


@pytest.mark.parametrize("arch", ["yi_9b", "mamba2_370m",
                                  "recurrentgemma_9b"])
def test_compressed_step_on_2x1x1_equals_jax(arch):
    """(b) The same on a (2, 1, 1) mesh against JAX's step on an Auto
    (2, 1, 1) mesh of the suite's two host devices, in this process."""
    cfg = jget_smoke(arch)
    jm = jbuild_smoke(cfg)
    jmesh = JMesh(np.array(jax.devices()[:2]).reshape(2, 1, 1), AXES)
    with JS.use_sharding(jmesh):
        jnew, jmet = jax.jit(jmake_train_step(
            jm, JTrainConfig(compress_pod_grads=True)))(
                _jstate(arch, 2), {k: jnp.asarray(v)
                                   for k, v in _jax_batch(cfg).items()})
    got, metrics = _port_step(arch, (2, 1, 1))
    _assert_matches_jax(got, metrics, jax.tree.map(np.asarray, jnew),
                        jmet)


# ---------------------------------------------------------------------------
# ZeRO-1 against the unsplit step, and what a shard holds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi_9b", "olmoe_1b_7b",
                                  "recurrentgemma_9b"])
def test_zero1_step_equals_unsplit_step_bit_for_bit(arch):
    """(c) On a (1, 2, 2) mesh the ZeRO-1 state (the moments and master
    split over ``data`` as well) and the unsplit one, drawn from one
    seed, take a step on one batch: every leaf after it (gathered) holds
    the same bits, AdamW being elementwise."""
    cfg = tconfigs.get_smoke_config(arch)
    model = tbuild_smoke(cfg)
    mesh = _tmesh((1, 2, 2))
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 32))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    step = make_train_step(model, TrainConfig())
    on, m_on = step(init_train_state(model, torch.Generator().manual_seed(0),
                                     CPU, mesh=mesh, zero=True), batch)
    off, m_off = step(init_train_state(
        model, torch.Generator().manual_seed(0), CPU, mesh=mesh), batch)
    assert float(m_on["loss"]) == float(m_off["loss"])
    assert float(m_on["grad_norm"]) == float(m_off["grad_norm"])
    split = 0
    for part in ("params", "m", "v", "master"):
        for (k, a), (_, b) in zip(tree_flatten(_part(on, part)),
                                  tree_flatten(_part(off, part))):
            split += part == "m" and tuple(a.spec) != tuple(b.spec)
            assert torch.equal(a.full(), b.full()), (part, k)
    assert split > 0


def test_each_shard_holds_its_zero_slice_and_residual_block():
    """(e) yi-9b's smoke state drawn onto (2, 2, 2) with ZeRO-1 and
    residuals: each shard holds its block of every parameter, its slice
    of the moments and master (the block halved over ``data`` where
    ``zero_shard`` found a dim; the master's values that slice of the
    parameter's), its pod's residual of its block, and no more."""
    model = tbuild_smoke(tconfigs.get_smoke_config("yi_9b"))
    mesh = _tmesh((2, 2, 2))
    state = init_train_state(model, torch.Generator().manual_seed(0), CPU,
                             mesh=mesh, zero=True, ef_pods=2)
    specs = TLM.opt_specs(state, model.axes(), mesh, zero=True)
    for (k, p), (_, w), (_, r), (_, zs) in zip(
            tree_flatten(state.params), tree_flatten(state.opt.master),
            tree_flatten(state.ef), tree_flatten(specs.opt.master),
            strict=True):
        assert tuple(w.spec) == tuple(zs.spec), k
        assert tuple(r.spec) == ("pod", *p.spec), k
        assert r.shape == (2,) + p.shape and r.dtype == torch.float32
        block = spmd.NamedSharding(mesh, p.spec).shard_shape(p.shape)
        zblock = zs.shard_shape(w.shape)
        assert any("data" in spmd._axes(e) for e in w.spec), k
        assert np.prod(zblock) * 2 == np.prod(block), k
        for i in range(mesh.size):
            assert tuple(p.shards[i].shape) == block
            assert tuple(w.shards[i].shape) == zblock
            assert tuple(r.shards[i].shape) == (1,) + block
            region = spmd._blocks(mesh, zs.spec, i, w.shape)
            assert torch.equal(w.shards[i], p.full()[region].float()), k
    for part in ("m", "v"):
        for (k, x), (_, zs) in zip(tree_flatten(getattr(state.opt, part)),
                                   tree_flatten(getattr(specs.opt, part))):
            assert all(tuple(t.shape) == zs.shard_shape(x.shape)
                       for t in x.shards), k


# ---------------------------------------------------------------------------
# quantization of a leaf split mid-block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,model", [((4, 11008), 2), ((3, 64, 128), 2),
                                         ((3, 64, 128), 4)],
                         ids=["yi-wi-rows", "smoke-dff-2", "smoke-dff-4"])
def test_compressed_pmean_of_a_leaf_split_mid_block_equals_jax(shape,
                                                                 model):
    """(d) ``compressed_pmean`` over ``pod`` = 2 of a leaf whose last axis
    the model axis splits off the 256-blocks (yi-9b's MLP width, 11008 =
    43 blocks, over 2: block 21 straddles; the smoke ``d_ff`` 128, one
    block, over 2 and 4), each shard with its slice of a residual: the
    mean on every shard and each shard's new residual equal JAX's
    ``compressed_mean_stacked`` on the whole leaf within 1e-6."""
    rng = np.random.default_rng(7)
    x = (3.0 * rng.standard_normal((2,) + shape)).astype(np.float32)
    r = (0.01 * rng.standard_normal((2,) + shape)).astype(np.float32)
    jm, jr = jcompressed_mean_stacked(jnp.asarray(x), jnp.asarray(r))
    mesh = spmd.Mesh([CPU] * (2 * model), (2, model), ("pod", "model"))
    lead = (None,) * (len(shape) - 1)
    spec = spmd.P("pod", *lead, "model")

    def body(xs, rs):
        mean, new = TC.compressed_pmean(xs[0], "pod", rs[0],
                                        split=("model",))
        return mean[None], new[None]
    means, news = spmd.shard_map(body, mesh, (spec, spec), (spec, spec))(
        to_torch(x), to_torch(r))
    for p in range(2):
        np.testing.assert_allclose(to_numpy(means.full()[p]),
                                   np.asarray(jm), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_numpy(news.full()), np.asarray(jr),
                               rtol=0, atol=1e-6)
    # shard-local blocks would give other scales
    local = TC.compressed_mean_stacked(
        to_torch(x[..., :shape[-1] // model]),
        to_torch(r[..., :shape[-1] // model]))[1]
    assert not torch.allclose(local, to_torch(np.asarray(jr))[
        ..., :shape[-1] // model], atol=1e-6)
