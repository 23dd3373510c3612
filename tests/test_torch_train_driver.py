"""The port's training drivers on the CPU: checkpoint restart
(``test_train_checkpoint``'s cases), ``launch.train`` fresh and resumed,
``runtime_allreduce`` over the message engine, the data-parallel and
compressed steps over a single-controller mesh, and ``run_elastic``
shrinking a CPU mesh (``test_elastic_train``'s case).

The JAX drivers' own end-to-end tests (``test_train_driver_end_to_end``,
``test_compressed_training_tracks_exact``) fail on this tree, so the
drivers are held to their oracles: an uninterrupted run, the stacked
compression, a single-device step.
"""
import copy
import os

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint.checkpointer as jckpt_mod
from repro.train import AdamWState as JAdamWState
from repro.train import TrainState as JTrainState
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import _flatten, _key_of
from repro_torch.configs import get_smoke_config
from repro_torch.core import RuntimeConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.distributed import Cluster, CollectiveGroup, spmd
from repro_torch.launch import train as ltrain
from repro_torch.launch.elastic_train import run_elastic
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import build_smoke
from repro_torch.models.sharding import use_sharding
from repro_torch.train import (AdamWConfig, TrainConfig, abstract_train_state,
                               adamw_update, init_train_state, make_grad_fn,
                               make_train_step, runtime_allreduce)
from repro_torch.train.compression import compressed_mean_stacked_tree
from repro_torch.train.optimizer import (AdamWState, TrainState,
                                         tree_flatten, tree_map)

CPU = torch.device("cpu")


def _setup(arch="yi_9b", od=1, **tkw):
    cfg = get_smoke_config(arch)
    m = build_smoke(cfg)
    state = init_train_state(m, torch.Generator().manual_seed(0), CPU,
                             ef_pods=tkw.pop("ef_pods", 0))
    opt = AdamWConfig(lr_peak=2e-3, warmup_steps=5, total_steps=500,
                      weight_decay=0.0)
    step = make_train_step(m, TrainConfig(opt=opt, over_decompose=od, **tkw))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8, seed=3))
    return m, state, step, data


def _tb(data, i):
    return {k: torch.from_numpy(v) for k, v in data.batch(i).items()}


def _equal_trees(a, b):
    for (k, x), (_, y) in zip(tree_flatten(a), tree_flatten(b),
                              strict=True):
        assert torch.equal(x, y), k


# ---------------------------------------------------------------------------
# checkpointing a TrainState
# ---------------------------------------------------------------------------

def test_train_state_keys_are_the_jax_packages():
    """A ``TrainState`` flattens to the JAX ``TrainState``'s checkpoint
    keys (``params__w``, ``opt__step``, ``opt__m__w``, ...), and the
    meta-device ``abstract_train_state`` has the real state's shapes and
    dtypes."""
    w = np.ones((2, 3), np.float32)
    jstate = JTrainState(params={"w": w}, opt=JAdamWState(
        step=np.int32(0), m={"w": w}, v={"w": w}, master={"w": w}))
    tstate = TrainState(params={"w": w}, opt=AdamWState(
        step=np.int32(0), m={"w": w}, v={"w": w}, master={"w": w}))
    want = [jckpt_mod._key_of(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert [_key_of(p) for p, _ in _flatten(tstate)] == want
    m, state, _, _ = _setup()
    abstract = abstract_train_state(m)
    real = dict((_key_of(p), v) for p, v in _flatten(state))
    for p, v in _flatten(abstract):
        assert v.device.type == "meta"
        assert v.shape == real[_key_of(p)].shape
        assert v.dtype == real[_key_of(p)].dtype


def test_checkpoint_restart_bitexact(tmp_path):
    """Kill-and-restore: training resumed from the step-3 checkpoint
    (restored into ``abstract_train_state``) matches uninterrupted
    training bit for bit — parameters, moments, master and step."""
    m, state, step, data = _setup()
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    s = state
    for i in range(3):
        s, _ = step(s, _tb(data, i))
    ck.save(3, s, block=True)
    s_cont = s
    for i in range(3, 6):
        s_cont, _ = step(s_cont, _tb(data, i))
    s_rest = ck.restore(3, abstract_train_state(m), CPU)
    assert int(s_rest.opt.step) == 3
    for i in range(3, 6):
        s_rest, _ = step(s_rest, _tb(data, i))
    _equal_trees(s_cont.params, s_rest.params)
    for name in ("m", "v", "master"):
        _equal_trees(getattr(s_cont.opt, name), getattr(s_rest.opt, name))
    assert int(s_rest.opt.step) == 6


def test_checkpoint_rotation_and_torn_write(tmp_path):
    m, state, step, data = _setup()
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s_id in (1, 2, 3):
        ck.save(s_id, state, block=True)
    assert ck.all_steps() == [2, 3]
    os.makedirs(tmp_path / "step_9")          # torn: no COMMIT
    assert ck.latest_step() == 3
    back = ck.restore_latest(abstract_train_state(m), CPU)
    _equal_trees(back.params, state.params)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

def test_train_driver_runs_and_resumes(tmp_path, capsys):
    """``launch.train.main`` on the CPU: 12 steps with checkpoints at 6 and
    12, then a resume to 18 from the latest committed step."""
    args = ["--arch", "yi-9b", "--smoke", "--device", "cpu", "--steps",
            "12", "--global-batch", "4", "--seq-len", "32", "--ckpt-every",
            "6", "--checkpoint-dir", str(tmp_path), "--log-every", "6"]
    state = ltrain.main(args)
    assert int(state.opt.step) == 12
    assert Checkpointer(str(tmp_path)).all_steps() == [6, 12]
    state2 = ltrain.main(args[:6] + ["18"] + args[7:])
    assert int(state2.opt.step) == 18
    out = capsys.readouterr().out
    assert "resumed from step 12" in out and "tok/s" in out
    assert all(bool(torch.isfinite(v).all())
               for _, v in tree_flatten(state2.params))


def test_train_driver_refuses_what_it_does_not_run():
    """A batch that does not split into the asked microbatches raises.
    (The multi-pod mesh, refused until it was ported, trains:
    ``test_torch_mesh_train.py``.) RG-LRU and the encoder-decoder, which
    it refused on the production mesh until they trained tensor-parallel,
    now take a step there, their state placed."""
    with pytest.raises(ValueError, match="microbatches"):
        ltrain.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                     "--production-mesh", "--multi-pod", "--steps", "1",
                     "--seq-len", "32", "--over-decompose", "3"])
    for arch in ("recurrentgemma-9b", "whisper-large-v3"):
        state = ltrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--production-mesh", "--steps", "1",
                             "--seq-len", "32"])
        assert int(state.opt.step.full()) == 1
        assert all(bool(torch.isfinite(v.full()).all())
                   for _, v in tree_flatten(state.params))


def test_runtime_allreduce_gradient_trees():
    """Two members' gradient trees averaged over ``CollectiveGroup``: the
    mean within 1e-6, the same bits on both, tensors back as tensors."""
    rng = np.random.default_rng(8)

    def tree(scale):
        return {"w": torch.from_numpy((scale * rng.standard_normal((8, 4))
                                       ).astype(np.float32)),
                "b": {"x": (scale * rng.standard_normal(4)
                            ).astype(np.float32)}}
    cfg = RuntimeConfig(device="cpu", cpu_devices=2,
                        memory_capacity=1 << 26)
    with Cluster(2, cfg) as c:
        trees = [tree(s) for s in (1.0, 2.0)]
        outs = runtime_allreduce(CollectiveGroup(c), trees, average=True)
    want_w = (trees[0]["w"].numpy() + trees[1]["w"].numpy()) / 2
    want_b = (trees[0]["b"]["x"] + trees[1]["b"]["x"]) / 2
    for out in outs:
        assert isinstance(out["w"], torch.Tensor)
        assert isinstance(out["b"]["x"], np.ndarray)
        np.testing.assert_allclose(out["w"].numpy(), want_w, rtol=1e-6)
        np.testing.assert_allclose(out["b"]["x"], want_b, rtol=1e-6)
    assert torch.equal(outs[0]["w"], outs[1]["w"])
    np.testing.assert_array_equal(outs[0]["b"]["x"], outs[1]["b"]["x"])


def test_data_parallel_step_matches_single_device():
    """Under a 4-shard data mesh each shard takes 2 of the 8 rows and the
    gradients are averaged with ``pmean``: loss, grad norm and updated
    parameters within 1e-5 of the step on one device."""
    m, state1, step, data = _setup()
    state4 = copy.deepcopy(state1)
    batch = _tb(data, 0)
    s1, m1 = step(state1, batch)
    with use_sharding(make_smoke_mesh(4, 1, devices=[CPU] * 4)):
        s4, m4 = step(state4, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m4[k]) - float(m1[k])) <= 1e-5 * abs(float(m1[k]))
    for (k, a), (_, b) in zip(tree_flatten(s1.params),
                              tree_flatten(s4.params)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_compressed_step_equals_stacked_reduction():
    """``compress_pod_grads`` over a (pod 2) mesh: the same new parameters
    and error-feedback residuals (within 1e-6) as each pod's gradients
    taken by hand on its half of the batch, reduced by
    ``compressed_mean_stacked_tree`` and applied by ``adamw_update``."""
    m, state, step, data = _setup(compress_pod_grads=True, ef_pods=2)
    ref = copy.deepcopy(state)
    batch = _tb(data, 0)
    mesh = spmd.Mesh([CPU] * 2, (2,), ("pod",))
    with use_sharding(mesh):
        s, met = step(state, batch)
    grad_fn = make_grad_fn(m)
    per_pod = [grad_fn(ref.params, {k: v[4 * i:4 * (i + 1)]
                                    for k, v in batch.items()})
               for i in range(2)]
    stacked = tree_map(lambda a, b: torch.stack([a, b]), per_pod[0][0],
                       per_pod[1][0])
    g, new_res = compressed_mean_stacked_tree(stacked, ref.ef)
    ref, _ = adamw_update(AdamWConfig(lr_peak=2e-3, warmup_steps=5,
                                      total_steps=500, weight_decay=0.0),
                          ref, g)
    ce = (per_pod[0][1]["ce"] + per_pod[1][1]["ce"]) / 2
    assert abs(float(met["ce"]) - float(ce)) <= 1e-6
    for got, want in ((s.params, ref.params), (s.ef, new_res)):
        for (k, a), (_, b) in zip(tree_flatten(got), tree_flatten(want)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_elastic_shrink_continues_identically(tmp_path):
    """``run_elastic`` on a CPU mesh: 8 shards, 4 of them fail at step 4,
    the run restores from the checkpoint and finishes on 4; the losses
    equal an uninterrupted 4-shard run's at rtol 1e-4 (the world size
    changes only the order of the float32 sums)."""
    losses_el, worlds = run_elastic(steps=8, fail_at=4,
                                    ckpt_dir=str(tmp_path / "a"),
                                    devices=[CPU] * 8)
    assert worlds == [8] * 4 + [4] * 4, worlds
    losses_ref, ref_worlds = run_elastic(steps=8, fail_at=8,
                                         ckpt_dir=str(tmp_path / "b"),
                                         devices=[CPU] * 4)
    assert ref_worlds == [4] * 8
    np.testing.assert_allclose(losses_el, losses_ref, rtol=1e-4)


def test_train_state_crosses_from_jax_and_back():
    """``train_state_from_jax`` of a JAX ``TrainState`` (numpy leaves): the
    step a 0-d int32 tensor (``to_torch`` keeps a 0-d array 0-d), every
    leaf's values and dtype; ``train_state_to_numpy`` gives them back."""
    from repro.configs import get_smoke_config as jget_smoke
    from repro.models import build_smoke as jbuild_smoke
    from repro.train import init_train_state as jinit_train_state
    from repro_torch.convert import (lm_from_jax, to_torch,
                                     train_state_from_jax,
                                     train_state_to_numpy)
    assert to_torch(np.float32(2.5)).shape == ()
    jstate = jax.tree.map(np.asarray, jinit_train_state(
        jbuild_smoke(jget_smoke("yi_9b")), jax.random.PRNGKey(0), ef_pods=2))
    t = train_state_from_jax(jstate)
    assert t.opt.step.shape == () and t.opt.step.dtype == torch.int32
    back = train_state_to_numpy(t)
    want = tree_map(lambda p: p.detach().numpy(),
                    lm_from_jax(jstate.opt.master).tree())
    for (k, a), (_, b) in zip(tree_flatten(back.opt.master),
                              tree_flatten(want)):
        np.testing.assert_array_equal(a, b)
    assert all(v.shape[0] == 2 for _, v in tree_flatten(t.ef))
