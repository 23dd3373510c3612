"""Parity of the port's training path (``repro_torch.train``,
``Model.loss``, the train-mode forward of every model family) with the
JAX package's, at the smoke configurations (float32, ``SMOKE_FLAGS``).

The same seeded numpy inputs and the JAX package's own weights (carried
across by ``repro_torch.convert``) go through both; gradients come from
``jax.grad`` and from ``torch.autograd``. Tolerances: the loss and hidden
states within relative 1e-5, every gradient leaf within relative L2 1e-4,
one AdamW update within 1e-6 absolute, a whole train step (od=1 and od=4)
within 1e-4 relative on the gradient norm and 1e-5 absolute on the moments,
and the over-decomposed step against the whole one within the JAX test's
bounds (ce 1e-3, parameters 5e-3).
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jget_smoke
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import build_smoke as jbuild_smoke
from repro.models import attention as JA
from repro.models.layers import unbox
from repro.models.layers import softmax_cross_entropy as jsoftmax_ce
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import adamw_update as jadamw_update
from repro.train import init_train_state as jinit_train_state
from repro.train import lr_schedule as jlr_schedule
from repro.train.train_step import make_loss_fn as jmake_loss_fn
from repro_torch import configs as tconfigs
from repro_torch.convert import (lm_from_jax, to_numpy, to_torch,
                                 train_state_from_jax, train_state_to_numpy)
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import LAUNCHES
from repro_torch.models import attention as TA
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models import layers as TL
from repro_torch.models import rglru as TR
from repro_torch.train import (AdamWConfig, TrainConfig, adamw_update,
                               init_train_state, lr_schedule, make_grad_fn,
                               make_train_step)
from repro_torch.train.optimizer import tree_flatten, tree_map

KEY = jax.random.PRNGKey(0)
LOSS_TOL = 1e-5        # ce + aux and hidden states, relative
GRAD_TOL = 1e-4        # each gradient leaf, relative L2
ADAM_TOL = 1e-6        # one AdamW update, absolute
MOMENT_TOL = 1e-5      # the moments after one whole train step, absolute


def _batch(cfg, b, s, seed=0):
    """Seeded numpy inputs of a train step (the frontends' inputs at 0.1
    scale, as ``test_arch_smoke``'s)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = (0.1 * rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = (0.1 * rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return batch


def _plain(jtree):
    """A JAX parameter-shaped tree as the port's dict of tensors."""
    return tree_map(lambda p: p.detach(),
                    lm_from_jax(jax.tree.map(np.asarray, jtree)).tree())


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# every model family: loss, hidden states and gradients against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_and_gradients_match_jax(arch):
    """The train-mode hidden states and ce + aux within relative 1e-5 of
    JAX's ``make_loss_fn`` (the MoE configurations' aux included), and
    every gradient leaf within relative L2 1e-4 of ``jax.grad``'s. No
    kernel launches."""
    cfg = jget_smoke(arch)
    jm = jbuild_smoke(cfg)
    jp, _ = unbox(jm.init(KEY))
    batch = _batch(cfg, 2, 64)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss = jax.jit(jax.value_and_grad(jmake_loss_fn(jm), has_aux=True))
    (jl, jmet), jg = jloss(jp, jbatch)
    jx = jax.jit(functools.partial(jm.apply, mode="train"))(jp, jbatch)[0]

    tm = tbuild_smoke(tconfigs.get_smoke_config(arch))
    tp = _plain(jp)
    tbatch = {k: to_torch(v) for k, v in batch.items()}
    before = dict(LAUNCHES)
    tx, cache, aux = tm.apply(tp, tbatch, mode="train")
    assert cache is None
    assert _rel(to_numpy(tx), jx) <= LOSS_TOL
    grads, met = make_grad_fn(tm)(tp, tbatch)
    assert dict(LAUNCHES) == before
    tl = float(met["ce"] + met["aux"])
    assert abs(tl - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert abs(float(met["aux"]) - float(jmet["aux"])) <= \
        LOSS_TOL * max(abs(float(jmet["aux"])), 1e-3)
    if cfg.moe is not None:
        assert float(met["aux"]) > 0
    want = dict(tree_flatten(_plain(jg)))
    got = dict(tree_flatten(grads))
    assert set(got) == set(want)
    worst = {"/".join(k): _rel(to_numpy(got[k]), to_numpy(want[k]))
             for k in want}
    assert max(worst.values()) <= GRAD_TOL, sorted(
        worst.items(), key=lambda kv: -kv[1])[:4]


def test_softmax_cross_entropy_matches_jax():
    """With and without a mask, within 1e-6."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = jsoftmax_ce(jnp.asarray(logits), jnp.asarray(labels),
                           None if m is None else jnp.asarray(m))
        got = TL.softmax_cross_entropy(to_torch(logits), to_torch(labels),
                                       None if m is None else to_torch(m))
        assert abs(float(got) - float(want)) <= 1e-6


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_remat_changes_no_gradient(remat):
    """``Flags.remat`` recomputes; the loss and gradients are the same
    bits as without it (yi-9b smoke, chunked loss of 64)."""
    cfg = tconfigs.get_smoke_config("yi_9b")
    base = tbuild_smoke(cfg)
    m = tbuild_smoke(cfg, remat=remat)
    params = init_train_state(base, torch.Generator().manual_seed(0),
                              "cpu").params
    batch = {k: to_torch(v) for k, v in _batch(cfg, 2, 128).items()}
    g0, m0 = make_grad_fn(base)(params, batch)
    g1, m1 = make_grad_fn(m)(params, batch)
    assert torch.equal(m0["ce"], m1["ce"])
    for (k, a), (_, b) in zip(tree_flatten(g0), tree_flatten(g1)):
        assert torch.equal(a, b), k


def test_chunked_loss_equals_whole_sequence():
    """``chunked_ce_loss`` over chunks of 16 equals the cross-entropy of
    the whole [B, S, V] logits within 1e-6."""
    cfg = tconfigs.get_smoke_config("yi_9b")
    m = tbuild_smoke(cfg, loss_chunk=16)
    params = init_train_state(m, torch.Generator().manual_seed(1),
                              "cpu").params
    x = torch.randn(2, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    labels = torch.randint(0, cfg.vocab, (2, 64))
    want = TL.softmax_cross_entropy(m.unembed(params, x), labels)
    assert abs(float(m.loss(params, x, labels)) - float(want)) <= 1e-6


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _jstate_and_grads(seed):
    cfg = jget_smoke("yi_9b")
    jm = jbuild_smoke(cfg)
    state = jinit_train_state(jm, KEY)
    rng = np.random.default_rng(seed)

    def grads(scale):
        return jax.tree.map(lambda p: jnp.asarray(
            scale * rng.standard_normal(p.shape).astype(np.float32)),
            state.params)
    return state, grads


def _close_state(got, want, tol):
    got = train_state_to_numpy(got)
    want = train_state_to_numpy(train_state_from_jax(
        jax.tree.map(np.asarray, want)))
    assert int(got.opt.step) == int(want.opt.step)
    for name in ("params", "m", "v", "master"):
        g = got.params if name == "params" else getattr(got.opt, name)
        w = want.params if name == "params" else getattr(want.opt, name)
        for (k, a), (_, b) in zip(tree_flatten(g), tree_flatten(w)):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol,
                                       err_msg=f"{name} {k}")


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(grad_scale):
    """Two updates on identical gradients and state, one at step 1 and
    one at step 2 (moments non-zero, bias corrections apart from 1): the
    parameters, moments, master and metrics within 1e-6 of JAX's, below
    the clip and above it."""
    cfg = JAdamWConfig(lr_peak=1e-2, warmup_steps=3, total_steps=20)
    tcfg = AdamWConfig(lr_peak=1e-2, warmup_steps=3, total_steps=20)
    jstate, grads = _jstate_and_grads(4)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    for _ in range(2):
        g = grads(grad_scale)
        jstate, jmet = jax.jit(functools.partial(jadamw_update, cfg))(
            jstate, g)
        tstate, tmet = adamw_update(tcfg, tstate, _plain(g))
        _close_state(tstate, jstate, ADAM_TOL)
        for k in ("grad_norm", "lr"):
            assert abs(float(tmet[k]) - float(jmet[k])) <= \
                ADAM_TOL * max(1.0, abs(float(jmet[k])))


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 10000, 12000])
def test_lr_schedule_matches_jax(step):
    """Warmup, peak, the cosine and past the end, within 1e-9."""
    cfg = JAdamWConfig(lr_peak=3e-4, warmup_steps=100, total_steps=10000)
    want = float(jlr_schedule(cfg, jnp.asarray(step, jnp.int32)))
    got = float(lr_schedule(AdamWConfig(lr_peak=3e-4, warmup_steps=100,
                                        total_steps=10000),
                            torch.tensor(step, dtype=torch.int32)))
    assert abs(got - want) <= 1e-9


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _setup(arch="yi_9b", od=1):
    cfg = tconfigs.get_smoke_config(arch)
    m = tbuild_smoke(cfg)
    state = init_train_state(m, torch.Generator().manual_seed(0), "cpu")
    opt = AdamWConfig(lr_peak=2e-3, warmup_steps=5, total_steps=500,
                      weight_decay=0.0)
    step = make_train_step(m, TrainConfig(opt=opt, over_decompose=od))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8, seed=3))
    return m, state, step, data


def _tb(data, i):
    return {k: torch.from_numpy(v) for k, v in data.batch(i).items()}


def test_loss_decreases_over_steps():
    m, state, step, data = _setup()
    losses = []
    for i in range(30):
        state, metrics = step(state, _tb(data, i))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
    assert int(state.opt.step) == 30


@pytest.mark.parametrize("arch", ["yi_9b", "olmoe_1b_7b"])
def test_over_decomposition_matches_monolithic(arch):
    """od=4 microbatching gives (nearly) the same update as od=1, with the
    JAX test's bounds: ce within 1e-3, every parameter within 5e-3."""
    m, state1, step1, data = _setup(arch, od=1)
    _, _, step4, _ = _setup(arch, od=4)
    state4 = copy.deepcopy(state1)
    batch = _tb(data, 0)
    s1, m1 = step1(state1, batch)
    s4, m4 = step4(state4, batch)
    assert abs(float(m1["ce"]) - float(m4["ce"])) < 1e-3
    deltas = [float((a - b).abs().max()) for (_, a), (_, b) in
              zip(tree_flatten(s1.params), tree_flatten(s4.params))]
    assert max(deltas) < 5e-3


def _step_against_jax(od):
    """One whole step of the port against one of the JAX package at
    ``over_decompose=od``, from the same state and batch: the loss within
    1e-5 relative, the gradient norm within 1e-4 relative, and the updated
    first and second moments within 1e-5 absolute (the clipped gradient's
    elements are at most 1, so ``m`` is at most 0.1)."""
    from repro.train import TrainConfig as JTrainConfig
    from repro.train import make_train_step as jmake_train_step
    cfg = jget_smoke("yi_9b")
    jm = jbuild_smoke(cfg)
    jstate = jinit_train_state(jm, KEY)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, jstate))
    data = JSyntheticLM(JDataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=8, seed=3))
    batch = data.batch(0)
    jnew, jmet = jax.jit(jmake_train_step(
        jm, JTrainConfig(over_decompose=od)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tm = tbuild_smoke(tconfigs.get_smoke_config("yi_9b"))
    tnew, tmet = make_train_step(tm, TrainConfig(over_decompose=od))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= \
        LOSS_TOL * float(jmet["loss"])
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
        GRAD_TOL * float(jmet["grad_norm"])
    got = train_state_to_numpy(tnew)
    want = train_state_to_numpy(train_state_from_jax(
        jax.tree.map(np.asarray, jnew)))
    for name in ("m", "v"):
        for (k, a), (_, b) in zip(tree_flatten(getattr(got.opt, name)),
                                  tree_flatten(getattr(want.opt, name))):
            np.testing.assert_allclose(a, b, rtol=0, atol=MOMENT_TOL,
                                       err_msg=f"{name} {k}")


def test_train_step_matches_jax_step():
    """The whole-batch step (od=1) against JAX's (``_step_against_jax``)."""
    _step_against_jax(1)


def test_over_decomposed_step_matches_jax_step():
    """The step over four microbatches (od=4: the port's float32
    accumulation loop against JAX's ``lax.scan``) against JAX's
    (``_step_against_jax``). A dropped microbatch, a flipped sign or a
    missing ``/od`` moves the gradient norm or the moments far past the
    bounds."""
    _step_against_jax(4)


def test_labels_are_next_tokens():
    """The port's ``SyntheticLM`` gives JAX's batches, bit for bit, and
    its labels are the tokens shifted by one."""
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=4)
    b = SyntheticLM(cfg).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    jb = JSyntheticLM(JDataConfig(vocab=128, seq_len=16,
                                  global_batch=4)).batch(0)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b[k], jb[k])


# ---------------------------------------------------------------------------
# the differentiable forms of the plain paths
# ---------------------------------------------------------------------------

def _dense_attention(q, k, v, *, causal, kv_valid=None, window=None):
    """Reference: the whole [S, T] float32 score matrix, q [B,S,K,G,D],
    k, v [B,T,K,D]."""
    d = q.shape[-1]
    sc = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * d ** -0.5
    s, t = q.shape[1], k.shape[1]
    qi = torch.arange(s)[:, None]
    ki = torch.arange(t)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= qi - ki < window
    if kv_valid is not None:
        mask &= kv_valid[None, :]
    sc = sc.masked_fill(~mask, TA.NEG_INF)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bkgst,btkd->bskgd", p, v.float())


def _qkv(seed, s, t, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(2, s, 2, 3, 16, generator=g).to(dtype)
    k = torch.randn(2, t, 2, 16, generator=g).to(dtype)
    v = torch.randn(2, t, 2, 16, generator=g).to(dtype)
    return q, k, v


def _grads_of(fn, q, k, v, cot):
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return out, torch.autograd.grad((out.float() * cot).sum(), leaves)


@pytest.mark.parametrize("causal,masked", [(True, False), (False, False),
                                           (False, True)])
def test_blockwise_attention_gradients_match_dense(causal, masked):
    """``flash_attention`` where autograd records (its out-of-place
    tiles, blocks of 32 over 128 positions): the same bits forward as the
    in-place serving loop, and the gradients of q, k and v within 1e-5 of
    the dense float32 reference's."""
    q, k, v = _qkv(1, 128, 128)
    kv_valid = (torch.arange(128) < 100) if masked else None
    run = functools.partial(TA.flash_attention, causal=causal, q_block=32,
                            kv_block=32, kv_valid=kv_valid)
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(2))
    out, grads = _grads_of(run, q, k, v, cot)
    assert torch.equal(out.detach(), run(q, k, v))
    _, want = _grads_of(functools.partial(
        _dense_attention, causal=causal, kv_valid=kv_valid), q, k, v, cot)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [64, 60])
def test_window_attention_gradients_match_dense(s):
    """``window_attention`` where autograd records (window 16; 60: ragged,
    padded inside): the same bits forward as the serving path, gradients
    within 1e-5 of the dense banded reference."""
    q, k, v = _qkv(3, s, s)
    run = functools.partial(TA.window_attention, positions=torch.arange(s),
                            window=16)
    cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(4))
    out, grads = _grads_of(run, q, k, v, cot)
    assert torch.equal(out.detach(), run(q, k, v))
    _, want = _grads_of(functools.partial(_dense_attention, causal=True,
                                          window=16), q, k, v, cot)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)


def test_train_attention_never_takes_the_kernel():
    """With the kernel flag on, a train-mode forward never calls the
    kernel's wrapper and gives the blockwise path's hidden state; a
    prefill calls it once a layer (its plain version on a CPU tensor)."""
    cfg = tconfigs.get_smoke_config("yi_9b")
    on = tbuild_smoke(cfg, use_flash_kernel=True)
    off = tbuild_smoke(cfg)
    params = init_train_state(on, torch.Generator().manual_seed(0),
                              "cpu").params
    toks = torch.randint(0, cfg.vocab, (2, 128),
                         generator=torch.Generator().manual_seed(1))
    calls = []
    real = TA.flash_attention_gqa
    TA.flash_attention_gqa = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        x_on = on.apply(params, {"tokens": toks}, mode="train")[0]
        assert not calls
        on.apply(params, {"tokens": toks}, mode="prefill")
        assert len(calls) == cfg.n_layers
    finally:
        TA.flash_attention_gqa = real
    x_off = off.apply(params, {"tokens": toks}, mode="train")[0]
    assert torch.equal(x_on, x_off)


@pytest.mark.parametrize("s", [1, 7, 64])
def test_rglru_autograd_scan_equals_linear_scan_and_steps(s):
    """``linear_scan_autograd`` gives ``linear_scan``'s bits, both within
    1e-5 of the step-by-step recurrence h_t = a_t h_{t-1} + b_t, and its
    gradients within 1e-5 of the recurrence's."""
    g = torch.Generator().manual_seed(s)
    a = torch.rand(2, s, 8, generator=g) * 0.9 + 0.05
    b = torch.randn(2, s, 8, generator=g)
    want_h = TR.linear_scan(a.clone(), b.clone())

    def steps(a, b):
        h, out = torch.zeros_like(b[:, 0]), []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            out.append(h)
        return torch.stack(out, dim=1)

    al, bl = a.clone().requires_grad_(), b.clone().requires_grad_()
    h = TR.linear_scan_autograd(al, bl)
    assert torch.equal(h.detach(), want_h)
    torch.testing.assert_close(h.detach(), steps(a, b), rtol=1e-5,
                               atol=1e-5)
    cot = torch.randn(h.shape, generator=g)
    got = torch.autograd.grad((h * cot).sum(), (al, bl), allow_unused=True)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = torch.autograd.grad((steps(a2, b2) * cot).sum(), (a2, b2))
    for x, y in zip(got, want):
        # a_0 never reaches h (h_0 = b_0): no gradient, or zeros
        x = torch.zeros_like(y) if x is None else x
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


def test_attention_layer_train_matches_jax_gradients():
    """One global attention layer in train mode: output and the
    gradients of its four projections within 1e-5 of ``jax.grad`` of the
    JAX layer (blocks of 32 over 64 positions)."""
    rng = np.random.default_rng(5)
    params = {n: rng.standard_normal(s).astype(np.float32) * 0.2
              for n, s in (("wq", (24, 4, 8)), ("wk", (24, 2, 8)),
                           ("wv", (24, 2, 8)), ("wo", (4, 8, 24)))}
    x = rng.standard_normal((2, 64, 24)).astype(np.float32)
    cot = rng.standard_normal((2, 64, 24)).astype(np.float32)
    kw = dict(kind="global_attn", rope_theta=10000.0, n_kv_heads=2,
              mode="train")

    def jloss(p):
        y, _ = JA.attention_layer(p, jnp.asarray(x), window=0, **kw)
        return jnp.sum(y * cot)
    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: to_torch(v).requires_grad_() for k, v in params.items()}
    y, _ = TA.attention_layer(tp, to_torch(x), flash_block=32, **kw)
    got = torch.autograd.grad((y * to_torch(cot)).sum(), list(tp.values()))
    for name, g in zip(tp, got):
        assert _rel(to_numpy(g), np.asarray(jg[name])) <= 1e-5, name


def test_param_tree_gradients_reach_the_weights():
    """``ParamTree.tree()`` hands out the parameters themselves: with
    ``requires_grad_()`` a train-mode loss reaches every weight's
    ``.grad``, equal to ``make_grad_fn``'s gradients; registered without
    gradients, a forward records nothing."""
    cfg = tconfigs.get_smoke_config("yi_9b")
    m = tbuild_smoke(cfg)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    batch = {k: to_torch(v) for k, v in _batch(cfg, 2, 32).items()}
    assert not m.apply(params, batch, mode="train")[0].requires_grad
    grads, _ = make_grad_fn(m)(tree_map(lambda p: p.detach(),
                                        params.tree()), batch)
    params.requires_grad_(True)
    x, _, aux = m.apply(params, batch, mode="train")
    (m.loss(params, x, batch["labels"]) + aux).backward()
    for (k, p), (_, g) in zip(tree_flatten(params.tree()),
                              tree_flatten(grads)):
        assert torch.equal(p.grad, g), k


@pytest.mark.parametrize("path", ["dense", "ep"])
def test_moe_gradients_reach_router_and_experts(path):
    """``moe_dense``, and ``moe_ep`` over a (1, 2) CPU mesh at capacity
    E/k (no drops: its dispatch buffer written at ``buf[rows]``, the
    ``all_to_all`` exchanges and the combine): the output's gradients to
    the router, the experts and x equal the dense oracle's within 1e-5,
    and the aux loss alone has a non-zero gradient to the router."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import moe as TM
    from repro_torch.models.sharding import use_sharding
    cfg = tconfigs.get_smoke_config("olmoe_1b_7b")
    mcfg = cfg.moe
    p = TM.moe_init(torch.Generator().manual_seed(0), cfg.d_model, mcfg,
                    cfg.gated_mlp, dtype=torch.float32, device="cpu")
    x = torch.randn(2, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))

    def grads(fn, of_aux=False):
        lp = {k: v.detach().requires_grad_() for k, v in p.items()}
        lx = x.clone().requires_grad_()
        out, aux = fn(lp, lx)
        loss = aux if of_aux else (out * cot).sum()
        return dict(zip(list(lp) + ["x"], torch.autograd.grad(
            loss, list(lp.values()) + [lx], allow_unused=True)))

    def dense(lp, lx):
        return TM.moe_dense(lp, lx, mcfg, cfg.gated_mlp)

    def ep(lp, lx):
        with use_sharding(make_smoke_mesh(1, 2, devices=["cpu"] * 2)):
            return TM.moe_ep(lp, lx, mcfg, cfg.gated_mlp,
                             capacity_factor=mcfg.num_experts / mcfg.top_k)
    fn = dense if path == "dense" else ep
    want, got = grads(dense), grads(fn)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)
    assert float(grads(fn, of_aux=True)["router"].abs().max()) > 0
