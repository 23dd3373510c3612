"""Parity of the port's encoder-decoder (``repro_torch.models.encdec``, the
blockwise attention with ``causal``, ``kv_valid`` and ``kv_override``, the
Engine and the tasked decode loop over its cache, ``convert`` of its
trees) and of ``repro_torch.data.pipeline`` with the JAX package's.

The same numpy inputs and the JAX package's own weights (carried across by
``repro_torch.convert.lm_from_jax``) go through both, at the whisper smoke
configuration (2 encoder and 2 decoder layers, d_model 64, encoder_seq 24,
float32). The frames are ``0.1 * N(0, 1)``, as ``tests/test_arch_smoke.py``
draws them. The JAX oracles run jitted, without a mesh; no Pallas kernel
is on this path in either package.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import attention as JA
from repro.models import build_smoke as jbuild_smoke
from repro.models import encdec as JED
from repro.models.layers import unbox
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, lm_from_jax, to_numpy, to_torch
from repro_torch.core import Runtime, RuntimeConfig
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Engine as TEngine
from repro_torch.models import attention as TA
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models import encdec as TED
from repro_torch.serve import flatten, tasked_decode_loop

TOL = 1e-4
ARCH = "whisper_large_v3"
CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _models(dtype=jnp.float32):
    """(cfg, JAX model, JAX params, port model, port params)."""
    cfg = jget_smoke(ARCH)
    jm = jbuild_smoke(cfg, param_dtype=dtype)
    jp, _ = unbox(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tm = tbuild_smoke(tconfigs.get_smoke_config(ARCH), param_dtype=tdtype)
    return cfg, jm, jp, tm, lm_from_jax(jax.tree.map(np.asarray, jp))


@functools.lru_cache(maxsize=None)
def _japply(mode):
    """The JAX model's ``apply`` in ``mode``, jitted (one compile, where
    eager dispatch compiles op by op)."""
    _, jm, _, _, _ = _models()
    return jax.jit(functools.partial(jm.apply, mode=mode))


def _inputs(seed, b, s, t=24, d=64):
    """Tokens [b, s] int32 and frames [b, t, d] float32, numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, s)).astype(np.int32),
            (0.1 * rng.standard_normal((b, t, d))).astype(np.float32))


def _jbatch(toks, frames):
    return {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}


def _tbatch(toks, frames):
    return {"tokens": torch.from_numpy(toks),
            "frames": torch.from_numpy(frames)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(to_numpy(got) if isinstance(got, torch.Tensor)
                               else got, np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the pieces: sinusoids, blockwise attention, the attention layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,channels,tol", [(24, 64, TOL),
                                                 (128, 64, TOL),
                                                 (1500, 1280, 3e-4)])
def test_sinusoids_match_jax(length, channels, tol):
    """At whisper's 1500 positions the angle ``t * inv`` reaches 1499 rad:
    XLA's and torch's float32 ``exp`` differ by one ulp (6e-8) in some
    timescales, which t carries to 9e-5, and one float32 ulp of the angle
    there is 1.2e-4; so 3e-4 at that size, 1e-4 at the smoke sizes."""
    _close(TED._sinusoids(length, channels),
           JED._sinusoids(length, channels), tol)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal,valid,g", [(False, 100, 1), (False, 37, 2),
                                            (True, None, 2),
                                            (False, None, 1)])
def test_flash_attention_matches_jax(dtype, tol, causal, valid, g):
    """``flash_attention`` over several q and kv blocks, bidirectional
    with a ``kv_valid`` that masks a tail (one that ends inside the first
    kv block too), causal, and bidirectional unmasked (the encoder's)."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 64, 2, g, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 128, 2, 16)).astype(np.float32)
            for _ in range(2))
    t_valid = None if valid is None else np.arange(128) < valid
    jdt = jnp.dtype(dtype)
    want = JA.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        q_positions=jnp.arange(64, dtype=jnp.int32),
        kv_positions=jnp.arange(128, dtype=jnp.int32), causal=causal,
        q_block=32, kv_block=64,
        kv_valid=None if t_valid is None else jnp.asarray(t_valid))
    tdt = getattr(torch, dtype)
    got = TA.flash_attention(
        *(to_torch(a).to(tdt) for a in (q, k, v)), causal=causal,
        q_block=32, kv_block=64,
        kv_valid=None if t_valid is None else torch.from_numpy(t_valid))
    assert got.dtype == tdt and got.shape == q.shape
    _close(got.float(), np.asarray(want, np.float32), tol)


def _attn_params(seed, d=48, h=4, kh=2, hd=8):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, h, hd), "wk": (d, kh, hd), "wv": (d, kh, hd),
              "wo": (h, hd, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(d if n != "wo" else h * hd)
                ).astype(np.float32) for n, s in shapes.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: to_torch(v) for k, v in p.items()})


@pytest.mark.parametrize("use_rope", [False, True])
def test_attention_layer_decode_with_kv_override_matches_jax(use_rope):
    """Decode against given K/V (cross-attention): q alone is projected
    (and rotated where ``use_rope``), ``kv_valid`` broadcasts over the
    batch, and no cache comes back."""
    jp, tp = _both(_attn_params(1))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 1, 48)).astype(np.float32)
    k, v = (rng.standard_normal((3, 40, 2, 8)).astype(np.float32)
            for _ in range(2))
    valid = np.arange(40) < 29
    lengths = np.array([0, 5, 17], np.int32)
    kw = dict(kind="global_attn", rope_theta=10000.0, n_kv_heads=2,
              mode="decode", use_rope=use_rope)
    jy, jc = JA.attention_layer(
        jp, jnp.asarray(x), window=0, lengths=jnp.asarray(lengths),
        kv_override=(jnp.asarray(k), jnp.asarray(v)),
        kv_valid=jnp.asarray(valid), **kw)
    ty, tc = TA.attention_layer(
        tp, to_torch(x), lengths=torch.from_numpy(lengths),
        kv_override=(to_torch(k), to_torch(v)),
        kv_valid=torch.from_numpy(valid), **kw)
    assert jc is None and tc is None
    _close(ty, jy)
    # without kv_valid every key counts
    jy = JA.attention_layer(jp, jnp.asarray(x), window=0,
                            lengths=jnp.asarray(lengths),
                            kv_override=(jnp.asarray(k), jnp.asarray(v)),
                            **kw)[0]
    ty = TA.attention_layer(tp, to_torch(x), lengths=torch.from_numpy(lengths),
                            kv_override=(to_torch(k), to_torch(v)), **kw)[0]
    _close(ty, jy)


@pytest.mark.parametrize("mode,override,use_kernel", [
    ("train", False, True), ("prefill", False, False),
    ("prefill", True, False), ("train", True, True)])
def test_attention_layer_bidirectional_matches_jax(mode, override,
                                                   use_kernel):
    """``causal=False, use_rope=False`` (the encoder's self-attention, and
    a cross-attention prefill through ``kv_override``) takes the blockwise
    path even with the kernel flag set, as ``use_pallas`` sends only
    causal attention to Pallas; a prefill with ``kv_override`` returns no
    cache."""
    jp, tp = _both(_attn_params(3))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 128, 48)).astype(np.float32)
    kv = tuple(rng.standard_normal((2, 256, 2, 8)).astype(np.float32)
               for _ in range(2))
    kw = dict(kind="global_attn", rope_theta=10000.0, n_kv_heads=2,
              mode=mode, causal=False, use_rope=False)
    jy, jc = JA.attention_layer(
        jp, jnp.asarray(x), window=0, use_pallas=use_kernel,
        kv_override=tuple(map(jnp.asarray, kv)) if override else None, **kw)
    before = LAUNCHES["flash_attention"]
    ty, tc = TA.attention_layer(
        tp, to_torch(x), use_kernel=use_kernel,
        kv_override=tuple(map(to_torch, kv)) if override else None, **kw)
    assert LAUNCHES["flash_attention"] == before
    _close(ty, jy)
    if mode == "train" or override:
        assert jc is None and tc is None
    else:
        for key in ("k", "v"):
            _close(tc[key], jc[key])


# ---------------------------------------------------------------------------
# the model: encoder, full forward, prefill, decode
# ---------------------------------------------------------------------------

def test_encode_matches_jax():
    cfg, jm, jp, tm, tp = _models()
    _, frames = _inputs(1, 2, 8, t=128)
    want = jax.jit(lambda p, f: JED.encode(p, f, cfg))(jp, jnp.asarray(frames))
    got = TED.encode(tp, torch.from_numpy(frames), tm.cfg)
    _close(got, want)


def test_train_forward_matches_jax():
    """Hidden state and logits of a full forward (frames padded from 24 to
    128, the padding masked in cross-attention)."""
    cfg, jm, jp, tm, tp = _models()
    toks, frames = _inputs(2, 2, 16)
    jx = _japply("train")(jp, _jbatch(toks, frames))[0]
    tx, tc, _ = tm.apply(tp, _tbatch(toks, frames), mode="train")
    assert tc is None
    _close(tx, jx)
    _close(tm.unembed(tp, tx), jm.unembed(jp, jx))


@pytest.mark.parametrize("t", [24, 20], ids=["encoder_seq", "shorter"])
def test_prefill_and_caches_match_jax(t):
    """Prefill's hidden state and both caches: into a capacity cache
    (self slots [0, S), the rest zero; cross whole, in place) and without
    one (the JAX package's tree, through ``cache_from_jax``)."""
    cfg, jm, jp, tm, tp = _models()
    toks, frames = _inputs(3, 2, 16, t=t)
    jx, jc, _ = _japply("prefill")(jp, _jbatch(toks, frames),
                                   cache=jm.init_cache(2, 16))
    want = cache_from_jax(jax.tree.map(np.asarray, jc))
    tx, tc = tm.apply(tp, _tbatch(toks, frames), mode="prefill")
    _close(tx, jx)
    torch.testing.assert_close(tc, want, rtol=TOL, atol=TOL)
    cap = tm.init_cache(2, 40, CPU)
    assert cap["decoder"]["cross"]["k"].shape == (2, 2, 128, 4, 16)
    tx2, tc2 = tm.apply(tp, _tbatch(toks, frames), mode="prefill", cache=cap)
    assert tc2 is cap and torch.equal(tx2, tx)
    for key in ("k", "v"):
        self_ = cap["decoder"]["self"][key]
        torch.testing.assert_close(self_[:, :, :16],
                                   want["decoder"]["self"][key],
                                   rtol=TOL, atol=TOL)
        assert not self_[:, :, 16:].any()
        torch.testing.assert_close(cap["decoder"]["cross"][key],
                                   want["decoder"]["cross"][key],
                                   rtol=TOL, atol=TOL)


def _jax_decode(jm, jp, jc, toks, s, steps, cap):
    """The JAX model's prefill cache (self of length s) grown to ``cap``
    slots, then ``steps`` decode steps fed ``toks`` [B, steps]: each
    step's logits and the last cache."""
    jc = {"decoder": {"self": jax.tree.map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, cap - s), (0, 0), (0, 0))),
        jc["decoder"]["self"]), "cross": jc["decoder"]["cross"]}}
    step = jax.jit(lambda p, c, tok, lens: jm.apply(
        p, {"tokens": tok, "lengths": lens}, mode="decode", cache=c)[:2])
    logits = []
    for i in range(steps):
        lens = jnp.full((toks.shape[0],), s + i, jnp.int32)
        x, jc = step(jp, jc, jnp.asarray(toks[:, i:i + 1]), lens)
        logits.append(np.asarray(jm.unembed(jp, x)))
    return logits, jc


@pytest.mark.parametrize("t", [24, 20], ids=["encoder_seq", "shorter"])
def test_decode_steps_match_jax(t):
    """8 decode steps from the JAX prefill's cache (carried across by
    ``cache_from_jax``, the self cache grown to capacity), fed the same
    tokens: each step's logits within 1e-4 of JAX's decode, and the caches
    after them. With frames shorter than ``encoder_seq`` the two packages
    mask the cross K/V at t in the prefill and at ``encoder_seq`` in
    decode alike."""
    cfg, jm, jp, tm, tp = _models()
    s, steps, cap = 16, 8, 24
    toks, frames = _inputs(4, 2, s, t=t)
    feed = np.random.default_rng(5).integers(0, 256, (2, steps)).astype(
        np.int32)
    _, jc, _ = _japply("prefill")(jp, _jbatch(toks, frames),
                                  cache=jm.init_cache(2, s))
    tc = tm.init_cache(2, cap, CPU)
    pre = cache_from_jax(jax.tree.map(np.asarray, jc))
    for key in ("k", "v"):
        tc["decoder"]["self"][key][:, :, :s] = pre["decoder"]["self"][key]
        tc["decoder"]["cross"][key].copy_(pre["decoder"]["cross"][key])
    cross = {k: v.clone() for k, v in tc["decoder"]["cross"].items()}
    want, jc = _jax_decode(jm, jp, jc, feed, s, steps, cap)
    for i in range(steps):
        lens = torch.full((2,), s + i, dtype=torch.int32)
        x, out = tm.apply(tp, {"tokens": torch.from_numpy(feed[:, i:i + 1]),
                               "lengths": lens}, mode="decode", cache=tc)
        assert out is tc
        _close(tm.unembed(tp, x), want[i])
    torch.testing.assert_close(tc, cache_from_jax(
        jax.tree.map(np.asarray, jc)), rtol=TOL, atol=TOL)
    for key in ("k", "v"):                   # decode never writes the cross
        assert torch.equal(tc["decoder"]["cross"][key], cross[key])


# ---------------------------------------------------------------------------
# serving: the Engine, the tasked decode loop, the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,s", [(2, 16), (8, 8), (3, 12)],
                         ids=["b2_s16", "b_eq_s", "b3_s12"])
def test_engine_matches_jax_full_forward(b, s):
    """The Engine's greedy tokens (frames in ``extra``) are the argmax of
    the JAX model's full forward (``mode="train"``) over the prompt and
    the tokens before each, with the same frames. Held to the full
    forward, not to the JAX Engine, whose ``grow`` pads the batch axis
    where B = S; one case has B = S. (With frames shorter than
    ``encoder_seq`` the decode masks the cross K/V at ``encoder_seq`` and
    the full forward at their length, in both packages: that case is
    held to JAX's decode, ``test_decode_steps_match_jax``.)"""
    cfg, jm, jp, tm, tp = _models()
    gen = 12
    toks, frames = _inputs(6 + b, b, s)
    got = TEngine(tm, tp, b, s + gen).generate(
        torch.from_numpy(toks), gen, {"frames": torch.from_numpy(frames)})
    assert got.dtype == torch.int32 and got.shape == (b, gen)
    full = np.concatenate([toks, got[:, :-1].numpy()], axis=1)
    hidden = _japply("train")(jp, _jbatch(full, frames))[0]
    want = np.asarray(jm.unembed(jp, hidden)[:, s - 1:].argmax(axis=-1))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("traced", [False, True],
                         ids=["interpreted", "replayed"])
def test_tasked_decode_loop_matches_engine(traced):
    """The decode loop as hetero tasks over ``{"decoder": {"self",
    "cross"}}`` gives the Engine's tokens and caches bit for bit,
    interpreted and under ``trace_graphs`` (on the CPU a replayed window
    runs its chain eagerly)."""
    cfg, jm, jp, tm, tp = _models()
    prompt, steps = 16, 8
    toks, frames = _inputs(8, 2, prompt)
    eng = TEngine(tm, tp, 2, prompt + steps)
    nxt, cache = eng.prefill(torch.from_numpy(toks),
                             {"frames": torch.from_numpy(frames)})
    tasked = jax.tree.map(torch.clone, cache)
    want = eng.decode(cache, nxt, prompt, steps)
    lengths = torch.full((2,), prompt, dtype=torch.int32)
    with Runtime(RuntimeConfig(device="cpu", cpu_devices=2,
                               memory_capacity=1 << 28,
                               trace_graphs=traced)) as rt:
        tok_obj, len_obj, c_objs = tasked_decode_loop(
            rt, tm, tp, tasked, nxt.clone(), lengths, steps)
        stats = rt.stats()
        assert stats["tasks"] == steps
        if traced:
            assert stats["graph_replays"] > 0
        np.testing.assert_array_equal(tok_obj.get(), want[:, -1:].numpy())
        np.testing.assert_array_equal(len_obj.get(),
                                      np.full(2, prompt + steps))
        flat = dict(flatten(cache))
        assert sorted(c_objs) == sorted(flat) == [
            "decoder.cross.k", "decoder.cross.v", "decoder.self.k",
            "decoder.self.v"]
        for key, obj in c_objs.items():
            np.testing.assert_array_equal(obj.get(), flat[key].numpy())


def test_serve_main_runs_whisper_on_the_cpu(capsys):
    before = dict(LAUNCHES)
    out = tserve.main(["--arch", "whisper-large-v3", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "16", "--gen",
                       "5"])
    assert tuple(out.shape) == (2, 5)
    assert dict(LAUNCHES) == before               # no kernel on this path
    assert "generated (2, 5) on cpu" in capsys.readouterr().out


def test_prefill_refuses_frames_past_the_cross_cache():
    """Frames that pad to more slots than the cross cache holds (24 rounds
    to 128) cannot be served from it."""
    cfg, jm, jp, tm, tp = _models()
    toks, frames = _inputs(9, 2, 8, t=130)
    with pytest.raises(ValueError, match="cross cache has 128 slots"):
        tm.apply(tp, _tbatch(toks, frames), mode="prefill",
                 cache=tm.init_cache(2, 16, CPU))


# ---------------------------------------------------------------------------
# weights and caches across packages
# ---------------------------------------------------------------------------

def test_lm_from_jax_carries_the_encdec_tree_under_bf16():
    """The layer-stacked encoder and decoder cross leaf for leaf: norms
    stay float32 under bf16 weights, the rest bf16, every stacked leaf
    with its layer axis; the port's own init and cache have the same
    tree. An unknown block layout raises."""
    cfg, jm, jp, tm, tp = _models(jnp.bfloat16)
    tree = tp.tree()
    mine = tm.init(torch.Generator().manual_seed(0), CPU).tree()
    assert sorted((k, v.shape, v.dtype) for k, v in flatten(mine)) == \
        sorted((k, v.shape, v.dtype) for k, v in flatten(tree))
    for name, leaf in flatten(tree):
        f32 = "norm" in name.rsplit(".", 1)[-1]
        assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), name
        if name.startswith(("encoder.", "decoder.")):
            assert leaf.shape[0] == 2, name
    assert tree["pos_embed"].shape == (cfg.max_seq, 64)
    jcache = cache_from_jax(jax.tree.map(np.asarray, jm.init_cache(2, 40)))
    assert sorted((k, v.shape, v.dtype) for k, v in flatten(jcache)) == \
        sorted((k, v.shape, v.dtype)
               for k, v in flatten(tm.init_cache(2, 40, CPU)))
    bad = jax.tree.map(np.asarray, jp)
    bad["decoder"] = dict(bad["decoder"], moe={})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm_from_jax(bad)


def test_bf16_forward_matches_jax():
    """bf16 weights at smoke size: both packages round at the same places
    (products to bf16, p before p·v, norms back to bf16) but not always in
    the same order, so the hidden states differ by a few bf16 ulps: 3e-2
    in relative L2 norm, as ``test_torch_serve.py`` holds yi-9b's."""
    cfg, jm, jp, tm, tp = _models(jnp.bfloat16)
    toks, frames = _inputs(10, 2, 16)
    jx = np.asarray(jax.jit(functools.partial(jm.apply, mode="train"))(
        jp, _jbatch(toks, frames))[0], np.float32)
    tx = tm.apply(tp, _tbatch(toks, frames), mode="train")[0]
    assert tx.dtype == torch.bfloat16
    tx = tx.float().numpy()
    assert np.linalg.norm(tx - jx) <= 3e-2 * np.linalg.norm(jx)


# ---------------------------------------------------------------------------
# the synthetic data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,host_index,host_count", [
    (0, 256, 0, 1), (3, 51866, 1, 2), (17, 5000, 3, 4)])
def test_synthetic_lm_equals_jax(seed, vocab, host_index, host_count):
    """Bit for bit the JAX package's stream at several steps, for every
    host's slice; an uneven split raises."""
    kw = dict(vocab=vocab, seq_len=24, global_batch=8, seed=seed,
              host_index=host_index, host_count=host_count)
    mine = SyntheticLM(DataConfig(**kw))
    theirs = JSyntheticLM(JDataConfig(**kw))
    assert mine.local_batch == theirs.local_batch == 8 // host_count
    for step in (0, 1, 7, 1000):
        got, want = mine.batch(step), theirs.batch(step)
        assert set(got) == set(want) == {"tokens", "labels"}
        for key in got:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    it = iter(mine)
    np.testing.assert_array_equal(next(it)["tokens"],
                                  mine.batch(0)["tokens"])
    np.testing.assert_array_equal(next(it)["tokens"],
                                  mine.batch(1)["tokens"])
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLM(DataConfig(**dict(kw, host_count=3)))


def test_cross_cache_slots_round_encoder_seq_up():
    """The cross cache holds ``encoder_seq`` rounded up to 128 slots, the
    length the prefill pads the frames to: 1536 for whisper's 1500, 128
    at the smoke size's 24."""
    assert TED.encoder_slots(tconfigs.get_config(ARCH)) == 1536
    assert TED.encoder_slots(tconfigs.get_smoke_config(ARCH)) == 128
