"""Parity of the port's serving path (``repro_torch.configs``, ``models``,
``serve`` and ``launch.serve``) with the JAX package's, for the dense
configurations, mamba2-370m, recurrentgemma-9b and pixtral-12b, at the
smoke configurations, without a mesh.

The same numpy inputs and the JAX package's own weights (carried across by
``repro_torch.convert.lm_from_jax``) go through both. The JAX Pallas flash
kernel runs in interpret mode where ``use_pallas_flash`` routes to it; the
port's kernel wrappers run their plain versions on CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch.serve import Engine as JEngine
from repro.models import attention as JA
from repro.models import build_smoke as jbuild_smoke
from repro.models import layers as JL
from repro.models.layers import unbox
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, lm_from_jax, to_numpy, to_torch
from repro_torch.core import Runtime, RuntimeConfig
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Engine as TEngine
from repro_torch.models import attention as TA
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models import layers as TL
from repro_torch.serve import tasked_decode_loop

TOL = 1e-4
ARCHS = ("yi_9b", "phi4_mini_3_8b", "codeqwen15_7b", "mamba2_370m",
         "recurrentgemma_9b", "pixtral_12b", "whisper_large_v3")
# the serving tests below run the decoder-only configurations
LM_ARCHS = ARCHS[:-1]


def _jax_model(arch, **flags):
    cfg = jget_smoke(arch)
    model = jbuild_smoke(cfg, **flags)
    params, _ = unbox(model.init(jax.random.PRNGKey(0)))
    return cfg, model, params


def _port_model(arch, jparams, **flags):
    model = tbuild_smoke(tconfigs.get_smoke_config(arch), **flags)
    return model, lm_from_jax(jax.tree.map(np.asarray, jparams))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_jax_packages(arch):
    for get_t, get_j in ((tconfigs.get_config, jget_config),
                         (tconfigs.get_smoke_config, jget_smoke)):
        assert dataclasses.asdict(get_t(arch)) == \
            dataclasses.asdict(get_j(arch))
        assert get_t(arch).param_count() == get_j(arch).param_count()
        assert get_t(arch).attention_free == get_j(arch).attention_free


def test_unported_configs_raise():
    """No configuration of the JAX package is left unported: each loads in
    the port with the JAX package's parameter count. Only a name the JAX
    package does not know raises."""
    from repro.configs.base import ARCH_IDS as JARCH_IDS
    assert tconfigs.ARCH_IDS == JARCH_IDS
    for arch in JARCH_IDS:
        for get_t, get_j in ((tconfigs.get_config, jget_config),
                             (tconfigs.get_smoke_config, jget_smoke)):
            assert get_t(arch).param_count() == get_j(arch).param_count(), \
                arch
    with pytest.raises(ValueError, match="unknown architecture"):
        tconfigs.get_config("no-such-arch")
    assert tconfigs.get_config("whisper-large-v3").param_count() == \
        1_600_988_160
    assert tconfigs.get_config("yi-9b").param_count() == 8_829_403_136
    assert tconfigs.get_config("recurrentgemma-9b").param_count() == \
        9_572_032_512
    assert tconfigs.get_config("pixtral-12b").param_count() == \
        12_247_777_280
    assert tconfigs.get_config("mamba2-370m").param_count() == 368_123_904


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    got = to_numpy(TL.rms_norm(to_torch(x), to_torch(scale), 1e-6))
    want = np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32) + 3
    got = to_numpy(TL.apply_rope(to_torch(x), torch.from_numpy(pos), theta))
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # per-request positions, as decode passes them: [B, 1]
    bpos = np.array([[5], [900]], np.int32)
    got = to_numpy(TL.apply_rope(to_torch(x[:, :1]), torch.from_numpy(bpos),
                                 theta))
    want = np.asarray(JL.apply_rope(jnp.asarray(x[:, :1]), jnp.asarray(bpos),
                                    theta))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_apply_matches_jax(gated):
    rng = np.random.default_rng(2)
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.2
         for n, s in (("wi", (32, 48)), ("wg", (32, 48)), ("wo", (48, 32)))}
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    got = to_numpy(TL.mlp_apply({k: to_torch(v) for k, v in p.items()},
                                to_torch(x), gated))
    want = np.asarray(JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), gated))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# attention layer: prefill and decode, kernel flag on and off
# ---------------------------------------------------------------------------

def _attn_params(seed, d=48, h=6, kh=2, hd=8):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, h, hd), "wk": (d, kh, hd), "wv": (d, kh, hd),
              "wo": (h, hd, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0] * (s[1] if n == "wo"
                                                         else 1))
                ).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_layer_prefill_matches_jax(use_kernel):
    p = _attn_params(3)
    x = np.random.default_rng(4).standard_normal((2, 128, 48)).astype(
        np.float32)
    kw = dict(kind="global_attn", rope_theta=10000.0, n_kv_heads=2,
              mode="prefill")
    jy, jcache = JA.attention_layer({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), use_pallas=use_kernel,
                                    window=0, **kw)
    # the port writes the prefill into slots [0, S) of a capacity cache
    cache = TA.init_attn_cache(2, 160, 2, 8, dtype=torch.float32,
                               device="cpu")
    ty, tcache = TA.attention_layer({k: to_torch(v) for k, v in p.items()},
                                    to_torch(x), use_kernel=use_kernel,
                                    cache=cache, **kw)
    assert tcache is cache
    np.testing.assert_allclose(to_numpy(ty), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_numpy(cache[key][:, :128]),
                                   np.asarray(jcache[key]), rtol=TOL,
                                   atol=TOL)
        assert not cache[key][:, 128:].any()


def test_attention_layer_decode_matches_jax():
    """Ragged lengths: each request writes its own slot lengths[b]."""
    p = _attn_params(5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1, 48)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 40, 2, 8)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([0, 17, 39], np.int32)
    kw = dict(kind="global_attn", rope_theta=10000.0, n_kv_heads=2,
              mode="decode")
    jy, jc = JA.attention_layer(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        lengths=jnp.asarray(lengths), window=0,
        cache={"k": jnp.asarray(kc), "v": jnp.asarray(vc)}, **kw)
    cache = {"k": to_torch(kc.copy()), "v": to_torch(vc.copy())}
    ty, tc = TA.attention_layer({k: to_torch(v) for k, v in p.items()},
                                to_torch(x), lengths=torch.from_numpy(lengths),
                                cache=cache, **kw)
    assert tc is cache                                  # written in place
    np.testing.assert_allclose(to_numpy(ty), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(to_numpy(cache[key]), np.asarray(jc[key]),
                                   rtol=TOL, atol=TOL)


def test_unported_attention_paths_raise():
    """Every attention path of the JAX layer is ported: local attention and
    seq-sharded decode (``test_torch_gemma3.py``), cross-attention
    (``kv_override``, ``test_torch_encdec.py``). A recurrent layer kind is
    not an attention kind: ``attention_layer`` refuses it (the RG-LRU layer
    is ``models.rglru``, ``test_torch_rglru.py``); so does a decode with
    neither a cache nor ``kv_override`` to read."""
    p = {k: to_torch(v) for k, v in _attn_params(0).items()}
    x = torch.zeros((1, 8, 48))
    kw = dict(rope_theta=1e4, n_kv_heads=2)
    with pytest.raises(ValueError, match="not an attention kind"):
        TA.attention_layer(p, x, kind="rglru", mode="train", **kw)
    with pytest.raises(ValueError, match="decode needs"):
        TA.attention_layer(p, x[:, :1], kind="global_attn", mode="decode",
                           lengths=torch.zeros(1, dtype=torch.int32), **kw)
    kv = torch.ones((1, 16, 2, 8))
    y, cache = TA.attention_layer(p, x, kind="global_attn", mode="prefill",
                                  kv_override=(kv, kv), **kw)
    assert y.shape == x.shape and cache is None


# ---------------------------------------------------------------------------
# whole model and engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_engine_matches_jax_engine(arch):
    """Same greedy tokens as the JAX Engine (no mesh) from the same
    weights, and prefill logits within 1e-4."""
    cfg, jm, jp = _jax_model(arch)
    tm, tp = _port_model(arch, jp)
    toks = _tokens(1, (4, 32), cfg.vocab)
    want = np.asarray(JEngine(jm, jp, 4, 40).generate(jnp.asarray(toks), 8))
    got = TEngine(tm, tp, 4, 40).generate(torch.from_numpy(toks), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)

    jx, jcache, _ = jm.apply(jp, {"tokens": jnp.asarray(toks)},
                             mode="prefill", cache=jm.init_cache(4, 32))
    tx, tcache = tm.apply(tp, {"tokens": torch.from_numpy(toks)},
                          mode="prefill")
    np.testing.assert_allclose(to_numpy(tm.unembed(tp, tx)),
                               np.asarray(jm.unembed(jp, jx)), rtol=TOL,
                               atol=TOL)
    want_cache = cache_from_jax(jax.tree.map(np.asarray, jcache))
    assert set(tcache) == set(want_cache)
    for key in want_cache:
        torch.testing.assert_close(tcache[key], want_cache[key], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("arch", ["yi_9b", "codeqwen15_7b"])
def test_kernel_flag_matches_jax_pallas_flag(arch):
    """``use_flash_kernel`` routes causal attention with S % 128 == 0
    through the kernel's wrapper, as ``use_pallas_flash`` routes it through
    the Pallas kernel: same hidden states, in train and prefill mode."""
    cfg, jm, jp = _jax_model(arch, use_pallas_flash=True)
    tm, tp = _port_model(arch, jp, use_flash_kernel=True)
    toks = _tokens(2, (2, 128), cfg.vocab)
    for mode in ("train", "prefill"):
        jx = jm.apply(jp, {"tokens": jnp.asarray(toks)}, mode=mode,
                      cache=jm.init_cache(2, 128))[0]
        tx = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, mode=mode)[0]
        np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=2e-4,
                                   atol=2e-4)


def test_ssd_kernel_flag_gives_the_same_hidden_state():
    """``use_ssd_kernel`` takes the intra-chunk form from the kernel's
    wrapper, off takes it from the einsums: the same hidden states, and the
    JAX model's, in train and prefill mode (40 tokens: two chunks of 16 and
    a padded third)."""
    cfg, jm, jp = _jax_model("mamba2_370m")
    on, tp = _port_model("mamba2_370m", jp, use_ssd_kernel=True)
    off, _ = _port_model("mamba2_370m", jp)
    assert not off.flags.use_ssd_kernel
    toks = _tokens(6, (2, 40), cfg.vocab)
    for mode in ("train", "prefill"):
        x_on = to_numpy(on.apply(tp, {"tokens": torch.from_numpy(toks)},
                                 mode=mode)[0])
        x_off = to_numpy(off.apply(tp, {"tokens": torch.from_numpy(toks)},
                                   mode=mode)[0])
        jx = np.asarray(jm.apply(jp, {"tokens": jnp.asarray(toks)},
                                 mode=mode, cache=jm.init_cache(2, 40))[0])
        np.testing.assert_allclose(x_on, x_off, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(x_on, jx, rtol=2e-4, atol=2e-4)


def test_bf16_prefill_matches_jax():
    """bf16 weights and activations at smoke size, kernel flag on. Both
    packages round at the same places (matmul outputs, p before p·v,
    norms back to bf16) but not always in the same order, so the hidden
    states differ by a few bf16 ulps: at most 0.125 absolute on values up
    to about 4 (4 ulps there) and 3e-2 in relative L2 norm."""
    cfg, jm, jp = _jax_model("yi_9b", param_dtype=jnp.bfloat16,
                             use_pallas_flash=True)
    tm, tp = _port_model("yi_9b", jp, param_dtype=torch.bfloat16,
                         use_flash_kernel=True)
    assert tp.tree()["embed"].dtype == torch.bfloat16
    toks = _tokens(3, (2, 128), cfg.vocab)
    jx = np.asarray(jm.apply(jp, {"tokens": jnp.asarray(toks)},
                             mode="train")[0], np.float32)
    tx = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, mode="train")[0]
    assert tx.dtype == torch.bfloat16
    tx = tx.float().numpy()
    assert np.abs(tx - jx).max() <= 0.125
    assert np.linalg.norm(tx - jx) <= 3e-2 * np.linalg.norm(jx)


def test_greedy_decode_matches_full_forward():
    """As ``examples/serve_lm.py`` checks the JAX Engine: greedy decode
    equals the argmax of a full forward over prompt + generated tokens."""
    cfg, jm, jp = _jax_model("yi_9b")
    tm, tp = _port_model("yi_9b", jp)
    prompt, gen = 32, 24
    toks = torch.from_numpy(_tokens(4, (4, prompt), cfg.vocab))
    out = TEngine(tm, tp, 4, prompt + gen).generate(toks, gen)
    full = torch.cat([toks, out[:, :-1]], dim=1)
    hidden, _, _ = tm.apply(tp, {"tokens": full}, mode="train")
    want = tm.unembed(tp, hidden)[:, prompt - 1:].argmax(dim=-1)
    assert torch.equal(want.to(torch.int32), out)


def test_tasked_decode_loop_matches_engine():
    """The decode loop as hetero tasks on a two-device CPU runtime gives
    the Engine's tokens and KV cache."""
    cfg, jm, jp = _jax_model("yi_9b")
    tm, tp = _port_model("yi_9b", jp)
    prompt, steps = 32, 6
    toks = torch.from_numpy(_tokens(5, (2, prompt), cfg.vocab))
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
        np.testing.assert_array_equal(len_obj.get(),
                                      np.full(2, prompt + steps))
        for key in ("k", "v"):
            np.testing.assert_array_equal(c_objs[key].get(),
                                          cache[key].numpy())


def test_tasked_decode_loop_matches_engine_mamba2():
    """The same for the SSD stack: the loop adopts the cache's own keys
    (conv, state), written in place every step."""
    cfg, jm, jp = _jax_model("mamba2_370m")
    tm, tp = _port_model("mamba2_370m", jp, use_ssd_kernel=True)
    prompt, steps = 24, 5
    toks = torch.from_numpy(_tokens(7, (2, prompt), cfg.vocab))
    eng = TEngine(tm, tp, 2, prompt + steps)
    nxt, cache = eng.prefill(toks)
    assert set(cache) == {"conv", "state"}
    tasked_cache = {k: v.clone() for k, v in cache.items()}
    want = eng.decode(cache, nxt, prompt, steps)
    lengths = torch.full((2,), prompt, dtype=torch.int32)
    with Runtime(RuntimeConfig(device="cpu", cpu_devices=2,
                               memory_capacity=1 << 28)) as rt:
        tok_obj, len_obj, c_objs = tasked_decode_loop(
            rt, tm, tp, tasked_cache, nxt.clone(), lengths, steps)
        assert rt.stats()["tasks"] == steps
        assert sorted(c_objs) == ["conv", "state"]
        np.testing.assert_array_equal(tok_obj.get(), want[:, -1:].numpy())
        np.testing.assert_array_equal(len_obj.get(),
                                      np.full(2, prompt + steps))
        for key in ("conv", "state"):
            np.testing.assert_array_equal(c_objs[key].get(),
                                          cache[key].numpy())


def test_serve_main_runs_mamba2_on_the_cpu(capsys):
    n = LAUNCHES["ssd_chunk"]
    out = tserve.main(["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert LAUNCHES["ssd_chunk"] == n             # no kernel on the CPU
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


def test_serve_main_runs_on_the_cpu(capsys):
    n = LAUNCHES["flash_attention"]
    out = tserve.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "128", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert LAUNCHES["flash_attention"] == n       # no kernel on the CPU
    assert "generated (2, 3) on cpu" in capsys.readouterr().out


def test_lm_from_jax_rejects_unported_layouts():
    _, _, jp = _jax_model("yi_9b")
    tree = dict(jax.tree.map(np.asarray, jp), rem_0={})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm_from_jax(tree)
    block = dict(tree["periods"][0], moe={})
    tree = dict(jax.tree.map(np.asarray, jp), periods=(block,))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        lm_from_jax(tree)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cache_from_jax({"periods": ({"state": np.zeros(2)},)})


def test_lm_from_jax_carries_the_ssd_block():
    """The SSD block tree keeps its leading layer axis and dtypes: under
    bf16 weights A_log, D, dt_bias and both norms stay float32."""
    cfg, _, jp = _jax_model("mamba2_370m", param_dtype=jnp.bfloat16)
    tree = lm_from_jax(jax.tree.map(np.asarray, jp)).tree()
    assert set(tree["layers"]) == {"norm1", "ssd"}
    ssd = tree["layers"]["ssd"]
    assert set(ssd) == {"in_proj", "conv_w", "conv_b", "A_log", "D",
                        "dt_bias", "norm", "out_proj"}
    assert all(v.shape[0] == cfg.n_layers for v in ssd.values())
    for key in ("A_log", "D", "dt_bias", "norm"):
        assert ssd[key].dtype == torch.float32, key
    for key in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert ssd[key].dtype == torch.bfloat16, key
    assert tree["layers"]["norm1"].dtype == torch.float32
