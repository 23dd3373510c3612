"""Parity of the port's pixtral-12b serving path with the JAX package's:
precomputed ``vision_embeds`` written over the head of the sequence
(``transformer._embed_inputs``), the prefill with them through the flash
kernel's flag, the Engine's ``extra`` inputs and the serve entry point, at
the smoke configuration (3 global layers, 8 vision positions), without a
mesh.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.launch.serve import Engine as JEngine
from repro.models import build_smoke as jbuild_smoke
from repro.models import transformer as JT
from repro.models.layers import unbox
from repro_torch import configs as tconfigs
from repro_torch.convert import cache_from_jax, lm_from_jax, to_numpy, to_torch
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Engine as TEngine
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models import transformer as TT

TOL = 1e-4
ARCH = "pixtral_12b"


@functools.lru_cache(maxsize=None)
def _models(**flags):
    """(cfg, JAX model, JAX params, port model, port params); ``flags``
    are the JAX model's (``use_pallas_flash`` turns on the port's
    ``use_flash_kernel``)."""
    cfg = jget_smoke(ARCH)
    jm = jbuild_smoke(cfg, **flags)
    jp, _ = unbox(jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tm = tbuild_smoke(tconfigs.get_smoke_config(ARCH),
                      use_flash_kernel=flags.get("use_pallas_flash", False))
    return cfg, jm, jp, tm, lm_from_jax(jax.tree.map(np.asarray, jp))


def _batch(seed, b, s, n_tok=8, d=64):
    """Tokens [b, s] and vision embeddings [b, n_tok, d] (at the scale of
    the embedding rows), numpy."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, s)).astype(np.int32),
            (rng.standard_normal((b, n_tok, d)) * 0.02).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vision_embeds_written_over_the_head_like_jax(dtype):
    """``_embed_inputs``: the first 8 positions are the vision embeddings
    cast to the weight dtype, the rest the token embeddings, equal to the
    JAX package's; without ``vision_embeds`` (decode) the tokens' alone."""
    cfg, jm, jp, tm, tp = _models()
    toks, ve = _batch(0, 2, 20)
    emb = jp["embed"].astype(dtype)
    flags = dataclasses.replace(jm.flags, param_dtype=jnp.dtype(dtype))
    want = np.asarray(JT._embed_inputs(
        {"embed": emb}, cfg, {"tokens": jnp.asarray(toks),
                              "vision_embeds": jnp.asarray(ve)}, flags))
    temb = to_torch(np.asarray(emb))
    got = TT._embed_inputs({"embed": temb}, tm.cfg,
                           {"tokens": torch.from_numpy(toks),
                            "vision_embeds": to_torch(ve)})
    assert got.dtype == temb.dtype
    np.testing.assert_array_equal(to_numpy(got), want)
    plain = TT._embed_inputs({"embed": temb}, tm.cfg,
                             {"tokens": torch.from_numpy(toks)})
    assert torch.equal(plain, temb[torch.from_numpy(toks).long()])
    assert torch.equal(plain[:, 8:], got[:, 8:])


def test_prefill_and_cache_match_jax():
    """A prefill with vision embeddings: hidden state within 1e-4 of
    ``lm_apply``'s and the KV cache equal to JAX's through
    ``cache_from_jax``."""
    cfg, jm, jp, tm, tp = _models()
    toks, ve = _batch(1, 2, 40)
    jx, jc, _ = jax.jit(functools.partial(jm.apply, mode="prefill"))(
        jp, {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(ve)},
        cache=jm.init_cache(2, 40))
    tx, tc = tm.apply(tp, {"tokens": torch.from_numpy(toks),
                           "vision_embeds": to_torch(ve)}, mode="prefill")
    np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=TOL,
                               atol=TOL)
    torch.testing.assert_close(tc, cache_from_jax(jax.tree.map(np.asarray,
                                                                jc)),
                               rtol=TOL, atol=TOL)


def test_kernel_flag_matches_jax_pallas_flag():
    """``use_flash_kernel`` sends the 128-token prefill through the
    kernel's wrapper (its plain version on the CPU), as
    ``use_pallas_flash`` sends it through the Pallas kernel (interpret
    mode): the same hidden states with vision embeddings, in train and
    prefill mode."""
    cfg, jm, jp, tm, tp = _models(use_pallas_flash=True)
    toks, ve = _batch(2, 2, 128)
    for mode in ("train", "prefill"):
        jx = jm.apply(jp, {"tokens": jnp.asarray(toks),
                           "vision_embeds": jnp.asarray(ve)}, mode=mode,
                      cache=jm.init_cache(2, 128))[0]
        tx = tm.apply(tp, {"tokens": torch.from_numpy(toks),
                           "vision_embeds": to_torch(ve)}, mode=mode)[0]
        np.testing.assert_allclose(to_numpy(tx), np.asarray(jx), rtol=2e-4,
                                   atol=2e-4)


def test_engine_generate_with_extra_matches_jax_engine():
    """``Engine.generate(tokens, gen, extra)``: the vision embeddings join
    the prefill only; the same greedy tokens as the JAX Engine given the
    same ``extra``, and other tokens than without it."""
    cfg, jm, jp, tm, tp = _models()
    toks, ve = _batch(3, 2, 24)
    want = np.asarray(JEngine(jm, jp, 2, 36).generate(
        jnp.asarray(toks), 12, {"vision_embeds": jnp.asarray(ve)}))
    eng = TEngine(tm, tp, 2, 36)
    got = eng.generate(torch.from_numpy(toks), 12,
                       {"vision_embeds": to_torch(ve)})
    np.testing.assert_array_equal(got.numpy(), want)
    assert not torch.equal(eng.generate(torch.from_numpy(toks), 12), got)


def test_serve_main_runs_pixtral_on_the_cpu(capsys):
    before = dict(LAUNCHES)
    out = tserve.main(["--arch", "pixtral-12b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    assert tuple(out.shape) == (2, 4)
    assert dict(LAUNCHES) == before               # no kernel on the CPU
    assert "generated (2, 4) on cpu" in capsys.readouterr().out
