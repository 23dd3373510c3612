"""Parity of the port's flash attention (``repro_torch.kernels.flash_attention``
and ``repro_torch.models.attention.flash_attention``) with the JAX
package's Pallas kernel, its ``ref.flash_ref`` oracle and its blockwise
model attention.

On the CPU the wrappers run the plain PyTorch version; the Pallas kernel
runs in interpret mode, as ``test_kernels.py`` runs it. Inputs come from
numpy seeds. The CUDA kernel itself is held against the plain version on a
card by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro_torch.convert import to_numpy, to_torch
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.models import attention as TA

TOL = 1e-4          # the JAX test's tolerance (test_kernels.py)


def _qkv(seed, q_shape, kv_shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype)
                 for s in (q_shape, kv_shape, kv_shape))


@pytest.mark.parametrize("s,t,d,causal", [(256, 256, 64, True),
                                          (128, 256, 64, False),
                                          (256, 128, 32, False),
                                          (128, 64, 8, True),
                                          (128, 128, 160, True),
                                          (128, 128, 256, True)])
def test_flash_matches_pallas_and_ref(s, t, d, causal):
    if causal and (s, t) != (128, 64):
        t = s
    q, k, v = _qkv(s + t + d, (4, s, d), (4, t, d))
    n = LAUNCHES["flash_attention"]
    got = to_numpy(ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                                       causal=causal))
    assert LAUNCHES["flash_attention"] == n        # plain version on the CPU
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal))
    oracle = np.asarray(jref.flash_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("g,d", [(1, 12), (3, 8), (4, 32), (2, 160),
                                 (2, 256)])
def test_flash_gqa_matches_pallas_folding(g, d):
    """``flash_attention_gqa`` reads KV head h // G in place; the JAX
    package broadcasts K and V to every query head and folds the heads
    (``_pallas_flash``)."""
    b, s, kh = 2, 128, 2
    q, k, v = _qkv(g * 100 + d, (b, s, kh, g, d), (b, s, kh, d))
    got = to_numpy(ops.flash_attention_gqa(to_torch(q), to_torch(k),
                                           to_torch(v)))
    want = np.asarray(JA._pallas_flash(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,t,block,causal", [
    (256, 256, 128, True), (256, 256, 64, False), (128, 256, 512, False),
    (96, 96, 32, True)])
def test_model_flash_matches_jax_blockwise(s, t, block, causal):
    b, kh, g, d = 2, 2, 2, 16
    q, k, v = _qkv(s * 7 + block, (b, s, kh, g, d), (b, t, kh, d))
    got = to_numpy(TA.flash_attention(
        to_torch(q), to_torch(k), to_torch(v), causal=causal,
        q_block=block, kv_block=block))
    want = np.asarray(JA.flash_attention(
        *map(jnp.asarray, (q, k, v)), q_positions=jnp.arange(s),
        kv_positions=jnp.arange(t), causal=causal, q_block=block,
        kv_block=block))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_flash_bf16_matches_pallas():
    """bf16 operands: both round p to bf16 before p·v and the output to
    bf16; the kernel's 64-wide tiles against Pallas's 128 change where the
    online max is taken, so p rounds differently. Tolerance 2e-2: a few
    bf16 ulps (2^-8 = 3.9e-3 relative) on outputs of magnitude below 2."""
    q, k, v = _qkv(11, (4, 256, 64), (4, 256, 64))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(*(to_torch(np.asarray(x)) for x in (jq, jk, jv)))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=True),
                      np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("s,causal", [(32, True), (96, True), (96, False)])
def test_flash_short_sequences_match_pallas(s, causal):
    """S = T below 128 and not a multiple of the card kernel's 64-row
    tiles: Pallas takes them as one block (qb = kb = S), the port's plain
    version as a 64-row block and a short one."""
    q, k, v = _qkv(s + 5, (3, s, 16), (3, s, 16))
    got = to_numpy(ops.flash_attention(*map(to_torch, (q, k, v)),
                                       causal=causal))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal))
    oracle = np.asarray(jref.flash_ref(jq, jk, jv, causal=causal))
    np.testing.assert_allclose(got, pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


def test_plain_flash_rejects_ragged_blocks():
    q, k, v = map(to_torch, _qkv(0, (1, 96, 1, 1, 8), (1, 96, 1, 8)))
    with pytest.raises(ValueError):
        TA.flash_attention(q, k, v, q_block=64, kv_block=64)
