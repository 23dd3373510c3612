"""The decode-attention kernel's plain version and its dispatch on the CPU.

``decode_attention_plain`` (``repro_torch.kernels.decode_attention``) is
the kernel's split arithmetic in PyTorch; here it is held to the port's
``decode_attention`` and to the JAX package's, in float32 and bf16, over
the query-group sizes and head dims the configurations use and more,
ragged lengths, split counts that do not divide the cache, and a ring
buffer's prefix. ``attention_layer`` keeps ``decode_attention`` for a CPU
cache and takes the kernel's wrapper for a ``meta`` one (the dry-run's
stand-in for the card). The CUDA kernel itself is held against the plain
version on a card by ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch import opcount
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import decode_attention as KD
from repro_torch.models import attention as TA

META = torch.device("meta")
# float32: sums in another order; bf16: p rounded to bf16 before or after
# its normalisation, the flash kernels' bf16 bound
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
_jax_decode = jax.jit(JA.decode_attention)


def _case(seed, b, t, kh, g, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, kh, g, d), (b, t, kh, d), (b, t, kh, d)))


def _valid(n, t):
    return torch.arange(t)[None, :] < n[:, None].long()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 3, 5, 8, 16])
def test_plain_matches_decode_attention_and_jax(g, d, dtype):
    """Ragged lengths (1, all of T, one inside a tile) over two kv heads:
    the kernel's arithmetic against the port's plain path and the JAX
    package's, both on the same operands."""
    b, t, kh = 3, 200, 2
    q, k, v = _case(g * 1000 + d, b, t, kh, g, d)
    n = torch.tensor([1, t, 77], dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    got = KD.decode_attention_plain(tq, tk, tv, n)
    assert got.dtype == dtype and got.shape == tq.shape
    want = TA.decode_attention(tq, tk, tv, valid=_valid(n, t))
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jdt)
                  for a in (tq, tk, tv))
    jout = _jax_decode(jq, jk, jv, valid=jnp.asarray(_valid(n, t).numpy()))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("t,splits", [(1000, 3), (1000, 7), (300, 2),
                                      (2176, None), (130, 5)])
def test_split_counts_that_do_not_divide_the_cache(t, splits):
    """The slots cut into whole tiles of 64 (the last split short, some
    empty where lengths stop early): the same function as one pass."""
    b, kh, g, d = 4, 2, 4, 64
    q, k, v = (torch.from_numpy(x) for x in _case(t, b, t, kh, g, d))
    n = torch.tensor([1, t, t // 2 + 3, 64], dtype=torch.int32)
    got_s, chunk = KD.split_plan(b, kh, t, splits)
    assert chunk % KD.TILE == 0 and got_s * chunk >= t > (got_s - 1) * chunk
    got = KD.decode_attention_plain(q, k, v, n, splits=splits)
    want = TA.decode_attention(q, k, v, valid=_valid(n, t))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    one = KD.decode_attention_plain(q, k, v, n, splits=1)
    torch.testing.assert_close(got, one, rtol=1e-5, atol=1e-5)


def test_split_plan_fills_the_card_at_yi_9b_decode():
    """64 requests x 4 kv heads of 2,176 slots: three splits of 768 slots,
    768 blocks over the 132 SMs; a small cache is one split."""
    assert KD.split_plan(64, 4, 2176) == (3, 768)
    assert KD.split_plan(64, 4, 2176, 5) == (5, 448)
    assert KD.split_plan(1, 1, 40) == (1, 64)
    assert KD.split_plan(1, 1, 40, 8) == (1, 64)


def test_slots_past_the_length_contribute_nothing():
    """NaN in every slot at or past n[b] leaves the output as it was: the
    slots are read as zeros and weigh p = 0."""
    b, t, kh, g, d = 3, 150, 2, 8, 32
    q, k, v = (torch.from_numpy(x) for x in _case(5, b, t, kh, g, d))
    n = torch.tensor([1, 64, 149], dtype=torch.int32)
    want = KD.decode_attention_plain(q, k, v, n)
    k2, v2 = k.clone(), v.clone()
    for i, ni in enumerate(n.tolist()):
        k2[i, ni:] = float("nan")
        v2[i, ni:] = float("nan")
    got = ops.decode_attention(q, k2, v2, n)
    assert torch.equal(got, want)


def _layer(kind, window, t, dtype, device, seed=0):
    """Weights and a filled cache of one attention layer, 2 kv heads of
    G = 3, D = 16."""
    gen = torch.Generator().manual_seed(seed)
    dm, h, kh, d, b = 32, 6, 2, 16, 3
    p = TA.attn_init(gen, dm, h, kh, d, dtype=dtype, device="cpu")
    cache = {"k": torch.randn((b, t, kh, d), generator=gen).to(dtype),
             "v": torch.randn((b, t, kh, d), generator=gen).to(dtype)}
    x = torch.randn((b, 1, dm), generator=gen).to(dtype)
    mv = lambda a: a.to(device) if device.type != "meta" else \
        torch.empty_like(a, device=META)
    return ({k: mv(a) for k, a in p.items()}, mv(x),
            {k: mv(a) for k, a in cache.items()},
            dict(kind=kind, window=window, rope_theta=10000.0, n_kv_heads=kh,
                 mode="decode"))


@pytest.mark.parametrize("kind,window,t,pos", [
    ("global_attn", 0, 96, [0, 50, 95]),
    ("local_attn", 40, 40, [5, 39, 77])])          # a ring past its window
def test_layer_kernel_route_equals_the_plain_route(monkeypatch, kind,
                                                   window, t, pos):
    """The decode branch with the kernel's route forced on the CPU (its
    wrapper then runs the plain version) gives the plain route's output
    and cache: the valid prefix is pos + 1, of a ring min(pos + 1, t)."""
    p, x, cache, kw = _layer(kind, window, t, torch.float32,
                             torch.device("cpu"))
    lengths = torch.tensor(pos, dtype=torch.int32)
    c0 = {k: a.clone() for k, a in cache.items()}
    want, wc = TA.attention_layer(p, x, lengths=lengths, cache=c0, **kw)
    monkeypatch.setattr(TA, "_takes_decode_kernel", lambda *a: True)
    c1 = {k: a.clone() for k, a in cache.items()}
    got, gc = TA.attention_layer(p, x, lengths=lengths, cache=c1,
                                 use_kernel=True, **kw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for k in ("k", "v"):
        assert torch.equal(gc[k], wc[k])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_cache_keeps_decode_attention(monkeypatch, dtype):
    """A CPU cache with ``use_kernel`` set takes today's
    ``decode_attention`` and launches nothing: its numbers stay bit for
    bit those of the JAX comparisons."""
    calls = []
    plain = TA.decode_attention
    monkeypatch.setattr(TA, "decode_attention",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    monkeypatch.setattr(KD, "decode_attention", None)
    p, x, cache, kw = _layer("global_attn", 0, 64, dtype,
                             torch.device("cpu"))
    before = dict(LAUNCHES)
    y, _ = TA.attention_layer(p, x, lengths=torch.tensor([3, 9, 63]),
                              cache=cache, use_kernel=True, **kw)
    assert calls == [1] and y.dtype == dtype
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("kind,window", [("global_attn", 0),
                                         ("local_attn", 40)])
def test_meta_cache_takes_the_wrapper(kind, window):
    """On meta (the card's route) a bf16 cache with ``use_kernel`` records
    one ``decode_attention`` launch a layer at its cost; without the flag,
    in float32, under autograd and for cross-attention it keeps the plain
    route and records none."""
    def kernels(dtype, use_kernel, grad=False, override=False):
        p, x, cache, kw = _layer(kind, window, 64, dtype, META)
        if grad:
            x.requires_grad_(True)
        extra = dict(kv_override=(cache["k"], cache["v"])) if override \
            else dict(cache=cache)
        counter = opcount.Counter()
        with opcount.counting(counter):
            y, _ = TA.attention_layer(p, x, lengths=torch.zeros(
                3, dtype=torch.int32, device=META), use_kernel=use_kernel,
                **extra, **kw)
        assert y.shape == x.shape and y.device == META
        return counter.shards[None].kernels
    got = kernels(torch.bfloat16, True)
    q = torch.empty((3, 2, 3, 16), dtype=torch.bfloat16, device=META)
    c = KD.cost(q, torch.empty((3, 64, 2, 16), device=META))
    assert got == {"decode_attention": {"launches": 1, "flops": c.flops,
                                        "bytes": c.bytes}}
    assert kernels(torch.bfloat16, False) == {}
    assert kernels(torch.float32, True) == {}
    assert kernels(torch.bfloat16, True, grad=True) == {}
    assert kernels(torch.bfloat16, True, override=True) == {}


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    """The card's checks, on meta: dtype, n, head sizes, strides."""
    def m(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device=META)
    q, k, n = m(2, 2, 4, 64), m(2, 96, 2, 64), m(2, dtype=torch.int32)
    assert ops.decode_attention(q, k, k, n).shape == q.shape
    bad = [(q.float(), k.float(), k.float(), n),
           (q, k, k, n.long()),
           (m(2, 2, 17, 64), k, k, n),                     # G > 16
           (m(2, 2, 4, 12), m(2, 96, 2, 12), m(2, 96, 2, 12), n),
           (m(2, 2, 4, 264), m(2, 96, 2, 264), m(2, 96, 2, 264), n),
           (q, m(2, 2, 96, 64).transpose(1, 2), k, n),      # K, V strides
           (q, k, k, m(3, dtype=torch.int32)),              # n's length
           (m(2, 4, 2, 64).transpose(1, 2), k, k, n)]       # q strided
    for args in bad:
        with pytest.raises(ValueError):
            ops.decode_attention(*args)
