"""Parity of the port's gradient compression (``repro_torch.train.
compression``) and of ``spmd.all_gather`` with the JAX package's.

Held to ``test_quantize_roundtrip_error_bounded``'s oracle and to JAX's
functions bit for bit, not to ``test_compressed_training_tracks_exact``
(a JAX driver test that fails on this tree). The mesh form runs over a
4-shard CPU mesh of the port's single-controller SPMD.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.compression import \
    compressed_mean_stacked as jcompressed_mean_stacked
from repro.train.compression import \
    compressed_mean_stacked_tree as jcompressed_mean_stacked_tree
from repro.train.compression import dequantize_int8 as jdequantize_int8
from repro.train.compression import quantize_int8 as jquantize_int8
from repro_torch.convert import to_numpy, to_torch
from repro_torch.distributed import spmd
from repro_torch.train import compression as TC

SHAPES = [(7,), (3, 300), (2, 5, 129), (256,)]


def _x(shape, seed=3):
    return (3.0 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_roundtrip_matches_jax_bit_for_bit(shape):
    """``quantize_int8`` / ``dequantize_int8``: the int8 blocks, scales and
    round trip equal JAX's bit for bit (both round half to even), and the
    round trip's error stays within the JAX test's bound, max|x| / 127."""
    x = _x(shape)
    jq, js, jpad = jquantize_int8(jnp.asarray(x))
    q, s, pad = TC.quantize_int8(to_torch(x))
    assert pad == jpad and q.dtype == torch.int8
    np.testing.assert_array_equal(to_numpy(q), np.asarray(jq))
    np.testing.assert_array_equal(to_numpy(s), np.asarray(js))
    back = to_numpy(TC.dequantize_int8(q, s, x.shape, torch.float32))
    np.testing.assert_array_equal(
        back, np.asarray(jdequantize_int8(jq, js, x.shape, jnp.float32)))
    assert np.max(np.abs(back - x)) <= np.max(np.abs(x)) / 127.0 + 1e-6


def test_quantize_rounds_half_to_even():
    """Blocks whose scaled values land on .5 round to the even integer."""
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5], np.float32)
    q, s, _ = TC.quantize_int8(to_torch(x))
    assert float(s[0]) == 1.0
    assert to_numpy(q)[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("shape", [(4,), (4, 3, 300), (4, 2, 5, 129)])
def test_compressed_mean_stacked_matches_jax(shape):
    """The stacked form over 4 pods, mean and new residuals bit for bit
    JAX's, from a non-zero residual."""
    x, r = _x(shape, 5), 0.01 * _x(shape, 6)
    jm, jr = jcompressed_mean_stacked(jnp.asarray(x), jnp.asarray(r))
    m, nr = TC.compressed_mean_stacked(to_torch(x), to_torch(r))
    np.testing.assert_array_equal(to_numpy(m), np.asarray(jm))
    np.testing.assert_array_equal(to_numpy(nr), np.asarray(jr))


def test_compressed_mean_stacked_tree_matches_jax():
    grads = {"a": _x((4, 3, 300), 7), "b": {"c": _x((4, 9), 8)}}
    res = {"a": 0.01 * _x((4, 3, 300), 9), "b": {"c": np.zeros((4, 9),
                                                                np.float32)}}
    jm, jr = jcompressed_mean_stacked_tree(jax.tree.map(jnp.asarray, grads),
                                           jax.tree.map(jnp.asarray, res))
    tt = lambda t: {k: tt(v) if isinstance(v, dict) else to_torch(v)
                    for k, v in t.items()}
    m, nr = TC.compressed_mean_stacked_tree(tt(grads), tt(res))
    for got, want in ((m, jm), (nr, jr)):
        np.testing.assert_array_equal(to_numpy(got["a"]),
                                      np.asarray(want["a"]))
        np.testing.assert_array_equal(to_numpy(got["b"]["c"]),
                                      np.asarray(want["b"]["c"]))


def _mesh(n=4):
    return spmd.Mesh([torch.device("cpu")] * n, (n,), ("pod",))


@pytest.mark.parametrize("shape", [(3, 300), (2, 5, 129), ()])
def test_compressed_pmean_equals_stacked_form(shape):
    """``compressed_pmean`` over a 4-shard mesh axis, with and without a
    residual, against ``compressed_mean_stacked`` on the same per-shard
    values: the mean on every shard and each shard's new residual within
    1e-6 (the sums over shards run in one order in both)."""
    n = 4
    x = _x((n,) + shape, 11)
    r = 0.01 * _x((n,) + shape, 12)
    want_m, want_r = TC.compressed_mean_stacked(to_torch(x), to_torch(r))
    for res in (None, r):
        def body(xs, *rs):
            m, nr = TC.compressed_pmean(xs[0], "pod",
                                        rs[0][0] if rs else None)
            return m[None], nr[None]
        args = (to_torch(x),) + (() if res is None else (to_torch(res),))
        means, news = spmd.shard_map(
            body, _mesh(n), in_specs=(spmd.P("pod"),) * len(args),
            out_specs=(spmd.P("pod"), spmd.P("pod")))(*args)
        if res is None:
            wm, wr = TC.compressed_mean_stacked(to_torch(x),
                                                torch.zeros_like(to_torch(x)))
        else:
            wm, wr = want_m, want_r
        for m in means.shards:
            torch.testing.assert_close(m[0], wm, rtol=0, atol=1e-6)
        torch.testing.assert_close(news.full(), wr, rtol=0, atol=1e-6)


def test_all_gather_same_bits_on_every_shard():
    """``spmd.all_gather``: a leading axis over the named mesh axis in
    coordinate order, the same bits on every shard, over one axis of a
    2 x 2 mesh."""
    mesh = spmd.Mesh([torch.device("cpu")] * 4, (2, 2), ("pod", "data"))
    x = torch.randn(2, 2, 3, 5, generator=torch.Generator().manual_seed(1))

    def body(xs):
        return spmd.all_gather(xs[0, 0], "pod")[None, None]
    out = spmd.shard_map(body, mesh, in_specs=spmd.P("pod", "data"),
                         out_specs=spmd.P("pod", "data"))(x)
    for i, shard in enumerate(out.shards):
        d = mesh.coords(i)["data"]
        assert torch.equal(shard[0, 0], x[:, d])
    assert torch.equal(out.shards[0], out.shards[2])
