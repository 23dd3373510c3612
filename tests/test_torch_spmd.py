"""Parity of the port's SPMD path (``repro_torch.distributed.spmd``, its
``collectives``, ``launch.mesh``, ``models.sharding`` and
``apps.jacobi3d.run_spmd``) with the JAX package's.

The JAX side runs in-process on the two host devices ``conftest.py`` pins;
the port's shards run on the CPU (``make_smoke_mesh(n, 1, devices=[cpu] *
n)``), where the JAX package's tests force host devices. The port alone
also runs at 3 and 4 shards against numpy oracles.
"""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as PS

from repro.apps.jacobi3d import run_spmd as jrun_spmd
from repro.distributed import collectives as JC
from repro.models import sharding as JS
from repro_torch.apps.jacobi3d import run_reference, run_spmd
from repro_torch.distributed import collectives as TC
from repro_torch.distributed import spmd
from repro_torch.distributed.spmd import P
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import sharding as TS

CPU = torch.device("cpu")


def _jmesh(data=2, model=1):
    # Auto axes (jax.make_mesh gives Explicit ones, which the JAX package's
    # sharding constraints reject)
    devs = np.array(jax.devices()[:data * model]).reshape(data, model)
    return JMesh(devs, ("data", "model"))


def _tmesh(data, model=1):
    return make_smoke_mesh(data, model, devices=[CPU] * (data * model))


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal((2 * n, 3)).astype(
        np.float32)


def _jax_run(body, x, n_out=1):
    specs = PS("data") if n_out == 1 else (PS("data"),) * n_out
    out = jax.jit(jax.shard_map(body, mesh=_jmesh(), in_specs=PS("data"),
                                out_specs=specs))(jnp.asarray(x))
    return [np.asarray(o) for o in (out if n_out > 1 else (out,))]


def _port_run(body, x, n, n_out=1):
    specs = P("data") if n_out == 1 else (P("data"),) * n_out
    out = spmd.shard_map(body, _tmesh(n), in_specs=P("data"),
                         out_specs=specs)(torch.from_numpy(x))
    return [o.full().numpy() for o in (out if n_out > 1 else (out,))]


# the patterns, each with its numpy oracle over the blocks of x (2 rows a
# shard)
def _blocks(x, n):
    return [x[2 * i:2 * i + 2] for i in range(n)]


def _lax(m):
    """The SPMD primitives beside a collectives module: ``jax.lax`` with
    the JAX package's, ``spmd`` with the port's."""
    return jax.lax if m is JC else spmd


def _all_to_all(m):
    """Each shard stacks n scaled copies of its block (chunk j is the block
    times j + 1) and exchanges them: shard i receives chunk i of every
    shard, in the senders' order."""
    xp = jnp if m is JC else torch

    def body(a):
        n = _lax(m).axis_size("data")
        chunks = xp.stack([a * (j + 1) for j in range(n)])
        out = _lax(m).all_to_all(chunks.reshape(2 * n, 3), "data", 0, 0,
                                 tiled=True)
        return out
    return body


def _mean(b, n):
    acc = b[0]
    for blk in b[1:]:
        acc = acc + blk
    return acc / n


CASES = {
    "ring+1": (lambda m: lambda a: m.ring_permute(a, "data", 1), 1,
               lambda b, n: [np.concatenate([b[(i - 1) % n] for i in
                                             range(n)])]),
    "ring-1": (lambda m: lambda a: m.ring_permute(a, "data", -1), 1,
               lambda b, n: [np.concatenate([b[(i + 1) % n] for i in
                                             range(n)])]),
    "halo": (lambda m: lambda a: m.halo_exchange_1d(a, "data"), 2,
             lambda b, n: [
                 np.concatenate([np.zeros_like(b[0][-1:]) if i == 0 else
                                 b[i - 1][-1:] for i in range(n)]),
                 np.concatenate([np.zeros_like(b[0][:1]) if i == n - 1 else
                                 b[i + 1][:1] for i in range(n)])]),
    "halo_wrap": (lambda m: lambda a: m.halo_exchange_1d(a, "data",
                                                         wrap=True), 2,
                  lambda b, n: [
                      np.concatenate([b[(i - 1) % n][-1:] for i in range(n)]),
                      np.concatenate([b[(i + 1) % n][:1] for i in range(n)])]),
    "put": (lambda m: lambda a: m.spmd_put(a, "data", 1, 0), 1,
            lambda b, n: [np.concatenate([b[1]] + b[1:])]),
    "get": (lambda m: lambda a: m.spmd_get(a, "data", 1), 1,
            lambda b, n: [np.concatenate([b[1]] * n)]),
    "all_to_all": (_all_to_all, 1,
                   lambda b, n: [np.concatenate([b[j] * (i + 1)
                                                 for i in range(n)
                                                 for j in range(n)])]),
    "pmean": (lambda m: lambda a: _lax(m).pmean(a, "data"), 1,
              lambda b, n: [np.concatenate([_mean(b, n)] * n)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_matches_jax(case):
    make, n_out, _ = CASES[case]
    x = _x(2, seed=len(case))
    want = _jax_run(make(JC), x, n_out)
    got = _port_run(make(TC), x, 2, n_out)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [3, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_collective_matches_numpy_oracle(case, n):
    make, n_out, oracle = CASES[case]
    x = _x(n, seed=n)
    got = _port_run(make(TC), x, n, n_out)
    for g, w in zip(got, oracle(_blocks(x, n), n)):
        np.testing.assert_array_equal(g, w)


def test_psum_and_pmax_agree_on_every_shard():
    """Folded in coordinate order on every shard: the replicas of the
    result are equal bit for bit, and equal a fold in that order."""
    n = 4
    x = np.random.default_rng(3).standard_normal((n, 5)).astype(np.float32)

    def body(a):
        return spmd.psum(a, "data"), spmd.pmax(a, "data")

    s, m = spmd.shard_map(body, _tmesh(n), in_specs=P("data"),
                          out_specs=(P("data"), P("data")))(
        torch.from_numpy(x))
    want_s = x[0].copy()
    for row in x[1:]:
        want_s = want_s + row
    np.testing.assert_array_equal(s.full().numpy(), np.stack([want_s] * n))
    np.testing.assert_array_equal(m.full().numpy(),
                                  np.stack([x.max(axis=0)] * n))


@pytest.mark.parametrize("bulk_sync", [False, True])
def test_run_spmd_matches_jax(bulk_sync):
    u0 = np.random.default_rng(0).random((16, 8, 8)).astype(np.float32)
    want = jrun_spmd(u0, 3, _jmesh(), axis="data", bulk_sync=bulk_sync)
    got = run_spmd(u0, 3, _tmesh(2), axis="data", bulk_sync=bulk_sync)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bulk_sync", [False, True])
def test_run_spmd_equals_run_reference(n, bulk_sync):
    u0 = np.random.default_rng(n).random((16, 8, 6)).astype(np.float32)
    got = run_spmd(u0, 4, _tmesh(n), bulk_sync=bulk_sync)
    np.testing.assert_array_equal(got, run_reference(u0, 4, device="cpu"))


RESOLVE_CASES = [
    (("embed", "heads", "head_dim"), (64, 4, 16), None),
    (("embed", "kv_heads", "head_dim"), (64, 1, 16), None),   # kv_heads=1
    (("embed", "kv_heads", "head_dim"), (64, 2, 16), None),
    (("vocab", "embed"), (256, 64), None),
    (("act_batch", "act_seq", "act_embed"), (4, 32, 64), None),
    (("act_batch", "act_seq", "act_embed"), (4, 32, 64),
     {"act_seq": "model"}),
    (("act_batch", "act_kv_seq", "kv_heads", "head_dim"), (2, 64, 2, 16),
     {"act_kv_seq": "data"}),
    (("layers", "embed", "mlp"), (3, 64, 128), None),
]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("axes,dims,rules", RESOLVE_CASES)
def test_resolve_spec_matches_jax(axes, dims, rules, shape):
    jm, tm = _jmesh(*shape), _tmesh(*shape)
    with JS.use_sharding(jm, rules), TS.use_sharding(tm, rules):
        assert TS.active_mesh() is tm
        for kw in ({}, {"shape": dims}):
            want = tuple(JS.resolve_spec(axes, **kw))
            got = TS.resolve_spec(axes, **kw)
            assert isinstance(got, tuple) and tuple(got) == want, (kw, got)
    assert TS.active_mesh() is None
    assert tuple(TS.resolve_spec(axes, mesh=tm)) == \
        tuple(JS.resolve_spec(axes, mesh=jm))
    assert TS.resolve_spec(axes) == P()           # no mesh: replicated


def test_sharded_values_round_trip_on_a_2d_mesh():
    mesh = _tmesh(2, 2)
    x = torch.arange(4 * 6 * 3, dtype=torch.float32).reshape(4, 6, 3)
    for spec in (P("data"), P(None, "model"), P("data", "model"),
                 P(("data", "model")), P()):
        sh = spmd.device_put(x, mesh, spec)
        assert torch.equal(sh.full(), x), spec
    # each shard sees its block; coordinates and sizes by axis
    seen = spmd.shard_map(
        lambda a: a + 0 * spmd.axis_index("model")
        + 100 * spmd.axis_size("data"), mesh,
        in_specs=P("data", "model"), out_specs=P("data", "model"))(x)
    assert torch.equal(seen.full(), x + 200)
    # an output replicated along model is taken from model coordinate 0
    rep = spmd.shard_map(lambda a: a * 0 + spmd.axis_index("model"), mesh,
                         in_specs=P("data"), out_specs=P("data"))(x)
    assert torch.equal(rep.full(), torch.zeros_like(x))


def test_all_to_all_and_pmean_on_a_2d_mesh():
    """On a (2, 2) mesh: ``pmean`` over both axes is the mean over the four
    shards, the same bits on each (a fold over data, then model, then the
    division); ``all_to_all`` over model, split along dim 1 and joined
    along dim 0, exchanges only among the shards that share a data
    coordinate; the untiled form and a split that does not divide
    raise."""
    mesh = _tmesh(2, 2)
    x = np.random.default_rng(7).standard_normal((4, 8)).astype(np.float32)
    b = [[x[2 * d:2 * d + 2, 4 * m:4 * m + 4] for m in range(2)]
         for d in range(2)]
    spec = P("data", "model")
    mean = spmd.shard_map(lambda a: spmd.pmean(a, ("data", "model")), mesh,
                          in_specs=spec, out_specs=spec)(torch.from_numpy(x))
    want = ((b[0][0] + b[1][0]) + (b[0][1] + b[1][1])) / 4
    np.testing.assert_array_equal(mean.full().numpy(), np.tile(want, (2, 2)))
    got = spmd.shard_map(
        lambda a: spmd.all_to_all(a, "model", 1, 0, tiled=True), mesh,
        in_specs=spec, out_specs=spec)(torch.from_numpy(x))
    want = np.block([[np.concatenate([b[d][0][:, 2 * m:2 * m + 2],
                                      b[d][1][:, 2 * m:2 * m + 2]])
                      for m in range(2)] for d in range(2)])
    np.testing.assert_array_equal(got.full().numpy(), want)
    for bad in (lambda a: spmd.all_to_all(a, "model", 0, 0),
                lambda a: spmd.all_to_all(a[:1], "model", 0, 0,
                                          tiled=True)):
        with pytest.raises((NotImplementedError, ValueError)):
            spmd.shard_map(bad, mesh, in_specs=spec, out_specs=spec)(
                torch.from_numpy(x))


def test_spmd_misuse_raises():
    with pytest.raises(NameError):
        spmd.axis_index("data")
    mesh = _tmesh(2)
    with pytest.raises(NameError):
        spmd.shard_map(lambda a: spmd.axis_index("model_x") + a, mesh,
                       P("data"), P("data"))(torch.zeros(2))
    with pytest.raises(ValueError):
        spmd.device_put(torch.zeros(3), mesh, P("data"))    # 3 % 2
    with pytest.raises(ValueError):
        spmd.Mesh([CPU] * 3, (2, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="cards"):
        if not torch.cuda.is_available():
            make_smoke_mesh(2, 1)
        else:
            make_smoke_mesh(torch.cuda.device_count() + 1, 1)


def test_a_failing_shard_fails_the_call_and_frees_its_peers():
    """One shard raises before a collective its peers wait at: the call
    raises that error instead of hanging."""
    def body(a):
        if spmd.axis_index("data") == 1:
            raise ZeroDivisionError("shard 1")
        return spmd.psum(a, "data")

    done = []

    def call():
        with pytest.raises(ZeroDivisionError, match="shard 1"):
            spmd.shard_map(body, _tmesh(4), P("data"), P("data"))(
                torch.zeros(4))
        done.append(True)

    t = threading.Thread(target=call)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and done


def test_a_shard_skipping_a_collective_fails_the_call():
    """One shard returns without a collective its peers make (the shards
    take turns between collectives): the call raises at once instead of
    reading a stale post or waiting out the timeout."""
    def body(a):
        if spmd.axis_index("data") == 2:
            return a
        return spmd.psum(a, "data")

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="skipped a collective"):
        spmd.shard_map(body, _tmesh(4), P("data"), P("data"))(torch.ones(4))
    assert time.perf_counter() - t0 < 30


def test_collectives_under_thread_switching_stress():
    """More shards than cores and a short switch interval: 16 shards
    through 50 rounds of ring permutes and sums keep their invariant (the
    sum of the shards is preserved by a permute, and every shard sees the
    same psum)."""
    n, rounds = 16, 50
    x = np.random.default_rng(7).integers(0, 100, (n, 3)).astype(np.int64)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(a):
            total = spmd.psum(a, "data")
            for r in range(rounds):
                a = TC.ring_permute(a, "data", 1 + r % 3)
                assert torch.equal(spmd.psum(a, "data"), total)
            return a

        out = spmd.shard_map(body, _tmesh(n), P("data"), P("data"))(
            torch.from_numpy(x))
    finally:
        sys.setswitchinterval(interval)
    shift = sum(1 + r % 3 for r in range(rounds))
    np.testing.assert_array_equal(out.full().numpy(),
                                  np.roll(x, shift, axis=0))


def test_all_to_all_under_thread_switching_stress():
    """16 shards, a short switch interval, 30 rounds: an ``all_to_all``
    over split and concat dim 0 is a block transpose, so two in a row give
    every shard its block back, and ``pmean`` gives every shard the same
    bits."""
    n, rounds = 16, 30
    x = np.random.default_rng(8).standard_normal((n * n, 3)).astype(
        np.float32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(a):
            start, mean = a, spmd.pmean(a, "data")
            for _ in range(rounds):
                a = spmd.all_to_all(a, "data", 0, 0, tiled=True)
                a = spmd.all_to_all(a, "data", 0, 0, tiled=True)
                assert torch.equal(a, start)
                assert torch.equal(spmd.pmean(a, "data"), mean)
            return mean

        out = spmd.shard_map(body, _tmesh(n), P("data"), P("data"))(
            torch.from_numpy(x))
    finally:
        sys.setswitchinterval(interval)
    means = out.full().numpy().reshape(n, n, 3)
    assert (means == means[:1]).all()


def test_host_round_trip_keeps_the_value():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    y = TC.host_round_trip(x)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(JC.host_round_trip(jnp.asarray(x.numpy()))))


def test_shard_map_calls_from_several_threads_take_turns():
    """Four caller threads share one mesh, each through 20 calls of a body
    with collectives: no call waits at another's collective, and every
    result is its own."""
    mesh = _tmesh(3)
    f = spmd.shard_map(lambda a: TC.ring_permute(spmd.psum(a, "data"),
                                                 "data"),
                       mesh, P("data"), P("data"))
    bad = []

    def caller(k):
        x = torch.full((3,), float(k))
        for _ in range(20):
            if not torch.equal(f(x).full(), torch.full((3,), 3.0 * k)):
                bad.append(k)

    threads = [threading.Thread(target=caller, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not bad
