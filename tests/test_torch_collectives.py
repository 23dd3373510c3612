"""The port's runtime collectives (``repro_torch.distributed.collectives_rt``)
on the CPU, held to the JAX package's ``CollectiveGroup``: the same seeded
inputs through both, results bit-identical to each other and to the
port's single-threaded oracle (float32 addition is exact IEEE on both
sides and the schedule fixes the association), the cases of
``tests/test_collectives_rt.py``, a lossy link and an epoch-bump abort.

Each rank's runtime has two logical CPU devices; the small cutover and
chunk sizes of ``test_collectives_rt.py`` make 4999 elements a
multi-chunk ring and 17 a binomial tree.
"""
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.distributed as jdist
from repro_torch.core import RuntimeConfig
from repro_torch.distributed import (Cluster, CollectiveAborted,
                                     CollectiveGroup)

SIZES = dict(memory_capacity=1 << 26, coll_ring_cutover_bytes=1 << 12,
             eager_threshold=1 << 10, chunk_bytes=1 << 12)


def _cfg(**kw) -> RuntimeConfig:
    return RuntimeConfig(device="cpu", cpu_devices=2, **{**SIZES, **kw})


def _jcfg(**kw):
    return jcore.RuntimeConfig(**{**SIZES, **kw})


def _inputs(rng, n, size, dtype):
    if np.issubdtype(np.dtype(dtype), np.integer):
        return [rng.integers(-1000, 1000, size).astype(dtype)
                for _ in range(n)]
    return [rng.standard_normal(size).astype(dtype) for _ in range(n)]


def _same_shapes(g, jg):
    """Both groups froze the same leaders, rings and tree orders (a tree
    order is frozen at its first use, so this runs before any traffic
    refines the link estimates)."""
    assert g.describe() == jg.describe()
    for root in g.members:
        assert g._tree(root) == jg._tree(root)


def _assert_equal(outs, wants):
    assert len(outs) == len(wants)
    for out, want in zip(outs, wants):
        if want is None:
            assert out is None
            continue
        assert out.dtype == want.dtype and out.shape == want.shape
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("n_ranks", [2, 3, 4])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("size", [17, 4999])   # tree arm / multi-chunk ring
def test_allreduce_bit_exact_vs_oracle_and_jax(n_ranks, dtype, size):
    ins = _inputs(np.random.default_rng(n_ranks * 31 + size), n_ranks,
                  size, dtype)
    with Cluster(n_ranks, _cfg()) as c, \
            jdist.Cluster(n_ranks, _jcfg()) as jc:
        g, jg = CollectiveGroup(c), jdist.CollectiveGroup(jc)
        _same_shapes(g, jg)
        outs = g.allreduce([i.copy() for i in ins])
        oracle = g.oracle_allreduce(ins)
        jouts = jg.allreduce([i.copy() for i in ins])
        stats = [dict(r.stats) for r in c.ranks]
    _assert_equal(outs, oracle)
    _assert_equal(outs, [np.asarray(o) for o in jouts])
    assert all(s["coll_aborts"] == 0 for s in stats)
    assert sum(s["coll_bytes_reduced"] for s in stats) > 0


def test_allreduce_takes_tensors_and_averages():
    """CPU tensors are taken like numpy arrays; ``average`` divides the
    deterministic sum on the caller, as the JAX package does."""
    rng = np.random.default_rng(0)
    ins = _inputs(rng, 3, 2000, np.float32)
    with Cluster(3, _cfg()) as c:
        g = CollectiveGroup(c)
        outs = g.allreduce([torch.from_numpy(i.copy()) for i in ins],
                           average=True)
        with jdist.Cluster(3, _jcfg()) as jc:
            jouts = jdist.CollectiveGroup(jc).allreduce(ins, average=True)
    expect = np.sum([i.astype(np.float64) for i in ins], axis=0) / 3
    for out in outs:
        assert isinstance(out, np.ndarray)
        np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-6)
    _assert_equal(outs, [np.asarray(o) for o in jouts])


def test_reduce_broadcast_allgather_reduce_scatter_match_jax():
    rng = np.random.default_rng(1)
    with Cluster(3, _cfg()) as c, jdist.Cluster(3, _jcfg()) as jc:
        g, jg = CollectiveGroup(c), jdist.CollectiveGroup(jc)
        _same_shapes(g, jg)
        for size in (9, 4001):               # tree and ring arms
            ins = _inputs(rng, 3, size, np.float32)
            outs = g.reduce(ins, root=1)
            assert outs[0] is None and outs[2] is None
            np.testing.assert_array_equal(outs[1], g.oracle_reduce(ins, 1))
            np.testing.assert_array_equal(outs[1], jg.reduce(ins, root=1)[1])
        for size in (11, 6000):
            x = rng.standard_normal(size).astype(np.float32)
            for out in g.broadcast(x, root=2):
                np.testing.assert_array_equal(out, x)
        blocks = [rng.standard_normal(40 + 17 * i).astype(np.float32)
                  for i in range(3)]
        for out in g.allgather(blocks):
            np.testing.assert_array_equal(out, np.concatenate(blocks))
        ins = _inputs(rng, 3, 3001, np.float32)
        outs = g.reduce_scatter(ins)
        _assert_equal(outs, g.oracle_reduce_scatter(ins))
        _assert_equal(outs, [np.asarray(o) for o in jg.reduce_scatter(ins)])


def test_determinism_across_runs_and_clusters():
    rng = np.random.default_rng(2)
    ins = [rng.standard_normal(5000).astype(np.float32) for _ in range(3)]
    with Cluster(3, _cfg()) as c:
        g = CollectiveGroup(c)
        first = g.allreduce([i.copy() for i in ins])
        _assert_equal(g.allreduce([i.copy() for i in ins]), first)
    with Cluster(3, _cfg()) as c:
        _assert_equal(CollectiveGroup(c).allreduce(ins), first)


def test_hierarchical_nodes_match_oracle_and_jax():
    rng = np.random.default_rng(3)
    nodes = {0: "a", 1: "a", 2: "b", 3: "b"}
    with Cluster(4, _cfg()) as c, jdist.Cluster(4, _jcfg()) as jc:
        g = CollectiveGroup(c, nodes=nodes)
        jg = jdist.CollectiveGroup(jc, nodes=nodes)
        _same_shapes(g, jg)
        d = g.describe()
        assert d["leaders"] == [0, 2] and set(d["ring"]) == {0, 2}
        for size in (13, 5003):               # tree and hierarchical ring
            ins = _inputs(rng, 4, size, np.float32)
            outs = g.allreduce(ins)
            _assert_equal(outs, g.oracle_allreduce(ins))
            _assert_equal(outs, [np.asarray(o) for o in jg.allreduce(ins)])


def test_multidim_inputs_and_errors():
    rng = np.random.default_rng(4)
    with Cluster(2, _cfg()) as c:
        g = CollectiveGroup(c)
        ins = [rng.standard_normal((7, 11)).astype(np.float32)
               for _ in range(2)]
        outs = g.allreduce(ins)
        assert outs[0].shape == (7, 11)
        np.testing.assert_array_equal(outs[0], g.oracle_allreduce(ins)[0])
        with pytest.raises(ValueError):
            g.allreduce(ins[:1])                # wrong member count
        with pytest.raises(ValueError):
            g.allreduce([ins[0], ins[1].astype(np.float64)])
        with pytest.raises(ValueError):
            g.reduce(ins, root=9)               # root outside group


def test_allreduce_survives_link_drop():
    """A lossy link mid-collective: the reliability layer retransmits
    and the collective completes bit-exact — no hang, no corruption."""
    rng = np.random.default_rng(6)
    with Cluster(3, _cfg(retry_backoff_s=0.02, retry_tick_s=0.002)) as c:
        fi = c.fault_injector(seed=11)
        g = CollectiveGroup(c)
        ins = _inputs(rng, 3, 5000, np.float32)
        oracle = g.oracle_allreduce(ins)
        fi.set_link(0, 1, drop=0.3)
        result = {}
        t = threading.Thread(target=lambda: result.update(
            outs=g.allreduce(ins)))
        t.start()
        time.sleep(0.1)
        fi.clear_link(0, 1)             # let the repair cycle finish
        t.join(60)
        assert not t.is_alive(), "collective hung under link drop"
        _assert_equal(result["outs"], oracle)
        assert fi.stats["dropped"] >= 1
        assert sum(r.stats["coll_aborts"] for r in c.ranks) == 0


def test_epoch_bump_mid_collective_aborts_then_retries():
    """An epoch bump while a collective is stalled on dead links aborts it
    (``CollectiveAborted``, ``coll_aborts`` counted) and the same group
    re-runs bit-exact once the network heals."""
    rng = np.random.default_rng(7)
    with Cluster(3, _cfg(retry_backoff_s=0.02, retry_tick_s=0.002)) as c:
        fi = c.fault_injector(seed=13)
        epoch = [0]
        g = CollectiveGroup(c, epoch_fn=lambda: epoch[0])
        ins = _inputs(rng, 3, 5000, np.float32)
        oracle = g.oracle_allreduce(ins)
        for other in (0, 1):
            fi.set_link(other, 2, drop=1.0)
            fi.set_link(2, other, drop=1.0)
        err = {}

        def go():
            try:
                g.allreduce(ins)
            except CollectiveAborted as e:
                err["e"] = e

        t = threading.Thread(target=go)
        t.start()
        time.sleep(0.15)                # the ring is stuck mid-phase
        epoch[0] += 1
        t.join(30)
        assert not t.is_alive(), "abort did not release the caller"
        assert isinstance(err.get("e"), CollectiveAborted)
        assert sum(r.stats["coll_aborts"] for r in c.ranks) >= 1
        for other in (0, 1):
            fi.clear_link(other, 2)
            fi.clear_link(2, other)
        for r in c.ranks:
            r.reset_peer_state()
        _assert_equal(g.allreduce(ins), oracle)
