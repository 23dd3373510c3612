"""The port's elastic runtime (``repro_torch.distributed.elastic``) and
``run_cluster_elastic`` on the CPU: the controller's plans against the JAX
package's for the same owner map, detection and straggler drains on an
injected clock with inline ``poll()``, and the elastic Jacobi proxy under
every fault knob, each faulted run bit for bit the unfaulted one, which is
within the Jacobi tolerance (``rtol=1e-5, atol=1e-6``, that of
``tests/test_fault_tolerance.py``) of the JAX package's run.

Each rank's runtime has two logical CPU devices; the domain is the
24 x 16 x 16 float32 one of ``tests/test_fault_tolerance.py``.
"""
import tempfile
import time

import numpy as np
import pytest

import repro.apps.jacobi3d as japp
import repro.core as jcore
import repro.distributed as jdist
from repro_torch.apps.jacobi3d import run_cluster_elastic, run_reference
from repro_torch.core import RuntimeConfig
from repro_torch.distributed import (Cluster, ElasticController,
                                     ElasticRuntime, OwnerMap)

ITERS = 4
TOL = dict(rtol=1e-5, atol=1e-6)
# Heartbeats every 0.05 s and a straggler factor of 25 make a rank whose
# beats stop for 1.25 s a straggler. A killed rank must be declared dead
# before that (a timeout of 0.8 s), or it would first be drained, and its
# chunks could never land; a frozen one must not be (5 s), and its freeze
# (2.5 s) clears the factor by 2x. Natural gaps under load stay far below
# 0.8 s. The unfaulted runs take the freeze's timeout.
BEATS = dict(heartbeat_interval_s=0.05, straggler_factor=25.0)
KILL_TIMEOUT, FREEZE_S, FREEZE_TIMEOUT = 0.8, 2.5, 5.0


def _cfg(**kw) -> RuntimeConfig:
    return RuntimeConfig(device="cpu", cpu_devices=2,
                         memory_capacity=1 << 26, **kw)


def _owner(n_chunks: int, n_ranks: int, owner_cls=OwnerMap):
    owner = owner_cls()
    for oid in range(n_chunks):
        owner.assign(oid, oid % n_ranks)
    return owner


@pytest.fixture(scope="module")
def u0():
    return np.random.default_rng(42).standard_normal(
        (24, 16, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def unfaulted(u0):
    """The port's unfaulted run, which every faulted run must equal bit
    for bit."""
    with Cluster(3, _cfg()) as c:
        out, rep = run_cluster_elastic(u0, ITERS, c, **BEATS,
                                       heartbeat_timeout_s=FREEZE_TIMEOUT)
    assert rep["epochs"] == 0
    return out


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

def test_controller_runs_on_injected_clock():
    t = [100.0]
    ctrl = ElasticController([0, 1, 2], heartbeat_timeout=5.0,
                             clock=lambda: t[0])
    assert ctrl.detect_failures() == []
    t[0] += 4.9
    ctrl.heartbeat(1)
    assert ctrl.detect_failures() == []
    t[0] += 4.9
    assert sorted(ctrl.detect_failures()) == [0, 2]
    assert ctrl.alive_workers() == [1]
    ctrl.heartbeat(0)                   # a late heartbeat revives
    assert sorted(ctrl.alive_workers()) == [0, 1]
    ctrl.heartbeat(1, now=t[0] - 5.1)
    assert ctrl.detect_failures() == [1]


def test_plans_equal_the_jax_controllers():
    """Shrink, grow and straggler plans, and the owner maps they leave,
    are the JAX controller's for the same map and health."""
    port = ElasticController([0, 1, 2, 3], heartbeat_timeout=10.0)
    ref = jdist.ElasticController([0, 1, 2, 3], heartbeat_timeout=10.0)
    owner, jowner = _owner(11, 4), _owner(11, 4, jdist.OwnerMap)
    for ctrl in (port, ref):
        ctrl.health[3].alive = False
    plan = port.shrink_plan(owner, [3])
    assert plan == ref.shrink_plan(jowner, [3])
    assert {oid for oid, _, _ in plan} == {3, 7}
    assert dict(owner.items()) == dict(jowner.items())
    plan = port.grow_plan(owner, [3])
    assert plan and plan == ref.grow_plan(jowner, [3])
    assert all(dst == 3 for _, _, dst in plan)
    for ctrl in (port, ref):
        ctrl.heartbeat(1, slowdown=8.0)
    load = {oid: 1.0 + 0.25 * oid for oid in range(11)}
    plan = port.straggler_plan(owner, load)
    assert plan and plan == ref.straggler_plan(jowner, load)
    assert all(src == 1 for _, src, _ in plan)
    assert dict(owner.items()) == dict(jowner.items())
    assert port.effective_loads(owner, load) == \
        ref.effective_loads(jowner, load)


# ---------------------------------------------------------------------------
# the runtime on an injected clock, polled inline
# ---------------------------------------------------------------------------

def _chunks(c, n_chunks: int):
    owner, data = _owner(n_chunks, len(c.ranks)), {}
    for oid in range(n_chunks):
        data[oid] = np.full((32,), float(oid), np.float32)
        r = c.ranks[oid % len(c.ranks)]
        r.register_object(("chunk", oid), r.runtime.hetero_object(data[oid]))
    return owner, data


def _advance(er, t, dt, fresh):
    """Move the injected clock on by ``dt``, then wait until every rank in
    ``fresh`` has a heartbeat stamped at the new time."""
    t[0] += dt
    deadline = time.time() + 30
    while True:
        with er._beats_lock:
            got = {w for w, at in er._beats if at == t[0]}
        if fresh <= got:
            return
        assert time.time() < deadline, f"no fresh heartbeats from {fresh}"
        time.sleep(0.005)


def test_dead_rank_detected_and_chunks_restored_on_injected_clock():
    t = [0.0]
    with Cluster(3, _cfg()) as c:
        fi = c.fault_injector(seed=0)
        owner, data = _chunks(c, 6)
        er = ElasticRuntime(c, owner, key_fn=lambda o: ("chunk", o),
                            restore_fn=lambda o: data[o],
                            clock=lambda: t[0],
                            heartbeat_interval_s=0.02,
                            heartbeat_timeout_s=0.5)
        try:
            fi.kill_rank(2)
            _advance(er, t, 0.3, {0, 1})
            assert er.poll()["dead"] == []      # 0.3 s: within the timeout
            _advance(er, t, 0.3, {0, 1})
            assert er.poll()["dead"] == [2]     # 0.6 s without a beat
            for oid in (2, 5):
                new = owner.owner(oid)
                assert new != 2
                np.testing.assert_array_equal(
                    c.ranks[new].objects[("chunk", oid)].get(), data[oid])
            assert er.epoch == 1 and er.stats["recoveries"] == 1
            assert er.stats["bytes_migrated"] > 0
            assert er.stats["heartbeat_gap_max_s"] >= 0.6
            assert c.ranks[0].stats["heartbeats_missed"] >= 1
            # the rank comes back: its stale copies go, chunks move back
            fi.revive_rank(2)
            plan = er.grow([2])
            assert plan and all(dst == 2 for _, _, dst in plan)
            for oid, _, _ in plan:
                np.testing.assert_array_equal(
                    c.ranks[2].objects[("chunk", oid)].get(), data[oid])
            assert er.epoch == 2 and er.stats["grows"] == 1
        finally:
            er.close()
        assert c._elastic is None


def test_straggler_drained_on_injected_clock():
    """A rank whose heartbeats stop while it stays within the timeout is a
    straggler: half its chunks stream off it, nobody is declared dead."""
    t = [0.0]
    with Cluster(3, _cfg()) as c:
        owner, data = _chunks(c, 6)
        er = ElasticRuntime(c, owner, key_fn=lambda o: ("chunk", o),
                            clock=lambda: t[0], heartbeat_interval_s=0.02,
                            heartbeat_timeout_s=5.0, straggler_factor=25.0)
        try:
            c.ranks[1]._hb_dst = None           # rank 1 falls silent
            _advance(er, t, 2 * 25 * 0.02, {0, 2})
            events = er.poll()
            assert events["dead"] == [] and events["drained"]
            (w, moved), = events["drained"]
            assert w == 1 and len(moved) == 1   # half of its 2 chunks
            oid, src, dst = moved[0]
            assert src == 1 and owner.owner(oid) == dst
            np.testing.assert_array_equal(
                c.ranks[dst].objects[("chunk", oid)].get(), data[oid])
            assert ("chunk", oid) not in c.ranks[1].objects
            assert er.stats["straggler_signals"][1]["gap_ratio"] >= 50.0
            assert er.epoch == 1
        finally:
            er.close()


def test_recovery_without_a_copy_leaves_the_world_as_it_was():
    """A live rank whose heartbeats starve past the timeout before any
    copy of its chunk exists (under load, before ``run_cluster_elastic``'s
    first replica): the recovery raises, and the owner map, the health
    and the epoch stay as they were. The monitor thread swallows that
    error, so a commit against the owner map under the unchanged epoch
    must still find every chunk at its owner (it found none, a KeyError,
    when the failed recovery had already remapped the chunk). Once a copy
    exists the next poll recovers from it."""
    t = [0.0]
    with Cluster(3, _cfg()) as c:
        owner, data = _chunks(c, 3)
        er = ElasticRuntime(c, owner, key_fn=lambda o: ("chunk", o),
                            clock=lambda: t[0], heartbeat_interval_s=0.02,
                            heartbeat_timeout_s=0.5)
        try:
            before = dict(owner.items())
            c.ranks[2]._hb_dst = None           # rank 2 falls silent
            _advance(er, t, 0.6, {0, 1})
            with pytest.raises(RuntimeError, match="chunk 2 lost"):
                er.poll()
            assert dict(owner.items()) == before and er.epoch == 0
            assert sorted(er.controller.alive_workers()) == [0, 1, 2]
            for oid, r in before.items():
                assert ("chunk", oid) in c.ranks[r].objects
            # a replica of chunk 2 on rank 1: the same detection recovers
            c.ranks[1].register_object(
                ("chunk", 2), c.ranks[1].runtime.hetero_object(data[2]))
            assert er.poll()["dead"] == [2]
            assert er.epoch == 1 and owner.owner(2) != 2
            np.testing.assert_array_equal(
                c.ranks[owner.owner(2)].objects[("chunk", 2)].get(), data[2])
        finally:
            er.close()


# ---------------------------------------------------------------------------
# run_cluster_elastic
# ---------------------------------------------------------------------------

def test_unfaulted_run_matches_jax_and_reference(u0, unfaulted):
    with jdist.Cluster(3, jcore.RuntimeConfig(memory_capacity=1 << 26)) as jc:
        want, jrep = japp.run_cluster_elastic(
            u0, ITERS, jc, **BEATS, heartbeat_timeout_s=FREEZE_TIMEOUT)
    assert jrep["epochs"] == 0
    np.testing.assert_allclose(unfaulted, want, **TOL)
    np.testing.assert_array_equal(
        unfaulted, run_reference(u0, ITERS, device="cpu"))


# (fault knobs, RuntimeConfig overrides): each run equals the unfaulted one
# bit for bit. The corrupt-link case shrinks the eager threshold so slabs
# travel host-staged in chunks, the wire path a flip can reach.
FAULTS = {
    "kill_revive_ckpt": (dict(kill=(2, 1), revive_at=(2, 2), ckpt=True), {}),
    "kill_replicate": (dict(kill=(1, 1), replicate=True), {}),
    "corrupt_links": (dict(replicate=True, corrupt_links=0.15),
                      dict(eager_threshold=2 << 10, chunk_bytes=4 << 10)),
    "corrupt_leaf_replica": (dict(kill=(2, 1), revive_at=(2, 2),
                                  replicate=True, ckpt=True,
                                  corrupt_leaf_at=(1, "slab2")), {}),
    "freeze": (dict(slabs=6, freeze=(1, 1, FREEZE_S),
                    heartbeat_timeout_s=FREEZE_TIMEOUT), {}),
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_faulted_runs_equal_the_unfaulted_run(u0, unfaulted, case):
    knobs, cfg = FAULTS[case]
    knobs = dict(knobs)
    with tempfile.TemporaryDirectory() as d:
        if knobs.pop("ckpt", False):
            knobs["ckpt_dir"] = d
        knobs.setdefault("heartbeat_timeout_s", KILL_TIMEOUT)
        with Cluster(3, _cfg(retry_backoff_s=0.02, retry_tick_s=0.002,
                             **cfg)) as c:
            c.fault_injector(seed=17)
            out, rep = run_cluster_elastic(u0, ITERS, c, **BEATS, **knobs)
    assert np.array_equal(out, unfaulted), case
    e, faults, ig = rep["elastic"], rep["faults"], rep["integrity"]
    assert set(rep) >= {"elastic", "monitor_stats", "faults", "integrity",
                        "collectives", "epochs"}
    if "kill" in knobs:
        assert e["recoveries"] == 1 and e["dead"] == [knobs["kill"][0]]
        assert e["bytes_migrated"] > 0 and faults["kills"] == 1
        assert rep["monitor_stats"]["recovery_stall_s"] > 0
    if "revive_at" in knobs:
        assert e["grows"] >= 1
    if "ckpt_dir" in knobs:
        assert rep["checkpoint"]["saves"] == ITERS
    if case == "corrupt_links":
        assert ig["checksum_fail"] + ig["chunks_rejected"] >= 1
        assert ig["retries"] >= 1 and faults["corrupted"] >= 1
    if case == "corrupt_leaf_replica":
        # the replica serves the lost slab: the bad leaf is never read
        assert faults["ckpt_corrupted"] == 1 and ig["ckpt_verify_fail"] == 0
    if case == "freeze":
        # frozen is not dead: the heartbeat gap drove the drain
        assert e["drains"] >= 1 and 1 in e["stragglers"]
        assert e["dead"] == [] and e["chunks_migrated"] >= 1
        assert e["straggler_signals"][1]["gap_ratio"] >= 25.0


def test_corrupt_leaf_without_replica_falls_back_like_jax(u0):
    """With no replica the restore meets the flipped leaf, rejects it and
    falls back to the step before, as the JAX package does: the run then
    finishes on those older bytes, within tolerance of JAX's run of the
    same schedule."""
    knobs = dict(kill=(2, 2), corrupt_leaf_at=(2, "slab2"), **BEATS,
                 heartbeat_timeout_s=KILL_TIMEOUT)
    with tempfile.TemporaryDirectory() as d:
        with Cluster(3, _cfg()) as c:
            c.fault_injector(seed=1)
            out, rep = run_cluster_elastic(u0, ITERS, c, ckpt_dir=d, **knobs)
    with tempfile.TemporaryDirectory() as d:
        with jdist.Cluster(3, jcore.RuntimeConfig(
                memory_capacity=1 << 26)) as jc:
            jc.fault_injector(seed=1)
            want, jrep = japp.run_cluster_elastic(u0, ITERS, jc, ckpt_dir=d,
                                                  **knobs)
    assert rep["integrity"]["ckpt_verify_fail"] >= 1
    assert rep["faults"]["ckpt_corrupted"] == 1
    assert rep["elastic"]["recoveries"] == 1
    assert rep["integrity"]["ckpt_verify_fail"] == \
        jrep["integrity"]["ckpt_verify_fail"]
    np.testing.assert_allclose(out, want, **TOL)
    assert not np.array_equal(out, run_reference(u0, ITERS, device="cpu"))


def test_kill_needs_a_checkpoint_or_replicas(u0):
    with Cluster(2, _cfg()) as c:
        with pytest.raises(ValueError, match="ckpt_dir or replicate"):
            run_cluster_elastic(u0, 1, c, kill=(1, 0))
        with pytest.raises(ValueError, match="needs ckpt_dir"):
            run_cluster_elastic(u0, 1, c, corrupt_leaf_at=(0, "slab0"))
