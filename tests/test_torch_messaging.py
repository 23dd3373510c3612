"""The port's message engine (``repro_torch.distributed``) on the CPU: the
protocol cases of ``tests/test_msg_protocol.py`` and
``tests/test_distributed.py`` that need no collectives or elasticity, the
same sends through both packages making the same protocol decisions and
counters, and the mobile-object helpers against the JAX package's.

Each rank's runtime has two logical CPU devices
(``RuntimeConfig(device="cpu", cpu_devices=2)``), so the DIRECT and
consumer-routed paths run; payloads are seeded numpy arrays and must
arrive bit for bit.
"""
import threading
import time

import numpy as np
import pytest

import repro.core as jcore
import repro.distributed as jdist
from repro_torch.core import RuntimeConfig, sanitizer
from repro_torch.distributed import (Cluster, OwnerMap, block_distribution,
                                     handler, rebalance_greedy)

_lock = threading.Lock()
_received = {}


@handler(name="tproto_recv")
def _recv(ctx, obj):
    with _lock:
        _received["obj"] = obj
        _received["data"] = None if obj is None else obj.get()
        _received[ctx.message.src] = _received["data"]


@handler(name="tproto_done")
def _done(ctx, obj):
    with _lock:
        _received["done"] = True


@handler(name="tproto_pong")
def _pong(ctx, obj):
    ctx.send(ctx.message.src, "tproto_recv", obj)


@handler(name="tproto_boom")
def _boom(ctx, obj):
    raise ValueError("handler exploded")


def _wait_for(key, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with _lock:
            if key in _received:
                return True
        time.sleep(0.005)
    return False


def _cfg(**kw) -> RuntimeConfig:
    kw.setdefault("memory_capacity", 1 << 28)
    return RuntimeConfig(device="cpu", cpu_devices=2, **kw)


@pytest.fixture()
def cluster():
    with Cluster(2, _cfg(eager_threshold=64 << 10,
                         chunk_bytes=128 << 10)) as c:
        with _lock:
            _received.clear()
        yield c


def _send_and_check(cluster, data, **kw):
    obj = cluster.ranks[0].runtime.hetero_object(data.copy())
    cluster.ranks[0].send(1, "tproto_recv", obj, **kw)
    assert _wait_for("data")
    np.testing.assert_array_equal(_received["data"], data)
    return cluster.ranks[0].stats, cluster.ranks[1].stats


# ---------------------------------------------------------------------------
# protocol selection and reassembly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,eager,chunks", [
    (1024, True, 0),                 # 4 KB ≤ threshold
    ((64 << 10) // 4, True, 0),      # exactly the threshold: inclusive
    (1 << 17, False, 4),             # 512 KB = 4 chunks of 128 KB
    ((300 << 10) // 4, False, 3),    # two full chunks + a 44 KB tail
    (8, True, 0),                    # 32 bytes: inline in the metadata
])
def test_protocol_selection_and_reassembly(cluster, n, eager, chunks):
    data = np.arange(n, dtype=np.float32)
    s0, s1 = _send_and_check(cluster, data)
    assert (s0["eager"], s0["rendezvous"]) == \
        ((1, 0) if eager else (0, 1))
    assert s0["chunks_out"] == chunks and s1["chunks_in"] == chunks


def test_chunked_reassembly_bit_exact_2d(cluster):
    data = np.random.default_rng(7).random((384, 384)).astype(np.float32)
    _send_and_check(cluster, data)
    # the landed object is device-resident (a slab on the landing device)
    assert _received["obj"].resident_devices()


class _ReorderingCluster(Cluster):
    """Delivers each rendezvous stream's chunks in REVERSE order."""

    def deliver(self, msg):
        if msg.kind == "chunk":
            held = self._held.setdefault(msg.msg_id, [])
            held.append(msg)
            if len(held) == msg.nchunks:
                for m in reversed(held):
                    super().deliver(m)
                del self._held[msg.msg_id]
            return
        super().deliver(msg)


def test_out_of_order_chunk_arrival_reassembles():
    # net_window=4 opens the whole stream's window up front
    c = _ReorderingCluster.__new__(_ReorderingCluster)
    c._held = {}
    Cluster.__init__(c, 2, _cfg(eager_threshold=64 << 10,
                                chunk_bytes=128 << 10, net_window=4))
    try:
        with _lock:
            _received.clear()
        data = np.arange(1 << 17, dtype=np.float32)
        _, s1 = _send_and_check(c, data)
        assert s1["chunks_in"] == 4
    finally:
        c.shutdown()


def test_cluster_barrier_covers_whole_rendezvous(cluster):
    for trial in range(20):
        with _lock:
            _received.clear()
        data = np.arange((256 << 10) // 4, dtype=np.float32) + trial
        obj = cluster.ranks[0].runtime.hetero_object(data)
        cluster.ranks[0].send(1, "tproto_recv", obj)
        cluster.barrier()
        with _lock:
            assert "data" in _received, f"trial {trial}: barrier early"
            np.testing.assert_array_equal(_received["data"], data)


def test_handler_invocation_no_payload(cluster):
    cluster.ranks[0].send(1, "tproto_recv")
    assert _wait_for(0)
    assert _received[0] is None


def test_payload_roundtrip_through_a_handler_reply(cluster):
    data = np.arange(4096, dtype=np.float32).reshape(64, 64)
    obj = cluster.ranks[0].runtime.hetero_object(data)
    cluster.ranks[0].send(1, "tproto_pong", obj)
    assert _wait_for(1)
    np.testing.assert_array_equal(_received[1], data)


# ---------------------------------------------------------------------------
# DIRECT payloads and consumer routing
# ---------------------------------------------------------------------------

def _device_resident(rt, data, fn=lambda v: v + 1.0):
    obj = rt.hetero_object(data)
    rt.run(fn, [(obj, "rw")])           # leaves a device-only copy
    rt.barrier()
    return obj


@pytest.mark.parametrize("n", [4096, 1 << 17])   # eager, rendezvous
def test_direct_payload_no_host_staging(cluster, n):
    data = np.arange(n, dtype=np.float32)
    obj = _device_resident(cluster.ranks[0].runtime, data)
    cluster.ranks[0].send(1, "tproto_recv", obj, path="direct",
                          consumer_device=1)
    assert _wait_for("data")
    np.testing.assert_array_equal(_received["data"], data + 1.0)
    assert _received["obj"].resident_devices() == {1}
    assert cluster.ranks[0].stats["bytes_d2d"] >= data.nbytes
    assert cluster.ranks[1].stats["bytes_d2d"] >= data.nbytes
    assert cluster.ranks[0].stats["bytes_staged"] == 0
    assert cluster.ranks[1].stats["bytes_staged"] == 0


def test_direct_send_survives_subsequent_donating_writer(cluster):
    """A DIRECT send snapshots the device copy: a writer task submitted
    right after it — one that writes the object's tensor in place — must
    not change the message in flight."""
    data = np.arange(4096, dtype=np.float32).reshape(64, 64)
    rt0 = cluster.ranks[0].runtime

    def zero_in_place(v):
        return v.mul_(0.0)

    for trial in range(5):
        with _lock:
            _received.pop(0, None)
        obj = _device_resident(rt0, data.copy())
        cluster.ranks[0].send(1, "tproto_recv", obj, path="direct")
        rt0.run(zero_in_place, [(obj, "rw")])
        rt0.barrier()
        assert _wait_for(0), f"trial {trial}: lost"
        np.testing.assert_array_equal(_received[0], data + 1.0,
                                      err_msg=f"trial {trial}")
        np.testing.assert_array_equal(obj.get(), 0.0)


@pytest.mark.parametrize("how", ["hint", "route", "bad_hint_then_route",
                                 "least_loaded"])
def test_direct_payload_landing_device(cluster, how):
    r0, r1 = cluster.ranks
    if how in ("route", "bad_hint_then_route"):
        r1.route_to("tproto_recv", 1)
    if how == "least_loaded":
        ballast = r1.runtime.hetero_object(np.ones((128, 128), np.float32))
        r1.runtime._ensure_on_device(ballast, 0, will_write=False)
    hint = {"hint": 1, "bad_hint_then_route": 99}.get(how)
    data = np.full((64, 64), 3.0, np.float32)
    obj = _device_resident(r0.runtime, data)
    r0.send(1, "tproto_recv", obj, path="direct", consumer_device=hint)
    assert _wait_for("obj")
    assert _received["obj"].resident_devices() == {1}
    np.testing.assert_array_equal(_received["data"], data + 1.0)


def test_direct_path_host_only_falls_back_to_staged(cluster):
    data = np.arange(1024, dtype=np.float32)
    obj = cluster.ranks[0].runtime.hetero_object(data)
    cluster.ranks[0].send(1, "tproto_recv", obj, path="direct")
    assert _wait_for("data")
    np.testing.assert_array_equal(_received["data"], data)
    assert cluster.ranks[0].stats["bytes_staged"] >= data.nbytes


def test_rendezvous_respects_route_to(cluster):
    cluster.ranks[1].route_to("tproto_recv", 1)
    obj = cluster.ranks[0].runtime.hetero_object(np.ones(1 << 17,
                                                         np.float32))
    cluster.ranks[0].send(1, "tproto_recv", obj)      # host-staged rdzv
    assert _wait_for("obj")
    assert _received["obj"].resident_devices() == {1}


# ---------------------------------------------------------------------------
# put / get
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,path,rdzv", [
    (32, "host", False), (32, "direct", False),
    (1 << 17, "host", True), (1 << 17, "direct", True)])
def test_put_overwrites_remote_object(cluster, n, path, rdzv):
    r0, r1 = cluster.ranks
    target = r1.runtime.hetero_object(np.zeros((n,), np.float32))
    r1.register_object("tgt", target)
    data = np.random.default_rng(n).random(n).astype(np.float32)
    src = _device_resident(r0.runtime, data, fn=lambda v: v * 2.0) \
        if path == "direct" else r0.runtime.hetero_object(data)
    staged0 = r1.stats["bytes_staged"]
    r0.put(1, "tgt", src, on_done="tproto_done", path=path,
           consumer_device=1 if path == "direct" else None)
    assert _wait_for("done")
    cluster.barrier()
    want = data * 2.0 if path == "direct" else data
    np.testing.assert_array_equal(target.get(), want)
    assert r0.stats["rendezvous"] == int(rdzv)
    if path == "direct":
        assert target.resident_devices() == {1}
        assert r1.stats["bytes_staged"] == staged0


def test_oversized_put_recycles_pooled_buffer_on_ack(cluster):
    r0, r1 = cluster.ranks
    target = r1.runtime.hetero_object(np.zeros((1 << 17,), np.float32))
    r1.register_object("big_tgt2", target)
    src = r0.runtime.hetero_object(np.ones((1 << 17,), np.float32))
    r0.put(1, "big_tgt2", src, on_done="tproto_done")
    assert _wait_for("done")
    cluster.barrier()
    deadline = time.time() + 10
    while r0._rdzv_bufs and time.time() < deadline:
        time.sleep(0.005)
    assert not r0._rdzv_bufs          # ack arrived, buffer released
    np.testing.assert_array_equal(target.get(), 1.0)


def test_ack_returns_streamed_buffer_to_pool(cluster):
    data = np.ones(1 << 17, np.float32)
    r0 = cluster.ranks[0]
    r0.send(1, "tproto_recv", r0.runtime.hetero_object(data))
    assert _wait_for("data")
    deadline = time.time() + 10
    while r0._rdzv_bufs and time.time() < deadline:
        time.sleep(0.005)
    assert not r0._rdzv_bufs
    hits0 = r0.runtime.staging.hits
    with _lock:
        _received.clear()
    r0.send(1, "tproto_recv", r0.runtime.hetero_object(data * 2))
    assert _wait_for("data")
    assert r0.runtime.staging.hits > hits0


@pytest.mark.parametrize("path", ["host", "direct"])
def test_get_remote_object(cluster, path):
    r0, r1 = cluster.ranks
    remote = _device_resident(r1.runtime, np.full((64, 64), 4.0, np.float32))
    r1.register_object("src", remote)
    r0.get(1, "src", "tproto_recv", path=path,
           consumer_device=1 if path == "direct" else None)
    assert _wait_for("obj")
    np.testing.assert_array_equal(_received["data"], 5.0)
    if path == "direct":
        assert _received["obj"].resident_devices() == {1}


@pytest.mark.parametrize("n", [32, 1 << 17])    # eager add, reduce stream
def test_reduce_into_accumulates(cluster, n):
    r0, r1 = cluster.ranks
    base = np.arange(n, dtype=np.float32)
    target = _device_resident(r1.runtime, base.copy(), fn=lambda v: v * 1.0)
    r1.register_object("acc", target)
    data = np.full((n,), 0.5, np.float32)
    r0.reduce_into(1, "acc", r0.runtime.hetero_object(data),
                   on_done="tproto_done")
    assert _wait_for("done")
    cluster.barrier()
    np.testing.assert_array_equal(target.get(), base + 0.5)
    assert r1.stats["coll_bytes_reduced"] == data.nbytes


# ---------------------------------------------------------------------------
# errors and rendezvous-state hygiene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strict", [False, True])
def test_handler_error_routed_to_sink(strict):
    with Cluster(2, _cfg(memory_capacity=1 << 26,
                         strict_errors=strict)) as c:
        c.ranks[0].send(1, "tproto_boom")
        deadline = time.time() + 10
        while c.ranks[1].stats["handler_errors"] == 0 \
                and time.time() < deadline:
            time.sleep(0.005)
        assert c.ranks[1].stats["handler_errors"] == 1
        if strict:
            with pytest.raises(RuntimeError, match="handler error"):
                c.barrier()
        else:
            c.barrier()


class _BlackholeCluster(Cluster):
    """Drops selected message kinds toward selected ranks."""

    def deliver(self, msg):
        if msg.kind in self._drop_kinds and msg.dst in self._drop_to:
            return
        super().deliver(msg)


def _blackhole(n, drop_kinds, drop_to):
    c = _BlackholeCluster.__new__(_BlackholeCluster)
    c._drop_kinds = frozenset(drop_kinds)
    c._drop_to = frozenset(drop_to)
    Cluster.__init__(c, n, _cfg(eager_threshold=64 << 10,
                                chunk_bytes=128 << 10))
    return c


def test_remove_peer_sweeps_parked_stream_and_releases_buffer():
    with _blackhole(2, drop_kinds={"cts"}, drop_to={0}) as c:
        r0, r1 = c.ranks
        r0.send(1, "tproto_recv",
                r0.runtime.hetero_object(np.ones(1 << 17, np.float32)))
        deadline = time.time() + 10
        while not r0._rdzv_out and time.time() < deadline:
            time.sleep(0.005)
        assert r0.state_gauges()["rdzv_out"] == 1    # parked, CTS lost
        hits0 = r0.runtime.staging.hits
        assert r0.remove_peer(1)["rdzv_out"] == 1
        assert all(v == 0 for v in r0.state_gauges().values())
        buf = r0.runtime.staging.acquire((1 << 17,), np.float32)
        assert r0.runtime.staging.hits == hits0 + 1
        r0.runtime.staging.release(buf)
        assert r1.remove_peer(0)["rdzv_in"] == 1
        assert all(v == 0 for v in r1.state_gauges().values())


def test_remove_peer_sweeps_ack_parked_buffer():
    with _blackhole(2, drop_kinds={"ack"}, drop_to={0}) as c:
        r0 = c.ranks[0]
        with _lock:
            _received.clear()
        r0.send(1, "tproto_recv",
                r0.runtime.hetero_object(np.ones(1 << 17, np.float32)))
        assert _wait_for("data")
        c.barrier()
        assert r0.state_gauges()["rdzv_bufs"] == 1   # ack never came
        assert r0.remove_peer(1)["rdzv_bufs"] == 1
        assert all(v == 0 for v in r0.state_gauges().values())


def test_shutdown_sweeps_all_rendezvous_state():
    c = _blackhole(2, drop_kinds={"cts", "ack"}, drop_to={0})
    try:
        r0 = c.ranks[0]
        r0.send(1, "tproto_recv",
                r0.runtime.hetero_object(np.ones(1 << 17, np.float32)))
        deadline = time.time() + 10
        while not r0._rdzv_out and time.time() < deadline:
            time.sleep(0.005)
        assert r0.state_gauges()["rdzv_out"] == 1
    finally:
        try:
            c.shutdown()
        except sanitizer.SanitizerError as e:
            assert "leaked protocol state" in str(e)
    assert all(v == 0 for v in c.ranks[0].state_gauges().values())
    assert all(v == 0 for v in c.ranks[1].state_gauges().values())


def test_fault_injector_drops_are_retransmitted():
    """The reliability layer: with a lossy link every send still arrives,
    through retries."""
    with Cluster(2, _cfg(eager_threshold=64 << 10, chunk_bytes=128 << 10,
                         retry_backoff_s=0.01)) as c:
        fi = c.fault_injector(seed=3)
        fi.set_link(0, 1, drop=0.2)
        for trial in range(4):
            with _lock:
                _received.clear()
            data = np.arange((192 << 10) // 4, dtype=np.float32) + trial
            c.ranks[0].send(1, "tproto_recv",
                            c.ranks[0].runtime.hetero_object(data))
            assert _wait_for("data", timeout=30)
            np.testing.assert_array_equal(_received["data"], data)
        assert fi.stats["dropped"] > 0 and c.ranks[0].stats["retries"] > 0


def test_stale_reordered_credit_cannot_rewiden_window(cluster):
    r0 = cluster.ranks[0]

    class _Meta:
        nchunks = 1000
        dst = 1
        path = "host"
    state = {"meta": _Meta(), "flat": np.zeros(32, np.float32),
             "arr": None, "elems": 1, "pooled": False, "next_seq": 0,
             "credits": 0, "window": None, "acked": 0}
    r0._rdzv_out[777] = state
    try:
        r0._advance_stream(777, 8, window=8, acked=0, initial=True)
        assert state["window"] == 8
        r0._advance_stream(777, 1, window=2, acked=5)
        assert state["window"] == 2 and state["acked"] == 5
        r0._advance_stream(777, 1, window=8, acked=3)     # stale
        assert state["window"] == 2 and state["acked"] == 5
        r0._advance_stream(777, 1, window=3, acked=6)
        assert state["window"] == 3 and state["acked"] == 6
    finally:
        r0._rdzv_out.pop(777, None)


# ---------------------------------------------------------------------------
# parity with the JAX package: the same sends make the same decisions
# ---------------------------------------------------------------------------

_COUNTERS = ("sent", "received", "bytes_out", "bytes_d2d", "bytes_staged",
             "direct_upgrades", "eager", "rendezvous", "chunks_out",
             "chunks_in")


def _drive(cluster_cls, cfg, recv):
    """One fixed sequence of sends: host and direct, eager, inline and
    rendezvous, a put each way and a get. Returns each rank's counters."""
    arrived = []
    done = threading.Event()

    with cluster_cls(2, cfg) as c:
        r0, r1 = c.ranks
        recv["fn"] = lambda: (arrived.append(1),
                              len(arrived) == 6 and done.set())
        rng = np.random.default_rng(11)
        small, tiny = rng.random(2048).astype(np.float32), \
            rng.random(16).astype(np.float32)
        big = rng.random(1 << 17).astype(np.float32)
        r0.send(1, "parity_recv", r0.runtime.hetero_object(tiny))
        r0.send(1, "parity_recv", r0.runtime.hetero_object(small))
        r0.send(1, "parity_recv", r0.runtime.hetero_object(big))
        dev = r0.runtime.hetero_object(big)
        r0.runtime.run(lambda v: v + 1.0, [(dev, "rw")])
        r0.runtime.barrier()
        r0.send(1, "parity_recv", dev, path="direct")
        tgt = r0.runtime.hetero_object(np.zeros(2048, np.float32))
        r0.register_object("t", tgt)
        r1.put(0, "t", r1.runtime.hetero_object(small), on_done="parity_recv")
        r1.register_object("g", r1.runtime.hetero_object(big))
        r0.get(1, "g", "parity_recv")
        assert done.wait(30)
        c.barrier()
        return [{k: r.stats[k] for k in _COUNTERS} for r in c.ranks]


_jax_recv, _port_recv = {}, {}


@jdist.handler(name="parity_recv")
def _jax_parity(ctx, obj):
    _jax_recv["fn"]()


@handler(name="parity_recv")
def _port_parity(ctx, obj):
    _port_recv["fn"]()


def test_same_sends_make_the_same_decisions_as_jax():
    kw = dict(memory_capacity=1 << 28, eager_threshold=64 << 10,
              chunk_bytes=128 << 10, net_window=2)
    want = _drive(jdist.Cluster, jcore.RuntimeConfig(**kw), _jax_recv)
    got = _drive(Cluster, _cfg(**kw), _port_recv)
    assert got == want
    assert want[0]["rendezvous"] == 2 and want[0]["bytes_d2d"] > 0


# ---------------------------------------------------------------------------
# mobile objects (numpy only): the same plans as the JAX package's
# ---------------------------------------------------------------------------

def test_block_distribution_matches_jax():
    d = block_distribution(16, 4)
    assert d == jdist.block_distribution(16, 4)
    counts = {r: sum(1 for v in d.values() if v == r) for r in range(4)}
    assert all(c == 4 for c in counts.values())


def test_rebalance_moves_from_hot_rank_as_jax_does():
    plans = []
    for om_cls, rebalance in ((OwnerMap, rebalance_greedy),
                              (jdist.OwnerMap, jdist.rebalance_greedy)):
        owner = om_cls()
        for i in range(8):
            owner.assign(i, 0 if i < 6 else 1)
        plans.append(rebalance({0: 6.0, 1: 2.0}, owner,
                               {i: 1.0 for i in range(8)}))
        assert 3 <= len(owner.owned_by(0)) <= 5
    assert plans[0] == plans[1] and plans[0]
    assert all(src == 0 and dst == 1 for _, src, dst in plans[0])


def test_ownermap_carries_device_hints():
    om = OwnerMap()
    om.assign(0, rank=1, device_hint=3)
    om.assign(1, rank=1)
    assert om.device_hint(0) == 3
    assert om.device_hint(1) is None
    v = om.version
    om.set_device_hint(1, 2)
    assert om.device_hint(1) == 2 and om.version == v + 1
    om.migrate(0, new_rank=0)
    assert om.device_hint(0) is None
    om.migrate(1, new_rank=0, device_hint=1)
    assert om.device_hint(1) == 1
