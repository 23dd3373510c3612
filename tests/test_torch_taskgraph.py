"""Task-graph replay in the port (``repro_torch.core.taskgraph``) on the CPU:
traced windows bit-identical to interpreted ones and within 1e-5 of the
JAX package's traced runs on the same seeded numpy inputs, and the
invalidation taxonomy (structural deviation, eviction, explicit
invalidation on a cluster rank, host-access flush) of
``tests/test_taskgraph.py``.

The port runs on two logical CPU devices, where a chain runs eagerly; the
CUDA-graph capture of a chain is held to the interpreted run on the card
in ``tests/test_torch_cuda.py``. The tolerance against the JAX package is
1e-5 relative and absolute: both runtimes compute the same float32
operations, which XLA may fuse into another rounding order.
"""
import numpy as np
import pytest

import repro.apps.jacobi3d as japp
import repro.core as jcore
from repro_torch import kernels
from repro_torch.apps import jacobi3d as app
from repro_torch.core import Runtime, RuntimeConfig
from repro_torch.distributed import Cluster

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(**kw) -> RuntimeConfig:
    kw.setdefault("memory_capacity", 1 << 28)
    return RuntimeConfig(device="cpu", cpu_devices=2, **kw)


def _rt(**kw) -> Runtime:
    return Runtime(_cfg(**kw))


def _jrt(**kw):
    return jcore.Runtime(jcore.RuntimeConfig(memory_capacity=1 << 28, **kw))


def bump(v):
    return v + 1.0


def axpy(av, yv):
    return yv + av


# ---------------------------------------------------------------------------
# bit-identity, and parity with the JAX package's traced runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("od", [1, 2])
def test_jacobi_traced_bit_identical(od):
    rng = np.random.default_rng(0)
    u0 = rng.standard_normal((12, 12, 12)).astype(np.float32)
    iters = 8
    with _rt() as rt_i:
        interp = app.run_tasked(u0, iters, rt_i, over_decomposition=od)
    with _rt(trace_graphs=True, replay_after=3) as rt_t:
        traced = app.run_tasked(u0, iters, rt_t, over_decomposition=od)
        st = rt_t.stats()
    assert st["graphs_traced"] == 1
    # windows 1-3 run interpreted and compile; the rest replay
    assert st["graph_replays"] == iters - 3
    assert st["replayed_tasks"] == st["tasks"] * (iters - 3) // iters
    assert st["graph_invalidations"] == 0
    # the fast path must be invisible: bit-identical, not just close
    np.testing.assert_array_equal(traced, interp)
    np.testing.assert_array_equal(
        traced, app.run_reference(u0, iters, device="cpu"))
    with _jrt(trace_graphs=True, replay_after=3) as jrt:
        want = japp.run_tasked(u0, iters, jrt, over_decomposition=od)
        jst = jrt.stats()
    assert (jst["graphs_traced"], jst["graph_replays"],
            jst["replayed_tasks"]) == (st["graphs_traced"],
                                       st["graph_replays"],
                                       st["replayed_tasks"])
    np.testing.assert_allclose(traced, want, **TOL)


def _train_loop(rt, steps):
    """Toy microbatch train step: grad then in-place apply — the
    recurring two-task window of a training loop. The kernels run on the
    arrays of either package."""
    w = rt.hetero_object(np.full((64,), 0.5, np.float32), name="w")
    g = rt.hetero_object(np.zeros((64,), np.float32), name="g")
    x = rt.hetero_object(np.linspace(0.0, 1.0, 64, dtype=np.float32),
                         name="x")

    def grad(xv, wv, out):
        return (wv - xv) * 0.5

    def apply_(gv, wv):
        return wv - 0.1 * gv

    for _ in range(steps):
        rt.run(grad, [(x, "r"), (w, "r"), (g, "w")])
        rt.run(apply_, [(g, "r"), (w, "rw")])
        rt.step_boundary()
    rt.barrier()
    return np.asarray(w.get()).copy()


def test_microbatch_train_traced_bit_identical():
    with _rt() as rt_i:
        w_interp = _train_loop(rt_i, steps=10)
    with _rt(trace_graphs=True, replay_after=3) as rt_t:
        w_traced = _train_loop(rt_t, steps=10)
        st = rt_t.stats()
    assert st["graphs_traced"] == 1
    assert st["graph_replays"] == 7
    np.testing.assert_array_equal(w_traced, w_interp)
    with _jrt(trace_graphs=True, replay_after=3) as jrt:
        want = _train_loop(jrt, steps=10)
        assert jrt.stats()["graph_replays"] == st["graph_replays"]
    np.testing.assert_allclose(w_traced, want, **TOL)


def test_in_place_writer_is_replayed_in_place():
    """A kernel that writes its rw argument in place (the tasked decode
    loop's cache) keeps writing the object's own tensor under replay."""
    with _rt(trace_graphs=True, replay_after=2) as rt:
        a = rt.hetero_object(np.zeros((8,), np.float32))

        def add_in_place(v):
            return v.add_(1.0)

        for _ in range(6):
            rt.run(add_in_place, [(a, "rw")])
            rt.step_boundary()
        rt.barrier()
        (dev,) = a.resident_devices()
        t = a.copies[dev]
        rt.run(add_in_place, [(a, "rw")])
        rt.step_boundary()
        rt.barrier()
        assert a.copies[dev] is t
        assert rt.stats()["graph_replays"] == 5
        np.testing.assert_array_equal(a.get(), 7.0)


def test_captured_launches_count_at_each_replay():
    """A capture records its kernels' launches instead of counting them;
    each replay adds them."""
    before = dict(kernels.LAUNCHES)
    with kernels.recording_launches() as rec:
        kernels.count_launch("jacobi3d_faces")
        kernels.count_launch("jacobi3d_faces")
    assert rec == {"jacobi3d_faces": 2}
    assert kernels.LAUNCHES == before
    kernels.add_launches(rec)
    kernels.add_launches(rec)
    assert kernels.LAUNCHES["jacobi3d_faces"] == \
        before["jacobi3d_faces"] + 4
    kernels.LAUNCHES["jacobi3d_faces"] = before["jacobi3d_faces"]


# ---------------------------------------------------------------------------
# invalidation taxonomy
# ---------------------------------------------------------------------------

def test_invalidation_on_shape_change():
    with _rt(trace_graphs=True, replay_after=2) as rt:
        a = rt.hetero_object(np.ones((16,), np.float32))
        for _ in range(4):
            rt.run(bump, [(a, "rw")])
            rt.step_boundary()
        rt.barrier()
        st = rt.stats()
        assert st["graphs_traced"] == 1 and st["graph_replays"] >= 1
        # a different-shaped object in the same structural position is a
        # deviation (shape is part of the signature via object identity)
        b = rt.hetero_object(np.ones((32,), np.float32))
        rt.run(bump, [(b, "rw")])
        rt.step_boundary()
        rt.barrier()
        assert rt.stats()["graph_invalidations"] >= 1
        np.testing.assert_allclose(a.get(), 5.0)
        np.testing.assert_allclose(b.get(), 2.0)


def test_invalidation_on_eviction():
    with _rt(trace_graphs=True, replay_after=2) as rt:
        a = rt.hetero_object(np.ones((16,), np.float32))
        y = rt.hetero_object(np.zeros((16,), np.float32))
        for _ in range(3):
            rt.run(axpy, [(a, "r"), (y, "rw")])
            rt.step_boundary()
        rt.barrier()
        assert rt.stats()["graph_replays"] >= 1
        # evict the read-only entry replica the replay plan counted on
        devs = sorted(rt.residency.devices_of(a))
        assert devs, "compiled entry should be device-resident"
        assert rt._evict(a, devs[0])
        inv0 = rt.stats()["graph_invalidations"]
        rt.run(axpy, [(a, "r"), (y, "rw")])
        rt.step_boundary()
        rt.barrier()
        # the stale window still executed correctly (coherence walk) and
        # the plan was retired afterwards
        assert rt.stats()["graph_invalidations"] == inv0 + 1
        np.testing.assert_allclose(y.get(), 4.0)


def test_invalidation_on_a_cluster_ranks_runtime():
    """The reference bumps an elastic epoch (not ported); here the same
    invalidation arrives through ``invalidate_traces`` on a rank."""
    with Cluster(2, _cfg(memory_capacity=1 << 26, trace_graphs=True,
                         replay_after=2)) as c:
        rt0 = c.ranks[0].runtime
        a = rt0.hetero_object(np.ones((8,), np.float32))
        for _ in range(3):
            rt0.run(bump, [(a, "rw")])
            rt0.step_boundary()
        rt0.barrier()
        assert rt0._tracer.graph() is not None
        for r in c.ranks:
            r.runtime.invalidate_traces()
        assert rt0._tracer.graph() is None
        assert rt0.stats()["graph_invalidations"] >= 1
        # recurrence detection restarts cleanly afterwards
        for _ in range(3):
            rt0.run(bump, [(a, "rw")])
            rt0.step_boundary()
        rt0.barrier()
        assert rt0.stats()["graphs_traced"] == 2
        np.testing.assert_allclose(a.get(), 7.0)


def test_host_read_flushes_but_keeps_graph():
    with _rt(trace_graphs=True, replay_after=2) as rt:
        a = rt.hetero_object(np.zeros((8,), np.float32))
        for _ in range(3):
            rt.run(bump, [(a, "rw")])
            rt.step_boundary()
        rt.barrier()
        assert rt.stats()["graph_replays"] == 1
        # mid-window host read: the parked task must flush so the read
        # observes its write — but the graph stays armed
        rt.run(bump, [(a, "rw")])
        np.testing.assert_allclose(a.get(), 4.0)       # flush + observe
        rt.step_boundary()
        rt.barrier()
        st = rt.stats()
        assert rt._tracer.graph() is not None
        assert st["graph_invalidations"] == 0
        # next full window replays again
        rt.run(bump, [(a, "rw")])
        rt.step_boundary()
        rt.barrier()
        assert rt.stats()["graph_replays"] == 2
        np.testing.assert_allclose(a.get(), 5.0)


def test_device_view_flushes_parked_writes():
    """A DIRECT send's device view mid-window observes the parked write."""
    with _rt(trace_graphs=True, replay_after=2) as rt:
        a = rt.hetero_object(np.zeros((8,), np.float32))
        for _ in range(3):
            rt.run(bump, [(a, "rw")])
            rt.step_boundary()
        rt.barrier()
        rt.run(bump, [(a, "rw")])
        space, snap = rt._request_device_view(a).get(5)
        np.testing.assert_array_equal(snap.numpy(), 4.0)
        rt.step_boundary()
        rt.barrier()
        assert rt._tracer.graph() is not None


# ---------------------------------------------------------------------------
# acceptance: pooled engine under sustained cluster barrier traffic
# ---------------------------------------------------------------------------

def test_cluster_barrier_200_iterations_pooled():
    with Cluster(2, _cfg(memory_capacity=1 << 26, pool_workers=4)) as c:
        for _ in range(200):
            c.barrier(timeout=30.0)
