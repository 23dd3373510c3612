"""The port's Device API and tasking runtime (``repro_torch.core``) against
the JAX package's: counterparts of the dependency-inference, host-access,
transfer-engine and placement tests of ``test_runtime.py`` and
``test_transfer_engine.py``, on two logical CPU devices (the JAX side runs
on the two XLA CPU devices ``conftest.py`` pins), plus the torch-specific
contracts: clones and uploads never alias, outputs that alias a non-donated
input are copied, and nothing falls back to the CPU unasked.
"""
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as jcore
from repro_torch.core import (HOST, HeteroTask, Runtime, RuntimeConfig,
                              TaskState)
from repro_torch.core import device_api
from repro_torch.core.device_api import TorchDevice, discover_devices, transfer
from repro_torch.core.scheduler import SCHEDULERS, RoundRobinScheduler


class _RoundRobinNoSteal(RoundRobinScheduler):
    """Deterministic cross-device placement: without stealing, a task
    indexed to device 1 always runs on device 1."""
    steals = False


SCHEDULERS.setdefault("_torch_rr_nosteal", _RoundRobinNoSteal)


def _cfg(**kw) -> RuntimeConfig:
    kw.setdefault("memory_capacity", 1 << 28)
    return RuntimeConfig(device="cpu", cpu_devices=2, **kw)


@pytest.fixture()
def rt():
    r = Runtime(_cfg())
    yield r
    r.shutdown()


def add_one(x, out):
    return x + 1.0


def scale(x, out):
    return x * 2.0


# ---------------------------------------------------------------------------
# dependency inference and host access (test_runtime.py counterparts)
# ---------------------------------------------------------------------------

def test_raw_dependency_order(rt):
    x = rt.hetero_object(np.zeros((8, 8), np.float32))
    y = rt.hetero_object(shape=(8, 8), dtype=np.float32)
    z = rt.hetero_object(shape=(8, 8), dtype=torch.float32)  # torch dtype ok
    rt.run(add_one, [(x, "r"), (y, "w")])
    rt.run(scale, [(y, "r"), (z, "w")])
    rt.barrier()
    assert z.dtype == torch.float32      # objects carry torch dtypes
    np.testing.assert_allclose(z.get(), 2.0)


def test_implicit_chain_is_sequential(rt):
    x = rt.hetero_object(np.zeros((4,), np.float32))
    for _ in range(20):
        rt.run(lambda v: v + 1.0, [(x, "rw")])
    rt.barrier()
    np.testing.assert_allclose(x.get(), 20.0)


def test_war_blocks_writer(rt):
    x = rt.hetero_object(np.ones((4,), np.float32))
    y = rt.hetero_object(shape=(4,), dtype=np.float32)
    rt.run(scale, [(x, "r"), (y, "w")])
    rt.run(lambda v: v * 0.0, [(x, "rw")])
    rt.barrier()
    np.testing.assert_allclose(y.get(), 2.0)
    np.testing.assert_allclose(x.get(), 0.0)


def test_explicit_dependency(rt):
    order = []
    lock = threading.Lock()
    a = rt.hetero_object(np.zeros((2,), np.float32))
    b = rt.hetero_object(np.zeros((2,), np.float32))

    def mark(tag):
        def k(v):
            with lock:
                order.append(tag)
            return v
        return k

    t1 = HeteroTask("first")
    t1.arg(a).rw()
    t2 = HeteroTask("second")
    t2.arg(b).rw()
    t2.add_dependency(t1)
    rt.submit(t2, mark("second"))
    time.sleep(0.02)
    rt.submit(t1, mark("first"))
    rt.barrier()
    assert order == ["first", "second"]


def test_host_pin_and_write_invalidation(rt):
    x = rt.hetero_object(np.ones((4,), np.float32))
    np.testing.assert_allclose(x.request_host().get(5), 1.0)
    x.release()
    rt.run(lambda v: v + 1, [(x, "rw")])
    rt.barrier()
    assert HOST not in x.valid_spaces()       # the device write invalidated
    np.testing.assert_allclose(x.get(), 2.0)
    np.testing.assert_allclose(x.get(), 2.0)


def test_lru_offload_under_pressure():
    cap = 4 * 64 * 64 * 4 + 128   # ~4 objects of 16KB
    with Runtime(_cfg(memory_capacity=cap)) as rt:
        objs = [rt.hetero_object(np.full((64, 64), i, np.float32))
                for i in range(10)]
        for o in objs:
            rt.run(lambda v: v + 1, [(o, "rw")])
        rt.barrier()
        for i, o in enumerate(objs):
            np.testing.assert_allclose(o.get(), i + 1)
        assert rt.stats()["evictions"] > 0


@pytest.mark.parametrize("sched", ["fifo", "least_loaded", "locality",
                                   "round_robin", "gravity"])
def test_all_schedulers_complete(sched):
    with Runtime(_cfg(scheduler=sched)) as rt:
        x = rt.hetero_object(np.zeros((16,), np.float32))
        for _ in range(10):
            rt.run(lambda v: v + 1, [(x, "rw")])
        rt.barrier()
        np.testing.assert_allclose(x.get(), 10.0)


def _random_program(seed: int):
    rng = np.random.default_rng(seed)
    return [(int(s), int(d)) for s, d in rng.integers(0, 5, (25, 2))]


def _run_program(rt, ops):
    objs = [rt.hetero_object(np.full((4,), float(i), np.float32))
            for i in range(5)]
    for src, dst in ops:
        if src == dst:
            rt.run(lambda v: v * 2.0 + 1.0, [(objs[src], "rw")])
        else:
            rt.run(lambda a, b: a + b, [(objs[src], "r"), (objs[dst], "rw")])
    rt.barrier()
    return [o.get() for o in objs]


@pytest.mark.parametrize("seed", range(4))
def test_random_program_matches_jax_runtime_and_sequential(seed):
    """The same seeded read/write program gives the sequential answer on
    the port and on the JAX runtime (the paper's correctness guarantee)."""
    ops = _random_program(seed)
    model = [np.full((4,), float(i), np.float32) for i in range(5)]
    for src, dst in ops:
        if src == dst:
            model[src] = model[src] * 2.0 + 1.0
        else:
            model[dst] = model[src] + model[dst]
    with Runtime(_cfg()) as rt:
        got = _run_program(rt, ops)
    with jcore.Runtime(jcore.RuntimeConfig(memory_capacity=1 << 28)) as jrt:
        ref = _run_program(jrt, ops)
    for g, r, m in zip(got, ref, model, strict=True):
        np.testing.assert_array_equal(g, m)
        np.testing.assert_array_equal(r, m)


def test_device_type_targeting(rt):
    x = rt.hetero_object(np.ones((4,), np.float32))
    t = rt.run(lambda v: v + 1, [(x, "rw")],
               device_type=rt.devices[0].info.device_type)
    rt.barrier()
    assert rt.devices[0].info.device_type == "cpu"
    assert t.state == TaskState.DONE
    np.testing.assert_allclose(x.get(), 2.0)


def test_stats_and_staging_pool(rt):
    x = rt.hetero_object(np.ones((32, 32), np.float32))
    for _ in range(3):
        rt.run(lambda v: v + 1, [(x, "rw")])
    rt.barrier()
    s = rt.stats()
    assert s["tasks"] == 3
    assert s["bytes_h2d"] >= x.nbytes


# ---------------------------------------------------------------------------
# transfer engine and placement (test_transfer_engine.py counterparts)
# ---------------------------------------------------------------------------

def test_device_api_transfer_roundtrip():
    devs = discover_devices(memory_capacity=1 << 28, device="cpu")
    assert len(devs) == 2
    host = np.arange(256, dtype=np.float32).reshape(16, 16)
    on0 = devs[0].upload(host)
    on1 = transfer(devs[0], devs[1], on0)
    assert on1.untyped_storage().data_ptr() != on0.untyped_storage().data_ptr()
    np.testing.assert_array_equal(devs[1].download(on1), host)


def test_ensure_on_device_prefers_d2d():
    with Runtime(_cfg()) as rt:
        x = rt.hetero_object(np.arange(64, dtype=np.float32))
        rt._ensure_on_device(x, 0, will_write=False)
        h2d_before = rt.stats()["transfers_h2d"]
        with x.lock:
            rt._drop_copy(x, HOST)
        rt._ensure_on_device(x, 1, will_write=False)
        s = rt.stats()
        assert s["transfers_d2d"] == 1
        assert s["bytes_d2d"] == x.nbytes
        assert s["transfers_h2d"] == h2d_before
        assert s["transfers_d2h"] == 0
        np.testing.assert_array_equal(x.get(), np.arange(64, dtype=np.float32))


def test_d2d_disabled_falls_back_to_host_staging():
    with Runtime(_cfg(d2d=False)) as rt:
        x = rt.hetero_object(np.ones(64, dtype=np.float32))
        rt._ensure_on_device(x, 0, will_write=False)
        with x.lock:
            rt._drop_copy(x, HOST)
        rt._ensure_on_device(x, 1, will_write=False)
        s = rt.stats()
        assert s["transfers_d2d"] == 0
        assert s["transfers_d2h"] == 1
        np.testing.assert_array_equal(x.get(), 1.0)


def test_cross_device_producer_consumer_chain_uses_d2d():
    with Runtime(_cfg(scheduler="_torch_rr_nosteal")) as rt:
        x = rt.hetero_object(np.full((32, 32), 2.0, np.float32))
        y = rt.hetero_object(shape=(32, 32), dtype=np.float32)
        t1 = rt.run(lambda v: v + 1.0, [(x, "rw")])
        t2 = rt.run(lambda a, out: a * 10.0, [(x, "r"), (y, "w")])
        rt.barrier()
        assert t1.chosen_device != t2.chosen_device
        s = rt.stats()
        assert s["transfers_d2d"] >= 1
        assert s["transfers_d2h"] == 0 and s["bytes_d2h"] == 0
        np.testing.assert_allclose(y.get(), 30.0)
        np.testing.assert_allclose(x.get(), 3.0)


def test_coherence_after_mixed_d2d_and_host_writes():
    with Runtime(_cfg()) as rt:
        x = rt.hetero_object(np.zeros(16, dtype=np.float32))
        rt.run(lambda v: v + 5.0, [(x, "rw")])
        rt.barrier()
        rt._ensure_on_device(x, 0, will_write=False)
        rt._ensure_on_device(x, 1, will_write=False)
        arr = x.request_host(write=True).get(5)
        arr[...] = 7.0
        x.release()
        assert x.valid_spaces() == {HOST}
        rt.run(lambda v: v * 2.0, [(x, "rw")])
        rt.barrier()
        np.testing.assert_allclose(x.get(), 14.0)


def test_gravity_keeps_rw_chains_on_their_device():
    """Data-gravity placement: an rw chain stays where its object lives,
    so after the first upload nothing moves."""
    with Runtime(_cfg()) as rt:
        x = rt.hetero_object(np.zeros((64, 64), np.float32))
        tasks = [rt.run(lambda v: v + 1.0, [(x, "rw")]) for _ in range(8)]
        rt.barrier()
        assert len({t.chosen_device for t in tasks}) == 1
        s = rt.stats()
        assert s["transfers_h2d"] == 1 and s["transfers_d2d"] == 0
        assert x.resident_devices() == {tasks[0].chosen_device}
        np.testing.assert_allclose(x.get(), 8.0)


def test_prefetch_pipeline_counts_hits_and_recycles_futures():
    with Runtime(_cfg(prefetch=True)) as rt:
        objs = [rt.hetero_object(np.ones((64, 64), np.float32))
                for _ in range(30)]
        for o in objs:
            rt.run(lambda v: v @ v.T, [(o, "rw")])
        rt.barrier()
        s = rt.stats()
        assert s["prefetch_hits"] + s["prefetch_stalls"] > 0, s
        assert len(rt.futures._free) > 0
        for o in objs:
            np.testing.assert_allclose(o.get(), 64.0)


def test_prefetch_disabled_counts_nothing():
    with Runtime(_cfg(prefetch=False)) as rt:
        x = rt.hetero_object(np.ones(8, np.float32))
        for _ in range(5):
            rt.run(lambda v: v + 1, [(x, "rw")])
        rt.barrier()
        s = rt.stats()
        assert s["prefetch_hits"] == s["prefetch_stalls"] == 0
        assert s["prefetch_misses"] == 0
        np.testing.assert_allclose(x.get(), 6.0)


def test_staging_pool_buffers_are_recycled():
    with Runtime(_cfg()) as rt:
        for _ in range(4):
            c = rt.hetero_object(shape=(32, 32), dtype=np.float32)
            rt.run(lambda v: v + 1.0, [(c, "w")])
            rt.barrier()
            np.testing.assert_allclose(c.get(), 1.0)
        assert rt.stats()["staging_hits"] > 0, rt.stats()


def test_chunked_host_upload_through_staging_pool():
    with Runtime(_cfg(staging_chunk_bytes=1 << 12)) as rt:
        data = np.random.default_rng(0).random((64, 64)).astype(np.float32)
        x = rt.hetero_object(data.copy())
        rt.run(lambda v: v * 1.0, [(x, "rw")])
        rt.barrier()
        np.testing.assert_array_equal(x.get(), data)
        assert rt.staging.hits + rt.staging.misses > 1


def test_discover_devices_reports_positive_capacity():
    devs = discover_devices(device="cpu", cpu_devices=3)
    assert len(devs) == 3 and all(d.info.memory_capacity > 0 for d in devs)
    with open("/proc/meminfo") as f:
        total = int(f.readline().split()[1]) * 1024
    assert all(d.info.memory_capacity <= total for d in devs)
    devs = discover_devices(memory_capacity=12345, device="cpu")
    assert all(d.info.memory_capacity == 12345 for d in devs)


def test_kernel_cache_keys_on_kernel_object_and_donation():
    dev = discover_devices(memory_capacity=1 << 28, device="cpu")[0]

    def k1(x):
        return x + 1

    def k2(x):
        return x + 2

    f1 = dev._get_kernel(k1, ())
    assert dev._get_kernel(k2, ()) is not f1
    assert dev._get_kernel(k1, ()) is f1
    assert dev._get_kernel(k1, (0,)) is not f1
    assert any(k is k1 for k, _ in dev._kernel_cache)
    dev.cache_jit = False
    assert dev._get_kernel(k1, ()) is not f1


# ---------------------------------------------------------------------------
# torch-specific contracts
# ---------------------------------------------------------------------------

def test_upload_does_not_alias_the_host_buffer():
    dev = discover_devices(device="cpu")[0]
    host = np.arange(8, dtype=np.float32)
    t = dev.upload(host)
    host[...] = -1.0                  # the runtime recycles staging buffers
    np.testing.assert_array_equal(dev.download(t), np.arange(8))
    out = dev.download(t)
    out[...] = 5.0                    # and a download is private too
    np.testing.assert_array_equal(dev.download(t), np.arange(8))


def test_clone_truly_copies():
    dev = discover_devices(device="cpu")[0]
    t = dev.upload(np.ones(8, np.float32))
    snap = dev.clone(t)
    t.add_(1.0)                       # a later in-place write
    np.testing.assert_array_equal(dev.download(snap), 1.0)


def test_output_view_of_a_read_input_is_copied(rt):
    """A kernel that returns a view of an input it only reads: the runtime
    binds a copy, so a later in-place write to the input cannot reach the
    output object."""
    x = rt.hetero_object(np.arange(12, dtype=np.float32).reshape(3, 4))
    y = rt.hetero_object(shape=(4,), dtype=np.float32)
    rt.run(lambda u, out: u[0], [(x, "r"), (y, "w")])
    rt.barrier()
    (dev, ycopy), = [(s, a) for s, a in y.copies.items() if s != HOST]
    xcopy = x.copies[dev]
    assert ycopy.untyped_storage().data_ptr() != \
        xcopy.untyped_storage().data_ptr()

    def bump(u):
        u.add_(100.0)                 # in place: u is donated
        return u
    rt.run(bump, [(x, "rw")])
    rt.barrier()
    np.testing.assert_array_equal(y.get(), np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(x.get()[0], np.arange(4) + 100.0)


def test_output_aliasing_a_donated_input_is_kept():
    """In place on a donated argument is allowed and costs no copy."""
    dev = discover_devices(device="cpu")[0]
    t = dev.upload(np.ones(8, np.float32))

    def inplace(u):
        return u.mul_(3.0)

    assert dev.launch(inplace, (t,), donate=(0,)) is t
    out = dev.launch(lambda u: u[2:], (t,), donate=())
    assert out.untyped_storage().data_ptr() != t.untyped_storage().data_ptr()
    np.testing.assert_array_equal(dev.download(out), 3.0)


def test_device_view_snapshot_survives_in_place_write(rt):
    x = rt.hetero_object(np.ones(8, np.float32))
    rt.run(lambda v: v + 1.0, [(x, "rw")])
    rt.barrier()
    space, snap = rt._request_device_view(x).get(5)
    assert space != HOST
    x.copies[space].add_(10.0)
    np.testing.assert_array_equal(snap.numpy(), 2.0)


def test_trace_graphs_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Runtime(_cfg(trace_graphs=True))


def test_step_boundary_is_a_noop(rt):
    x = rt.hetero_object(np.zeros(4, np.float32))
    rt.run(lambda v: v + 1.0, [(x, "rw")])
    rt.step_boundary()
    rt.barrier()
    np.testing.assert_array_equal(x.get(), 1.0)


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    assert RuntimeConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        discover_devices(device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        Runtime(RuntimeConfig(memory_capacity=1 << 20))


def test_device_api_ready_and_completion_on_cpu():
    dev = discover_devices(device="cpu")[0]
    t = dev.launch(lambda v: v * 2, (dev.upload(np.ones(4, np.float32)),))
    assert dev.is_ready(t)
    assert dev.completion_waiter(t)() is t
    assert dev.synchronize(t) is t
    assert isinstance(dev, TorchDevice) and dev.info.device_type == "cpu"
    h = dev.upload_async(np.ones(4, np.float32))
    assert h.is_ready() and torch.equal(h.result(), torch.ones(4))
    assert device_api.FOREIGN == -2


def test_port_runtime_passes_the_runtime_lint(monkeypatch, tmp_path):
    """tools/lint_runtime.py's four rules (no wall clock, sanitizer-made
    locks, registered stats keys, no blocking lane jobs) over the port's
    core and distributed layers, with an empty allowlist."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(repo / "tools"))
    import lint_runtime
    monkeypatch.setattr(lint_runtime, "SCOPE", (
        "src/repro_torch/core", "src/repro_torch/distributed"))
    monkeypatch.setattr(lint_runtime, "R1_EXEMPT",
                        {"src/repro_torch/core/clock.py"})
    monkeypatch.setattr(lint_runtime, "R2_EXEMPT",
                        {"src/repro_torch/core/sanitizer.py"})
    monkeypatch.setattr(lint_runtime, "ALLOWLIST", tmp_path / "none.txt")
    assert lint_runtime.run() == 0


_BF16_NO_NUMPY = r"""
import sys
import numpy as np
import torch
from repro_torch.core import Runtime, RuntimeConfig
assert "jax" not in sys.modules and "ml_dtypes" not in sys.modules
try:
    np.dtype("bfloat16")
    raise SystemExit("numpy has a bfloat16 here: the test shows nothing")
except TypeError:
    pass
with Runtime(RuntimeConfig(device="cpu", cpu_devices=2,
                           memory_capacity=1 << 26)) as rt:
    x = rt.adopt_device_array(
        torch.arange(8, dtype=torch.bfloat16).reshape(2, 4), name="x")
    assert x.dtype == torch.bfloat16 and x.nbytes == 16
    rt.run(lambda v: v * 2 + 1, [(x, "rw")])
    s = rt.hetero_object(shape=(2,), dtype=np.float32, name="s")
    rt.run(lambda v, out: v.float().sum(dim=1), [(x, "r"), (s, "w")])
    rt.barrier()
    got = s.get()
    try:
        x.get()
        raise SystemExit("reading a bf16 object back did not raise")
    except TypeError as e:
        assert "bfloat16" in str(e), e
    assert rt.stats()["pinned_objects"] == 0
print("sums", got.tolist())
"""


def test_bf16_objects_need_no_numpy_bfloat16():
    """In a process that never imports jax or ml_dtypes (numpy then has
    no bfloat16), a bf16 tensor is adopted, written in place by a task and
    read by a later task into a float32 object; reading the bf16 object
    itself back to the host raises a TypeError that names the dtype."""
    import os
    import subprocess
    import sys
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    out = subprocess.run([sys.executable, "-c", _BF16_NO_NUMPY],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=str(repo))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    # rows [0..3] and [4..7], each value v -> 2v + 1
    assert "sums [16.0, 48.0]" in out.stdout
