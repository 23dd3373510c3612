"""The slice end to end on the CPU: the port's Jacobi3D proxy and Fig. 3
double DGEMM against the JAX package's, on the same seeded numpy inputs.

The port runs on two logical CPU devices, the JAX runtime on the two XLA
CPU devices ``conftest.py`` pins. Tolerances are those of
``test_system.py::test_prema_jacobi_pipeline_with_runtime``.
"""
import numpy as np
import pytest
import torch

import repro.apps.jacobi3d as japp
import repro.core as jcore
from repro_torch.apps import dgemm as dgemm_app
from repro_torch.apps import jacobi3d as app
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import Runtime, RuntimeConfig
from repro_torch.kernels import ops

SHAPE = (16, 12, 8)


def _cfg(**kw) -> RuntimeConfig:
    return RuntimeConfig(device="cpu", cpu_devices=2, memory_capacity=1 << 26,
                         **kw)


@pytest.fixture(scope="module")
def u0():
    return np.random.default_rng(2).random(SHAPE).astype(np.float32)


@pytest.fixture(scope="module")
def jax_reference(u0):
    return japp.run_reference(u0, 3)


def test_stencil_update_matches_jax(u0):
    rng = np.random.default_rng(4)
    x, y, z = u0.shape
    faces = [rng.random(s).astype(np.float32)
             for s in ((y, z), (y, z), (x, z), (x, z), (x, y), (x, y))]
    got = to_numpy(app.stencil_update(to_torch(u0),
                                      *(to_torch(f) for f in faces)))
    want = np.asarray(japp.stencil_update(u0, *faces))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_run_reference_matches_jax(u0, jax_reference):
    got = app.run_reference(u0, 3, device="cpu")
    assert got.dtype == u0.dtype and got.shape == u0.shape
    np.testing.assert_allclose(got, jax_reference, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("od", [1, 2, 4])
def test_run_tasked_matches_jax(u0, jax_reference, od):
    with Runtime(_cfg()) as rt:
        got = app.run_tasked(u0, 3, rt, over_decomposition=od)
        stats = rt.stats()
    with jcore.Runtime(jcore.RuntimeConfig(memory_capacity=1 << 26)) as jrt:
        jgot = japp.run_tasked(u0, 3, jrt, over_decomposition=od)
        jstats = jrt.stats()
    np.testing.assert_allclose(got, jax_reference, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, jgot, rtol=1e-5, atol=1e-6)
    # chunked or whole, the port's sweep is the same arithmetic
    np.testing.assert_array_equal(got, app.run_reference(u0, 3, device="cpu"))
    # the same task graph: face puts plus one update per chunk and sweep
    assert stats["tasks"] == jstats["tasks"]
    # over-decomposed onto two devices, halos cross between them
    if od > 1:
        assert stats["transfers_d2d"] > 0


def test_run_tasked_routes_every_update_through_the_kernel_wrapper(
        u0, jax_reference, monkeypatch):
    """Each update task calls ``ops.jacobi3d_faces`` exactly once (on a
    card that is one launch of the CUDA kernel)."""
    calls = []
    real = ops.jacobi3d_faces

    def counting(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)
    monkeypatch.setattr(ops, "jacobi3d_faces", counting)
    with Runtime(_cfg()) as rt:
        got = app.run_tasked(u0, 3, rt, over_decomposition=4)
    n_chunks = 4 * 2
    assert len(calls) == n_chunks * 3
    assert set(calls) == {(4, 6, 8)}     # a 4x2x1 chunk grid
    np.testing.assert_allclose(got, jax_reference, rtol=1e-5, atol=1e-6)


def test_run_tasked_on_cpu_runs_no_cuda_code(u0, jax_reference,
                                             monkeypatch):
    """The CPU path never reaches the kernel build: with the build module
    made unimportable, the proxy still runs and still agrees."""
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch.kernels._build", None)
    with Runtime(_cfg()) as rt:
        got = app.run_tasked(u0, 3, rt, over_decomposition=2)
    np.testing.assert_allclose(got, jax_reference, rtol=1e-5, atol=1e-6)


def test_double_dgemm_matches_quickstart_product(monkeypatch):
    """``run_double_dgemm`` against the JAX quickstart's numpy product
    (A @ B) @ B, float32. The sums run in another order than numpy's, so
    the tolerance is a float32 one."""
    calls = []
    real = ops.matmul

    def counting(a, b):
        calls.append(a.dtype)
        return real(a, b)
    monkeypatch.setattr(ops, "matmul", counting)
    with Runtime(_cfg()) as rt:
        a, b, d = dgemm_app.run_double_dgemm(rt, 256, seed=3)
        stats = rt.stats()
    assert calls == [torch.float32, torch.float32]
    assert stats["tasks"] == 2
    assert a.dtype == b.dtype == d.dtype == np.float32
    want = (a @ b) @ b
    np.testing.assert_allclose(d, want, rtol=1e-5)
    # the same seed gives the same operands
    again = np.random.default_rng(3).random((256, 256), dtype=np.float32)
    np.testing.assert_array_equal(a, again)


@pytest.mark.parametrize("n_ranks", [2, 3])
def test_run_cluster_matches_jax_and_reference(n_ranks):
    """The distributed proxy on the message engine: slabs of 48 x 32 x 32
    float32 (above the 16 KB eager threshold: the scatter and gather ride
    rendezvous streams of 16 KB chunks), halos as DIRECT puts. Bit for bit
    the port's reference; within 1e-5 of the JAX package's run_cluster."""
    from repro.distributed import Cluster as JCluster
    from repro_torch.distributed import Cluster
    u0 = np.random.default_rng(3).random((48 * n_ranks // 2, 32, 32)
                                         ).astype(np.float32)
    kw = dict(memory_capacity=1 << 28, eager_threshold=16 << 10,
              chunk_bytes=16 << 10)
    with Cluster(n_ranks, _cfg(**{k: v for k, v in kw.items()
                                  if k != "memory_capacity"})) as c:
        got = app.run_cluster(u0, 2, c)
        stats = [dict(r.stats) for r in c.ranks]
    with JCluster(n_ranks, jcore.RuntimeConfig(**kw)) as jc:
        want = japp.run_cluster(u0, 2, jc)
        jstats = [dict(r.stats) for r in jc.ranks]
    np.testing.assert_array_equal(got, app.run_reference(u0, 2,
                                                         device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert stats[0]["rendezvous"] == n_ranks - 1          # scatter leg
    assert all(s["rendezvous"] >= 1 for s in stats[1:])   # gather leg
    # the halo planes travel device to device: nothing staged but the
    # host-resident scatter and gather
    for s, js in zip(stats, jstats, strict=True):
        for k in ("eager", "rendezvous", "chunks_out", "chunks_in",
                  "bytes_d2d", "bytes_staged"):
            assert s[k] == js[k], (k, s, js)


def test_run_cluster_residual_needs_the_collectives():
    """``run_cluster(residual_every=2)``: the global update residual every
    2 iterations through the runtime collectives (an allreduce of one
    float64 partial per rank), against the JAX package's run of the same
    input and config. The port's iterates are bit for bit
    ``run_reference``'s, so its residuals are held to numpy's float64
    residuals of those iterates at a relative 1e-10 (the partials sum in
    another order). JAX's iterates differ from them by float32 rounding
    (its stencil adds in another order), which moves the residuals by
    about 1e-7 relative: against JAX they are held to the Jacobi
    tolerance, 1e-5."""
    from repro.distributed import Cluster as JCluster
    from repro_torch.distributed import Cluster
    u0 = np.random.default_rng(9).standard_normal((18, 10, 10)
                                                  ).astype(np.float32)
    kw = dict(memory_capacity=1 << 26, coll_ring_cutover_bytes=1 << 12,
              eager_threshold=1 << 10, chunk_bytes=1 << 12)
    res, jres = [], []
    with Cluster(3, _cfg(**{k: v for k, v in kw.items()
                            if k != "memory_capacity"})) as c:
        got = app.run_cluster(u0, 4, c, residual_every=2, residuals=res)
        reduced = sum(r.stats["coll_bytes_reduced"] for r in c.ranks)
    with JCluster(3, jcore.RuntimeConfig(**kw)) as jc:
        want = japp.run_cluster(u0, 4, jc, residual_every=2, residuals=jres)
    np.testing.assert_array_equal(got, app.run_reference(u0, 4,
                                                         device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert [it for it, _ in res] == [it for it, _ in jres] == [2, 4]
    iterates = [app.run_reference(u0, k, device="cpu").astype(np.float64)
                for k in range(5)]
    np.testing.assert_allclose(
        [v for _, v in res],
        [np.sqrt(np.sum((iterates[k] - iterates[k - 1]) ** 2))
         for k in (2, 4)], rtol=1e-10)
    np.testing.assert_allclose([v for _, v in res], [v for _, v in jres],
                               rtol=1e-5)
    assert 0 < res[1][1] < res[0][1]      # Jacobi converges
    assert reduced > 0                     # the tree combined the partials
