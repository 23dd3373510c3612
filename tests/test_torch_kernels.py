"""Parity of the port's kernels (``repro_torch.kernels``) with the JAX
package's Pallas kernels and their ``ref`` oracles.

On the CPU a wrapper runs its kernel's plain PyTorch version; the Pallas
kernels run in interpret mode, as ``test_kernels.py`` runs them. Inputs come
from numpy seeds and reach both packages through ``repro_torch.convert``.
The CUDA kernels themselves are held against the plain versions on a card
by ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps.jacobi3d import stencil_update as jax_stencil_update
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.convert import numpy_dtype, to_numpy, to_torch, torch_dtype
from repro_torch.kernels import LAUNCHES, ops


def _faces(rng, shape):
    x, y, z = shape
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((y, z), (y, z), (x, z), (x, z), (x, y), (x, y))]


# ---------------------------------------------------------------------------
# state conversion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.uint8, np.bool_, jnp.bfloat16])
def test_convert_round_trip_is_bit_exact(dtype):
    src = np.random.default_rng(0).standard_normal((5, 7)) * 100
    # numpy arrays; a bfloat16 one as JAX hands it out
    arr = np.asarray(jnp.asarray(src, dtype)) if dtype is jnp.bfloat16 \
        else src.astype(dtype)
    t = to_torch(arr)
    assert t.dtype == torch_dtype(arr.dtype)
    assert numpy_dtype(t.dtype) == arr.dtype
    back = to_numpy(t)
    assert back.dtype == arr.dtype
    np.testing.assert_array_equal(back.view(np.uint8), arr.view(np.uint8))


def test_convert_bfloat16_rounds_like_jax():
    """bf16 from JAX reaches torch with the same bits torch would round
    to itself (round to nearest even)."""
    src = np.random.default_rng(1).standard_normal(1000).astype(np.float32)
    via_jax = to_torch(np.asarray(jnp.asarray(src, jnp.bfloat16)))
    via_torch = torch.from_numpy(src).to(torch.bfloat16)
    assert torch.equal(via_jax, via_torch)


# ---------------------------------------------------------------------------
# Jacobi-3D
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,bx", [((18, 10, 12), 4), ((34, 18, 18), 8),
                                      ((10, 34, 6), 8)])
def test_jacobi3d_plain_matches_pallas_and_ref(shape, bx):
    u = np.random.default_rng(42).standard_normal(shape).astype(np.float32)
    got = to_numpy(ops.jacobi3d_plain(to_torch(u)))
    pallas = np.asarray(jops.jacobi3d(jnp.asarray(u), bx=bx))
    oracle = np.asarray(jref.jacobi3d_ref(jnp.asarray(u)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 6, 4), (5, 7, 9), (1, 3, 2)])
def test_jacobi3d_faces_plain_matches_jax_stencil_update(shape):
    rng = np.random.default_rng(7)
    u = rng.standard_normal(shape).astype(np.float32)
    faces = _faces(rng, shape)
    got = to_numpy(ops.jacobi3d_faces_plain(
        to_torch(u), *(to_torch(f) for f in faces)))
    want = np.asarray(jax_stencil_update(
        jnp.asarray(u), *(jnp.asarray(f) for f in faces)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16])
@pytest.mark.parametrize("shape,bx", [((18, 10, 12), 4), ((10, 34, 6), 8)])
def test_jacobi3d_half_types_match_pallas(shape, bx, dtype):
    """The Pallas kernel takes any float type and writes in it; so do the
    port's wrappers (bf16 and f16 kernels on the card). Within 2e-2: XLA on
    the CPU may keep excess precision between the bf16 adds, which PyTorch
    rounds one by one; bit identity is the card test's job, against plain."""
    rng = np.random.default_rng(9)
    u = jnp.asarray(rng.standard_normal(shape), dtype)
    x, y, z = (n - 2 for n in shape)
    faces = [jnp.asarray(f, dtype) for f in _faces(rng, (x, y, z))]
    got = ops.jacobi3d(to_torch(np.asarray(u)))
    assert got.dtype == torch_dtype(np.dtype(dtype))
    pallas = np.asarray(jops.jacobi3d(u, bx=bx), np.float32)
    np.testing.assert_allclose(to_numpy(got.float()), pallas, rtol=2e-2,
                               atol=2e-2)
    interior = u[1:-1, 1:-1, 1:-1]
    got_f = ops.jacobi3d_faces(to_torch(np.asarray(interior)),
                               *(to_torch(np.asarray(f)) for f in faces))
    assert got_f.dtype == got.dtype
    want_f = np.asarray(jax_stencil_update(interior, *faces), np.float32)
    np.testing.assert_allclose(to_numpy(got_f.float()), want_f, rtol=2e-2,
                               atol=2e-2)


def test_faces_variant_equals_padded_variant():
    """Both entry points compute one function: the faces kernel on a chunk
    equals the padded kernel on that chunk padded with its faces."""
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal((6, 5, 4)).astype(np.float32))
    faces = [torch.from_numpy(f) for f in _faces(rng, (6, 5, 4))]
    up = torch.nn.functional.pad(u, (1,) * 6)
    up[0, 1:-1, 1:-1], up[-1, 1:-1, 1:-1] = faces[0], faces[1]
    up[1:-1, 0, 1:-1], up[1:-1, -1, 1:-1] = faces[2], faces[3]
    up[1:-1, 1:-1, 0], up[1:-1, 1:-1, -1] = faces[4], faces[5]
    assert torch.equal(ops.jacobi3d_faces_plain(u, *faces),
                       ops.jacobi3d_plain(up))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    rng = np.random.default_rng(5)
    u = torch.from_numpy(rng.standard_normal((6, 5, 4)).astype(np.float32))
    faces = [torch.from_numpy(f) for f in _faces(rng, (6, 5, 4))]
    a = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    before = dict(LAUNCHES)
    assert torch.equal(ops.jacobi3d_faces(u, *faces),
                       ops.jacobi3d_faces_plain(u, *faces))
    assert torch.equal(ops.jacobi3d(u), ops.jacobi3d_plain(u))
    assert torch.equal(ops.matmul(a, b), ops.matmul_plain(a, b))
    assert LAUNCHES == before


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 384),
                                   (128, 512, 256), (64, 48, 384),
                                   (384, 16, 64), (100, 64, 64),
                                   (32, 16, 32), (96, 12, 40)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_matmul_plain_matches_pallas(m, k, n, dtype):
    """Square and non-square shapes, with M, N and K distinct and a K
    below the card kernel's 64-deep step (48, 16), that the Pallas block
    sizes divide; and dims below 128 that are not multiples of 64 (Pallas
    takes them as one block: bm = 100, bk = 12, bn = 40), which the card
    wrapper now takes too (the bf16 ones with K = 12 on its FMA arm)."""
    rng = np.random.default_rng(11)
    # round to the working dtype once, in JAX; both sides get those bits
    ja = jnp.asarray(rng.standard_normal((m, k)), dtype)
    jb = jnp.asarray(rng.standard_normal((k, n)), dtype)
    got = ops.matmul_plain(to_torch(np.asarray(ja)), to_torch(np.asarray(jb)))
    assert got.dtype == torch_dtype(np.dtype(dtype))
    want = np.asarray(jops.matmul(ja, jb), np.float32)
    oracle = np.asarray(jref.matmul_ref(ja, jb), np.float32)
    tol = 2e-2 if dtype == jnp.bfloat16 else 1e-3
    got = to_numpy(got.float())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)
