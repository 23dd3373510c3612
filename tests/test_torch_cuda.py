"""The port on a CUDA card: each kernel against its plain PyTorch version,
the Device API's stream and event contracts, and the runtime driving the
kernels. Every test skips where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.apps import jacobi3d as app
from repro_torch.convert import to_torch
from repro_torch.core import Runtime, RuntimeConfig
from repro_torch.core.device_api import discover_devices, transfer
from repro_torch.kernels import LAUNCHES, ops

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _faces(rng, shape):
    x, y, z = shape
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((y, z), (y, z), (x, z), (x, z), (x, y), (x, y))]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(18, 10, 12), (3, 70, 33)])
def test_jacobi3d_equals_plain(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(0)
    u_pad = torch.randn(shape, generator=g, device=cuda)
    n = LAUNCHES["jacobi3d"]
    got = ops.jacobi3d(u_pad)
    assert LAUNCHES["jacobi3d"] == n + 1
    assert torch.equal(got, ops.jacobi3d_plain(u_pad))


@pytest.mark.parametrize("shape", [(8, 6, 4), (5, 40, 33), (70, 33, 65),
                                   (1, 1, 1)])
def test_jacobi3d_faces_equals_plain(cuda, shape):
    rng = np.random.default_rng(1)
    u = to_torch(rng.standard_normal(shape).astype(np.float32), cuda)
    faces = [to_torch(f, cuda) for f in _faces(rng, shape)]
    n = LAUNCHES["jacobi3d_faces"]
    got = ops.jacobi3d_faces(u, *faces)
    assert LAUNCHES["jacobi3d_faces"] == n + 1
    assert torch.equal(got, ops.jacobi3d_faces_plain(u, *faces))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
def test_matmul_close_to_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((128, 512), generator=g, device=cuda).to(dtype)
    b = torch.randn((512, 192), generator=g, device=cuda).to(dtype)
    n = LAUNCHES["matmul"]
    got = ops.matmul(a, b)
    assert LAUNCHES["matmul"] == n + 1
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ops.matmul_plain(a, b).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n", [(4096, 4096, 4096), (192, 48, 320)])
def test_matmul_close_to_plain_at_main_and_edge_shapes(cuda, dtype, tol, m, k,
                                                       n):
    """The DGEMM's 4096^3, and a shape whose N is not a multiple of the
    float32 kernel's 128-wide tile (an edge tile reads clamped columns and
    stores only the ones inside)."""
    g = torch.Generator(device=cuda).manual_seed(m + n + k)
    a = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    b = torch.randn((k, n), generator=g, device=cuda).to(dtype)
    got = ops.matmul(a, b)
    assert got.shape == (m, n) and got.dtype == dtype
    torch.testing.assert_close(got.float(), ops.matmul_plain(a, b).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n", [(64, 16, 64), (192, 48, 320),
                                   (320, 1040, 192), (4096, 4096, 4096),
                                   (256, 8192, 512)])
def test_matmul_bf16_close_to_plain_at_tile_edges(cuda, m, k, n):
    """The wgmma arm at its edges, M, N and K distinct where they can be:
    K below, at and past a 64-deep step (TMA fills the tail with zeros),
    M and N tiles that overhang the 128 x 256 output tile, a K of 8192. A
    B operand read K-major, or a wrong descriptor stride, gives wrong
    numbers at every one of these shapes."""
    g = torch.Generator(device=cuda).manual_seed(m * 7 + k * 3 + n)
    a = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    b = torch.randn((k, n), generator=g, device=cuda).to(torch.bfloat16)
    before = LAUNCHES["matmul"]
    got = ops.matmul(a, b)
    assert LAUNCHES["matmul"] == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ops.matmul_plain(a, b).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(8, 6, 4), (5, 40, 33), (70, 33, 65)])
def test_jacobi3d_half_types_equal_plain(cuda, dtype, shape):
    """Both entry points in bf16 and f16: the kernel rounds each add and
    the division to the type as PyTorch's elementwise ops do, so the two
    agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    u_pad = torch.randn(tuple(n + 2 for n in shape), generator=g,
                        device=cuda).to(dtype)
    u = torch.randn(shape, generator=g, device=cuda).to(dtype)
    x, y, z = shape
    faces = [torch.randn(f, generator=g, device=cuda).to(dtype)
             for f in ((y, z), (y, z), (x, z), (x, z), (x, y), (x, y))]
    n, nf = LAUNCHES["jacobi3d"], LAUNCHES["jacobi3d_faces"]
    got = ops.jacobi3d(u_pad)
    got_f = ops.jacobi3d_faces(u, *faces)
    assert (LAUNCHES["jacobi3d"], LAUNCHES["jacobi3d_faces"]) == (n + 1,
                                                                 nf + 1)
    assert got.dtype == got_f.dtype == dtype
    assert torch.equal(got, ops.jacobi3d_plain(u_pad))
    assert torch.equal(got_f, ops.jacobi3d_faces_plain(u, *faces))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n", [(100, 64, 64), (32, 16, 32), (96, 12, 40),
                                   (130, 200, 70), (64, 24, 72), (1, 1, 1)])
def test_matmul_close_to_plain_at_ragged_shapes(cuda, dtype, tol, m, k, n):
    """Shapes the Pallas kernel takes (any dim up to 128) and more: the
    float32 SGEMM's edge-safe loads, the bf16 wgmma arm at K and N that are
    multiples of 8 but not of 64 (64 x 24 x 72), and the bf16 FMA arm where
    TMA cannot describe the rows (K = 12, N = 40 is a multiple of 8 but K
    is not; N = 70)."""
    g = torch.Generator(device=cuda).manual_seed(m + 3 * k + 7 * n)
    a = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    b = torch.randn((k, n), generator=g, device=cuda).to(dtype)
    before = LAUNCHES["matmul"]
    got = ops.matmul(a, b)
    assert LAUNCHES["matmul"] == before + 1
    assert got.shape == (m, n) and got.dtype == dtype
    torch.testing.assert_close(got.float(), ops.matmul_plain(a, b).float(),
                               rtol=tol, atol=tol)


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    """Inputs the Pallas entry points refuse too."""
    a = torch.ones((100, 64), device=cuda)
    with pytest.raises(ValueError):
        ops.matmul(a, torch.ones((32, 64), device=cuda))     # K mismatch
    with pytest.raises(ValueError):
        ops.matmul(a.int(), torch.ones((64, 64), device=cuda).int())
    with pytest.raises(ValueError):
        ops.jacobi3d(torch.ones((6, 6, 6), device=cuda).double())
    u = torch.ones((4, 4, 4), device=cuda)
    with pytest.raises(ValueError):
        ops.jacobi3d_faces(u, *[torch.ones((4, 3), device=cuda)] * 6)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,t,d,causal", [(128, 128, 64, True),
                                          (256, 128, 8, False),
                                          (64, 192, 12, True),
                                          (192, 192, 128, True)])
def test_flash_attention_close_to_plain(cuda, dtype, tol, s, t, d, causal):
    """The Pallas contract [BH, S, D]; the plain version walks the same
    64-wide kv tiles, so only the sum order inside a dot product differs
    (f32), and where that flips a bf16 rounding of p or of the output, a
    bf16 ulp (bf16)."""
    g = torch.Generator(device=cuda).manual_seed(s + t + d)
    q, k, v = (torch.randn((3, n, d), generator=g, device=cuda).to(dtype)
               for n in (s, t, t))
    n = LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert LAUNCHES["flash_attention"] == n + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ops.flash_attention_plain(q[:, :, None, None], k[:, :, None],
                                     v[:, :, None], causal=causal)[:, :, 0, 0]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,t,d,causal", [(32, 32, 64, True),
                                          (96, 96, 128, True),
                                          (96, 128, 64, False),
                                          (100, 150, 12, True),
                                          (150, 100, 8, False),
                                          (1, 1, 16, True)])
def test_flash_attention_close_to_plain_at_ragged_lengths(cuda, dtype, tol, s,
                                                          t, d, causal):
    """S and T that are not multiples of the 64-row tiles, which the Pallas
    kernel takes up to 128 (one block of S or T rows): Q rows past S load
    as zeros and are not stored, K and V rows past T load as zeros and
    score NEG_INF. Both entry points; the plain version cuts its last
    blocks short the same way."""
    gen = torch.Generator(device=cuda).manual_seed(s * 3 + t + d)
    q = torch.randn((2, s, 2, 4, d), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((2, t, 2, d), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    n = LAUNCHES["flash_attention"]
    got = ops.flash_attention_gqa(q, k, v, causal=causal)
    folded = ops.flash_attention(q[:, :, 0, 0].contiguous(),
                                 k[:, :, 0].contiguous(),
                                 v[:, :, 0].contiguous(), causal=causal)
    assert LAUNCHES["flash_attention"] == n + 2
    want = ops.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(folded.float(), want[:, :, 0, 0].float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("g", [1, 4, 8])
def test_flash_attention_gqa_close_to_plain(cuda, g):
    gen = torch.Generator(device=cuda).manual_seed(g)
    q = torch.randn((2, 256, 2, g, 128), generator=gen, device=cuda)
    k, v = (torch.randn((2, 256, 2, 128), generator=gen, device=cuda)
            for _ in range(2))
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))
        got = ops.flash_attention_gqa(qq, kk, vv)
        want = ops.flash_attention_plain(qq, kk, vv)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("d", [8, 12, 64, 128, 130, 160, 256])
@pytest.mark.parametrize("s,t,causal", [(128, 192, True), (192, 128, True),
                                        (128, 256, False), (256, 64, False)])
def test_flash_gqa_bf16_close_to_plain(cuda, g, d, s, t, causal):
    """The tensor-core arm at its limits: head dims below, between and at
    its two compiled widths (8 and 12 load element by element), past them
    (the column-group kernel; 130 loads element by element, 160 ends in a
    partial column group), S != T with and without the causal mask, one
    and eight query heads a KV head."""
    gen = torch.Generator(device=cuda).manual_seed(g * 1000 + d + s + t)
    q = torch.randn((2, s, 2, g, d), generator=gen, device=cuda)
    k, v = (torch.randn((2, t, 2, d), generator=gen, device=cuda)
            for _ in range(2))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    n = LAUNCHES["flash_attention"]
    got = ops.flash_attention_gqa(q, k, v, causal=causal)
    assert LAUNCHES["flash_attention"] == n + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = ops.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("d", [8, 12, 64, 128, 130, 160, 256])
@pytest.mark.parametrize("s,t,causal", [(128, 192, True), (192, 128, True),
                                        (128, 256, False), (256, 64, False)])
def test_flash_f32_close_to_plain(cuda, g, d, s, t, causal):
    """The float32 arm at its limits, through both entry points: head dims
    below, between and at its two compiled widths and past them (the
    column-group kernel), S != T with and without
    the causal mask (a last 64-row q tile in a 128-row block at S = 192),
    one and eight query heads a KV head; then the same heads folded into
    the Pallas contract [BH, S, D]."""
    gen = torch.Generator(device=cuda).manual_seed(g * 1000 + d + s + t + 1)
    q = torch.randn((2, s, 2, g, d), generator=gen, device=cuda)
    k, v = (torch.randn((2, t, 2, d), generator=gen, device=cuda)
            for _ in range(2))
    n = LAUNCHES["flash_attention"]
    got = ops.flash_attention_gqa(q, k, v, causal=causal)
    assert LAUNCHES["flash_attention"] == n + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = ops.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    bh = 2 * 2 * g
    qf = q.permute(0, 2, 3, 1, 4).reshape(bh, s, d).contiguous()
    kf, vf = (x.permute(0, 2, 1, 3)[:, :, None].expand(2, 2, g, t, d)
              .reshape(bh, t, d).contiguous() for x in (k, v))
    got = ops.flash_attention(qf, kf, vf, causal=causal)
    want = want.permute(0, 2, 3, 1, 4).reshape(bh, s, d)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_flash_wrapper_raises_on_misaligned_operands(cuda):
    """A contiguous view two bytes into its storage is not 16-byte aligned:
    the wrapper raises before cp.async or ldmatrix could fault."""
    shape = (2, 128, 64)
    buf = torch.zeros(2 * 128 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    y = torch.zeros(shape, dtype=torch.bfloat16, device=cuda)
    for args in ((x, y, y), (y, x, y), (y, y, x)):
        with pytest.raises(ValueError, match="aligned"):
            ops.flash_attention(*args)


def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    """Head dims past 128 run through a kernel, as the Pallas entry takes
    any D; what both sides refuse (operands of different dtypes, a
    transposed operand) raises."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for shape in ((2, 96, 256), (2, 128, 160)):
        x, y, w = (torch.randn(shape, generator=gen, device=cuda)
                   for _ in range(3))
        n = LAUNCHES["flash_attention"]
        got = ops.flash_attention(x, y, w)
        assert LAUNCHES["flash_attention"] == n + 1
        want = ops.flash_attention_plain(x[:, :, None, None], y[:, :, None],
                                         w[:, :, None])[:, :, 0, 0]
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    z = torch.ones((2, 128, 64), device=cuda)
    with pytest.raises(ValueError):
        ops.flash_attention(z, z.half(), z)
    with pytest.raises(ValueError):
        ops.flash_attention(z, z.transpose(1, 2).contiguous().transpose(1, 2),
                            z)


def test_serve_prefill_goes_through_the_kernel(cuda):
    """A smoke model on the card: one kernel launch per layer in a prefill
    of 128 tokens, and the same hidden state as the plain path."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    cfg = get_smoke_config("yi-9b")
    on = build_smoke(cfg, use_flash_kernel=True)
    off = build_smoke(cfg)
    params = on.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 128), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    n = LAUNCHES["flash_attention"]
    x_on, _ = on.apply(params, {"tokens": toks}, mode="prefill")
    assert LAUNCHES["flash_attention"] == n + cfg.n_layers
    x_off, _ = off.apply(params, {"tokens": toks}, mode="prefill")
    torch.testing.assert_close(x_on, x_off, rtol=1e-4, atol=1e-4)
    out = Engine(on, params, 2, 136).generate(toks, 8)
    assert out.shape == (2, 8) and out.device.type == "cuda"


def test_mamba2_prefill_goes_through_the_ssd_kernel(cuda):
    """The mamba2 smoke model on the card: one ``ssd_chunk`` launch per
    layer in a prefill of 40 tokens (two chunks of 16 and a padded third),
    none in decode, and the same hidden state as the einsum path."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    cfg = get_smoke_config("mamba2-370m")
    on = build_smoke(cfg, use_ssd_kernel=True)
    off = build_smoke(cfg)
    params = on.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    n = LAUNCHES["ssd_chunk"]
    x_on, _ = on.apply(params, {"tokens": toks}, mode="prefill")
    assert LAUNCHES["ssd_chunk"] == n + cfg.n_layers
    x_off, _ = off.apply(params, {"tokens": toks}, mode="prefill")
    torch.testing.assert_close(x_on, x_off, rtol=1e-4, atol=1e-4)
    out = Engine(on, params, 2, 48).generate(toks, 8)
    assert LAUNCHES["ssd_chunk"] == n + 2 * cfg.n_layers
    assert out.shape == (2, 8) and out.device.type == "cuda"


def _ssd_inputs(gen, bc, q, h, p, n, a_sign=None):
    """x, dt, A, B, C on the card as the mamba2 block draws dt (softplus
    around log(expm1(0.01)) plus a spread, so |dt·A| reaches past 88 inside
    a chunk at A = -16) and A (-linspace(1, 16)); ``a_sign`` flips A's sign
    per head."""
    F = torch.nn.functional
    x = torch.randn((bc, q, h, p), generator=gen, device="cuda")
    dt = F.softplus(torch.randn((bc, q, h), generator=gen, device="cuda")
                    + float(np.log(np.expm1(0.01))))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    if a_sign is not None:
        A = A * torch.tensor(a_sign, dtype=torch.float32, device="cuda")
    B = torch.randn((bc, q, n), generator=gen, device="cuda")
    C = torch.randn((bc, q, n), generator=gen, device="cuda")
    return x, dt, A, B, C


@pytest.mark.parametrize("shape,a_sign", [
    ((2, 512, 4, 128, 256), None), ((3, 100, 5, 96, 200), None),
    ((4, 256, 4, 64, 128), [1.0, -0.05, 1.0, -0.05]),
    ((2, 130, 3, 5, 7), [-1.0, 0.02, -1.0])])
def test_ssd_chunk_kernel_takes_any_shape(cuda, shape, a_sign):
    """Q, P and N past the first design's limits, ragged tiles, and heads
    whose cs increases (A > 0), which take the direct form off the
    diagonal: within 1e-4 of the largest magnitude of the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    args = _ssd_inputs(gen, *shape, a_sign)
    before = LAUNCHES["ssd_chunk"]
    y, st = ops.ssd_chunk(*args)
    assert LAUNCHES["ssd_chunk"] == before + 1
    want_y, want_st = ops.ssd_chunk_plain(*args)
    for got, want in ((y, want_y), (st, want_st)):
        assert bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err


# ---------------------------------------------------------------------------
# Device API and runtime
# ---------------------------------------------------------------------------

def test_device_contracts(cuda):
    dev = discover_devices(memory_capacity=1 << 30)[0]
    assert dev.is_cuda and dev.info.device_type == "gpu"
    host = np.arange(1 << 16, dtype=np.float32)
    t = dev.upload(host)
    host[...] = 0.0                   # upload never aliases the host buffer
    assert dev.synchronize(t) is t and dev.is_ready(t)
    snap = dev.clone(t)
    out = dev.launch(lambda u: u.mul_(2.0), (t,), donate=(0,))
    dev.synchronize(out)
    np.testing.assert_array_equal(dev.download(snap), np.arange(1 << 16))
    np.testing.assert_array_equal(dev.download(out), 2.0 * np.arange(1 << 16))
    view = dev.launch(lambda u: u[:4], (out,), donate=())
    assert view.untyped_storage().data_ptr() != \
        out.untyped_storage().data_ptr()


def test_runtime_chunked_upload_and_chain(cuda):
    with Runtime(RuntimeConfig(memory_capacity=1 << 30,
                               staging_chunk_bytes=1 << 12)) as rt:
        assert rt.staging.pinned
        data = np.random.default_rng(0).random((256, 64)).astype(np.float32)
        x = rt.hetero_object(data.copy())
        for _ in range(5):
            rt.run(lambda v: v + 1.0, [(x, "rw")])
        rt.barrier()
        want = data
        for _ in range(5):
            want = want + np.float32(1.0)
        np.testing.assert_array_equal(x.get(), want)
        assert rt.stats()["transfers_h2d"] == 1


def test_run_tasked_equals_reference_and_launches_the_kernel(cuda):
    u0 = np.random.default_rng(2).random((32, 24, 16)).astype(np.float32)
    with Runtime(RuntimeConfig(memory_capacity=1 << 30)) as rt:
        before = LAUNCHES["jacobi3d_faces"]
        got = app.run_tasked(u0, 4, rt, over_decomposition=8)
        launched = LAUNCHES["jacobi3d_faces"] - before
        n_dev = len(rt.devices)
    assert launched == 8 * n_dev * 4
    np.testing.assert_array_equal(got, app.run_reference(u0, 4))


def test_peer_copies_between_cards(cuda):
    """Across cards: a direct peer copy round trip, and the proxy spread
    over every card, whose halos then travel card to card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    devs = discover_devices(memory_capacity=1 << 30)
    host = np.arange(1 << 20, dtype=np.float32)
    on0 = devs[0].upload(host)
    on1 = transfer(devs[0], devs[1], on0)
    assert on1.device == devs[1].torch_device
    np.testing.assert_array_equal(devs[1].download(on1), host)

    u0 = np.random.default_rng(5).random((64, 48, 32)).astype(np.float32)
    with Runtime(RuntimeConfig(memory_capacity=1 << 30)) as rt:
        got = app.run_tasked(u0, 3, rt, over_decomposition=2)
        stats = rt.stats()
    assert stats["transfers_d2d"] > 0
    np.testing.assert_array_equal(got, app.run_reference(u0, 3))


# ---------------------------------------------------------------------------
# task-graph replay as CUDA graphs
# ---------------------------------------------------------------------------

def test_traced_run_tasked_replays_cuda_graphs(cuda):
    """Windows 4.. replay a captured CUDA graph: bit for bit the
    interpreted run, and every replay adds the stencil launches its
    capture recorded."""
    u0 = np.random.default_rng(6).random((32, 24, 16)).astype(np.float32)
    iters = 8
    with Runtime(RuntimeConfig(memory_capacity=1 << 30,
                               trace_graphs=True)) as rt:
        before = LAUNCHES["jacobi3d_faces"]
        got = app.run_tasked(u0, iters, rt, over_decomposition=8)
        launched = LAUNCHES["jacobi3d_faces"] - before
        st = rt.stats()
        n_dev = len(rt.devices)
    assert st["graph_replays"] == iters - 3 and st["graph_invalidations"] == 0
    assert launched == 8 * n_dev * iters
    np.testing.assert_array_equal(got, app.run_reference(u0, iters))


@pytest.mark.parametrize("arch,flag", [("yi-9b", "use_flash_kernel"),
                                       ("mamba2-370m", "use_ssd_kernel")])
def test_traced_tasked_decode_equals_interpreted(cuda, arch, flag):
    """The tasked decode loop of a smoke model under trace_graphs: the
    graph writes the adopted cache in place (never copied) and gives the
    interpreted loop's tokens and cache bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    from repro_torch.serve import tasked_decode_loop
    cfg = get_smoke_config(arch)
    model = build_smoke(cfg, **{flag: True})
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    nxt, cache = Engine(model, params, 2, 80).prefill(toks)
    out = {}
    for traced in (False, True):
        c = {k: v.clone() for k, v in cache.items()}
        with Runtime(RuntimeConfig(trace_graphs=traced)) as rt:
            tok, lens, c_objs = tasked_decode_loop(
                rt, model, params, c, nxt.clone(),
                torch.full((2,), 64, dtype=torch.int32, device=cuda), 10)
            out[traced] = (tok.get(), lens.get(),
                           {k: c_objs[k].get() for k in c})
            if traced:
                assert rt.stats()["graph_replays"] == 10 - 3
                assert all(c_objs[k].copies[0].data_ptr() == c[k].data_ptr()
                           for k in c)
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])
    for k in cache:
        np.testing.assert_array_equal(out[True][2][k], out[False][2][k])


# ---------------------------------------------------------------------------
# the message engine on the card
# ---------------------------------------------------------------------------

def test_run_cluster_on_the_card_equals_reference(cuda):
    """Four ranks share the card: slabs scatter and gather on rendezvous
    streams into device slabs, halos travel DIRECT."""
    from repro_torch.distributed import Cluster
    u0 = np.random.default_rng(8).random((64, 48, 40)).astype(np.float32)
    cfg = RuntimeConfig(memory_capacity=1 << 30, eager_threshold=16 << 10,
                        chunk_bytes=64 << 10)
    with Cluster(4, cfg) as c:
        got = app.run_cluster(u0, 3, c)
        stats = [dict(r.stats) for r in c.ranks]
    np.testing.assert_array_equal(got, app.run_reference(u0, 3))
    assert stats[0]["rendezvous"] == 3
    assert all(s["bytes_d2d"] > 0 for s in stats)


def test_direct_put_between_cards(cuda):
    """A DIRECT put from a rank's card 0 lands on the receiver's card 1
    (consumer-routed) as a multi-chunk rendezvous stream into a slab on
    that card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    from repro_torch.distributed import Cluster, handler
    done = []

    @handler(name="cuda_put_done")
    def _done(ctx, obj):
        done.append(obj)

    cfg = RuntimeConfig(memory_capacity=1 << 30, chunk_bytes=1 << 20)
    with Cluster(2, cfg) as c:
        r0, r1 = c.ranks
        data = np.random.default_rng(9).random(1 << 22).astype(np.float32)
        target = r1.runtime.hetero_object(np.zeros_like(data))
        r1.register_object("tgt", target)
        src = r0.runtime.hetero_object(data)
        r0.runtime.run(lambda v: v * 2.0, [(src, "rw")], device_type="gpu")
        r0.runtime.barrier()
        r0.put(1, "tgt", src, on_done="cuda_put_done", path="direct",
               consumer_device=1)
        c.barrier()
        assert done and target.resident_devices() == {1}
        np.testing.assert_array_equal(target.get(), data * 2.0)
        assert r1.stats["chunks_in"] == 16 and r1.stats["bytes_staged"] == 0


def _wrapper_cases(dev):
    g = torch.Generator(device=dev).manual_seed(12)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    bf = torch.bfloat16
    return {
        "jacobi3d": (ops.jacobi3d, (r(20, 18, 16),)),
        "jacobi3d_faces": (ops.jacobi3d_faces,
                           (r(16, 12, 8), r(12, 8), r(12, 8), r(16, 8),
                            r(16, 8), r(16, 12), r(16, 12))),
        "matmul_f32": (ops.matmul, (r(128, 96), r(96, 192))),
        "matmul_bf16_tma": (ops.matmul, (r(256, 128, dtype=bf),
                                         r(128, 256, dtype=bf))),
        "flash_bf16": (ops.flash_attention_gqa,
                       (r(1, 128, 2, 2, 64, dtype=bf), r(1, 128, 2, 64, dtype=bf),
                        r(1, 128, 2, 64, dtype=bf))),
        "flash_f32_d256": (ops.flash_attention,
                           (r(2, 96, 256), r(2, 96, 256), r(2, 96, 256))),
        "ssd_chunk": (ops.ssd_chunk,
                      (r(2, 32, 2, 16), r(2, 32, 2).abs() * 0.1,
                       -r(2).abs(), r(2, 32, 8), r(2, 32, 8))),
    }


@pytest.mark.parametrize("name", ["jacobi3d", "jacobi3d_faces", "matmul_f32",
                                  "matmul_bf16_tma", "flash_bf16",
                                  "flash_f32_d256", "ssd_chunk"])
def test_each_wrapper_replays_under_cuda_graph_capture(cuda, name):
    """Every kernel wrapper stays legal under stream capture (no host sync,
    no allocation outside the graph's pool; the bf16 matmul's TMA
    descriptors travel by value): captured once, its replay gives the
    eager call's bits, and the capture counts no launch."""
    from repro_torch import kernels
    fn, args = _wrapper_cases(cuda)[name]
    want = fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(LAUNCHES)
    with kernels.recording_launches() as rec, \
            torch.cuda.graph(graph, capture_error_mode="thread_local"):
        got = fn(*args)
    assert LAUNCHES == before and sum(rec.values()) == 1
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,),
                    strict=True):
        assert torch.equal(a, b)


def test_capture_failure_fails_the_window(cuda):
    """A chain the CUDA graph cannot capture (a host sync) fails its
    window's futures and drops the graph; it never runs interpreted
    behind the caller's back."""
    def synced(v):
        return v + v.sum().item()

    with Runtime(RuntimeConfig(trace_graphs=True, replay_after=2)) as rt:
        a = rt.hetero_object(np.ones(8, np.float32))
        for _ in range(2):
            rt.run(synced, [(a, "rw")])
            rt.step_boundary()
        t = rt.run(synced, [(a, "rw")])
        rt.step_boundary()
        with pytest.raises(Exception):
            t.future.get(30)
        st = rt.stats()
    assert st["graphs_traced"] == 1 and st["graph_replays"] == 0
    assert st["graph_invalidations"] == 1
