"""The port on a CUDA card: each kernel against its plain PyTorch version,
the Device API's stream and event contracts, and the runtime driving the
kernels. Every test skips where there is no card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import copy

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
                                          (1, 1, 16, True),
                                          (1, 1, 256, True),
                                          (150, 100, 192, False)])
def test_flash_attention_close_to_plain_at_ragged_lengths(cuda, dtype, tol, s,
                                                          t, d, causal):
    """S and T that are not multiples of the kernels' tiles (64 rows; 128 q
    and 80 kv rows in the bf16 one-pass kernel), which the Pallas kernel
    takes up to 128 (one block of S or T rows): Q rows past S load as zeros
    and are not stored, K and V rows past T load as zeros and score
    NEG_INF. Both entry points; the plain version cuts its last blocks
    short the same way."""
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


@pytest.mark.parametrize("kh,g", [(16, 1), (8, 5)])
def test_flash_gqa_at_the_moe_head_layouts(cuda, kh, g):
    """olmoe-1b-7b's heads (16 KV heads of one query head) and
    llama4-scout's (8 of 5), causal, D = 128: one launch a call, within
    the kernel's bounds of the plain version in both dtypes."""
    gen = torch.Generator(device=cuda).manual_seed(kh + g)
    q = torch.randn((2, 384, kh, g, 128), generator=gen, device=cuda)
    k, v = (torch.randn((2, 384, kh, 128), generator=gen, device=cuda)
            for _ in range(2))
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        qq, kk, vv = (x.to(dtype) for x in (q, k, v))
        n = LAUNCHES["flash_attention"]
        got = ops.flash_attention_gqa(qq, kk, vv)
        assert LAUNCHES["flash_attention"] == n + 1
        want = ops.flash_attention_plain(qq, kk, vv)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("d", [8, 12, 64, 128, 130, 136, 160, 192, 200, 256,
                               264])
@pytest.mark.parametrize("s,t,causal", [(128, 192, True), (192, 128, True),
                                        (128, 256, False), (256, 64, False),
                                        (200, 200, True)])
def test_flash_gqa_bf16_close_to_plain(cuda, g, d, s, t, causal):
    """The tensor-core arm at its limits: head dims below, between and at
    the two compiled widths of the D <= 128 kernel (8 and 12 load element
    by element); inside the one-pass wgmma kernel (136, 160 and 192 in
    three 64-column boxes, the last one partial at 136 and 160; 200 and 256
    in four) and past it (the column-group kernel: 130, whose rows TMA
    cannot describe, and 264); S != T with and without the causal mask, S
    = T = 200 (ragged q and kv tiles on the diagonal), one and eight query
    heads a KV head."""
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
@pytest.mark.parametrize("d", [8, 12, 64, 128, 130, 136, 160, 192, 200, 256,
                               264])
@pytest.mark.parametrize("s,t,causal", [(128, 192, True), (192, 128, True),
                                        (128, 256, False), (256, 64, False),
                                        (200, 200, True)])
def test_flash_f32_close_to_plain(cuda, g, d, s, t, causal):
    """The float32 arm at its limits, through both entry points: head dims
    below, between and at the two compiled widths of the D <= 128 kernel,
    inside the one-pass kernel (136 to 256) and past it (the column-group
    kernel: 130, whose rows are not 16-byte multiples, and 264), S != T
    with and without the causal mask (a last 64-row q tile in a 128-row
    block at S = 192), S = T = 200 (ragged tiles on the diagonal), one and
    eight query heads a KV head; then the same heads folded into the Pallas
    contract [BH, S, D]."""
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


def test_whisper_smoke_on_the_card_equals_the_cpu(cuda):
    """The whisper smoke model on the card against the same weights on the
    CPU: no kernel launch (the encoder-decoder's attention is the plain
    blockwise path, as in the JAX package), the prefill's hidden state and
    both caches, and 8 greedy tokens, with frames shorter than
    ``encoder_seq``; and the decode loop replayed as CUDA graphs equal to
    the interpreted one."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    from repro_torch.serve import flatten, tasked_decode_loop
    cfg = get_smoke_config("whisper-large-v3")
    model = build_smoke(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    params_cpu = copy.deepcopy(params).cpu()
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 16), device=cuda, generator=gen)
    frames = 0.1 * torch.randn((2, 20, cfg.d_model), device=cuda,
                               generator=gen)
    before = dict(LAUNCHES)
    eng = Engine(model, params, 2, 40)
    nxt, cache = eng.prefill(toks, {"frames": frames})
    start = {k: v.clone() for k, v in flatten(cache)}
    out = torch.cat([nxt, eng.decode(cache, nxt, 16, 7)], dim=1)
    assert dict(LAUNCHES) == before
    eng_cpu = Engine(model, params_cpu, 2, 40)
    nxt_cpu, cache_cpu = eng_cpu.prefill(toks.cpu(), {"frames": frames.cpu()})
    for key, v in flatten(cache_cpu):
        torch.testing.assert_close(start[key].cpu(), v, rtol=1e-4, atol=1e-4)
    out_cpu = torch.cat([nxt_cpu, eng_cpu.decode(cache_cpu, nxt_cpu, 16, 7)],
                        dim=1)
    np.testing.assert_array_equal(out.cpu().numpy(), out_cpu.numpy())
    res = {}
    for traced in (False, True):
        c = {"decoder": {kind: {k: start[f"decoder.{kind}.{k}"].clone()
                                for k in ("k", "v")}
                         for kind in ("self", "cross")}}
        with Runtime(RuntimeConfig(trace_graphs=traced)) as rt:
            tok, _, c_objs = tasked_decode_loop(
                rt, model, params, c, nxt.clone(),
                torch.full((2,), 16, dtype=torch.int32, device=cuda), 7)
            res[traced] = (tok.get(), {k: o.get() for k, o in c_objs.items()})
            if traced:
                assert rt.stats()["graph_replays"] == 7 - 3
    np.testing.assert_array_equal(res[True][0], out[:, -1:].cpu().numpy())
    np.testing.assert_array_equal(res[False][0], res[True][0])
    for key, v in flatten(cache):
        np.testing.assert_array_equal(res[True][1][key], v.cpu().numpy())
        np.testing.assert_array_equal(res[False][1][key], v.cpu().numpy())


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
                                       ("mamba2-370m", "use_ssd_kernel"),
                                       ("olmoe-1b-7b", "use_flash_kernel"),
                                       ("llama4-scout-17b-16e",
                                        "use_flash_kernel")])
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


def test_ring_allreduce_bit_exact_on_the_card(cuda):
    """Members' tensors on the card: ring segments and accumulators are
    objects on the card, every hop's add an ``add_`` on the consumer's
    transfer stream; the result equals the numpy oracle bit for bit."""
    from repro_torch.distributed import Cluster, CollectiveGroup
    resident = []

    class Probe(CollectiveGroup):
        def _cleanup(self, op):
            for m, keys in op["keys"].items():
                for key in keys:
                    obj = self.cluster.ranks[m].objects.get(key)
                    if obj is not None:
                        resident.append(obj.resident_devices())
            super()._cleanup(op)

    cfg = RuntimeConfig(memory_capacity=1 << 30, chunk_bytes=64 << 10)
    g = torch.Generator(device=cuda).manual_seed(3)
    with Cluster(4, cfg) as c:
        group = Probe(c)
        for dtype in (torch.float32, torch.int32):
            ins = [(torch.randn(300_001, generator=g, device=cuda) * 100)
                   .to(dtype) for _ in range(4)]
            outs = group.allreduce(ins)
            oracle = group.oracle_allreduce(ins)
            for out, want in zip(outs, oracle):
                assert isinstance(out, np.ndarray)
                np.testing.assert_array_equal(out, want)
        reduced = sum(r.stats["coll_bytes_reduced"] for r in c.ranks)
    assert reduced > 0
    assert resident and all(resident), resident


def test_elastic_kill_revive_on_the_card(cuda, tmp_path):
    """``run_cluster_elastic`` with slabs on the card: a rank killed after
    iteration 1 and revived after 2, its slabs restored from the
    checkpoint onto the card; bit for bit the unfaulted run and
    ``run_reference``, one stencil launch per slab and iteration."""
    from repro_torch.distributed import Cluster
    u0 = np.random.default_rng(10).random((48, 32, 40)).astype(np.float32)
    cfg = RuntimeConfig(memory_capacity=1 << 30, eager_threshold=16 << 10,
                        chunk_bytes=64 << 10)
    outs, launches = [], []
    for knobs in ({}, dict(kill=(2, 1), revive_at=(2, 2),
                           ckpt_dir=str(tmp_path))):
        n = LAUNCHES["jacobi3d_faces"]
        with Cluster(3, cfg) as c:
            # dead after 0.8 s without a beat, before the 1.25 s that
            # would make it a straggler (0.05 s beats, factor 25)
            out, rep = app.run_cluster_elastic(
                u0, 4, c, slabs=6, heartbeat_interval_s=0.05,
                heartbeat_timeout_s=0.8, **knobs)
        outs.append(out)
        launches.append(LAUNCHES["jacobi3d_faces"] - n)
    np.testing.assert_array_equal(outs[0], app.run_reference(u0, 4))
    np.testing.assert_array_equal(outs[1], outs[0])
    assert launches == [24, 24]
    assert rep["elastic"]["recoveries"] == 1 and rep["elastic"]["grows"] >= 1


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import Checkpointer
    g = torch.Generator(device=cuda).manual_seed(4)
    state = {"w": torch.randn(64, 32, generator=g, device=cuda),
             "h": [torch.randn(16, generator=g, device=cuda)
                   .to(torch.bfloat16)]}
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    ckpt.save(0, state)
    ckpt.wait()
    got = ckpt.restore(0, state, device=cuda)
    assert got["w"].device.type == "cuda" and got["w"].dtype == torch.float32
    assert got["h"][0].device.type == "cuda"
    assert got["h"][0].dtype == torch.bfloat16
    assert torch.equal(got["w"], state["w"])
    assert torch.equal(got["h"][0], state["h"][0])


def _wrapper_cases(dev):
    g = torch.Generator(device=dev).manual_seed(12)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    bf = torch.bfloat16
    # a routing of 40 tokens, top-2 of 8 experts, and its plan
    idx = torch.randint(0, 8, (40, 2), generator=g, device=dev)
    rows, tiles = ops.routed_plan_plain(idx, 8)
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
        "flash_bf16_d256": (ops.flash_attention_gqa,
                            (r(1, 128, 2, 2, 256, dtype=bf),
                             r(1, 128, 2, 256, dtype=bf),
                             r(1, 128, 2, 256, dtype=bf))),
        "flash_f32_d256": (ops.flash_attention,
                           (r(2, 96, 256), r(2, 96, 256), r(2, 96, 256))),
        "ssd_chunk": (ops.ssd_chunk,
                      (r(2, 32, 2, 16), r(2, 32, 2).abs() * 0.1,
                       -r(2).abs(), r(2, 32, 8), r(2, 32, 8))),
        "decode_attention": (ops.decode_attention,
                             (r(2, 2, 4, 64, dtype=bf),
                              r(2, 300, 2, 64, dtype=bf),
                              r(2, 300, 2, 64, dtype=bf),
                              torch.tensor([1, 257], dtype=torch.int32,
                                           device=dev))),
        "moe_plan": (ops.routed_plan, (idx, 8)),
        # the routed rows (the padding rows are never written)
        "moe_experts": (lambda *a: ops.moe_experts(*a)[rows.long()],
                        (r(40, 64, dtype=bf), rows, tiles,
                         r(8, 64, 32, dtype=bf), r(8, 64, 32, dtype=bf),
                         r(8, 32, 64, dtype=bf))),
        "moe_combine": (ops.moe_combine,
                        (r(tiles.numel() * 64, 64, dtype=bf), rows,
                         r(40, 2).abs())),
    }


@pytest.mark.parametrize("name", ["jacobi3d", "jacobi3d_faces", "matmul_f32",
                                  "matmul_bf16_tma", "flash_bf16",
                                  "flash_bf16_d256", "flash_f32_d256",
                                  "ssd_chunk", "decode_attention",
                                  "moe_plan", "moe_experts", "moe_combine"])
def test_each_wrapper_replays_under_cuda_graph_capture(cuda, name):
    """Every kernel wrapper stays legal under stream capture (no host sync,
    no allocation outside the graph's pool; the TMA descriptors of the bf16
    matmul and the D = 256 flash kernel travel by value): captured once,
    its replay gives the eager call's bits, and the capture counts no
    launch."""
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


def test_spans_leave_a_captured_decode_bit_for_bit(cuda, monkeypatch):
    """The yi-9b smoke decode loop under trace_graphs recording spans
    replays bit for bit as with recording off: the spans record no CUDA
    event while the capture runs, and the interpreted steps' attention
    layers get their device times."""
    import contextlib

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import spans
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    from repro_torch.serve import tasked_decode_loop
    cfg = get_smoke_config("yi-9b")
    model = build_smoke(cfg, use_flash_kernel=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    nxt, cache = Engine(model, params, 2, 80).prefill(toks)
    record = torch.cuda.Event.record
    in_capture = {False: 0, True: 0}
    on = False

    def watched(self, stream=None):
        in_capture[on] += torch.cuda.is_current_stream_capturing()
        return record(self, stream)
    monkeypatch.setattr(torch.cuda.Event, "record", watched)
    out = {}
    for on in (False, True):
        c = {k: v.clone() for k, v in cache.items()}
        with spans.recording() if on else contextlib.nullcontext():
            with Runtime(RuntimeConfig(trace_graphs=True)) as rt:
                tok, lens, c_objs = tasked_decode_loop(
                    rt, model, params, c, nxt.clone(),
                    torch.full((2,), 64, dtype=torch.int32, device=cuda), 10)
                out[on] = (tok.get(), lens.get(),
                           {k: c_objs[k].get() for k in c})
                st = rt.stats()
        assert st["graph_captures"] == 1 and st["graph_replays"] == 10 - 3
    assert in_capture[True] == in_capture[False]
    for a, b in zip(out[True][:2], out[False][:2], strict=True):
        np.testing.assert_array_equal(a, b)
    for k in cache:
        np.testing.assert_array_equal(out[True][2][k], out[False][2][k])
    recs = spans.records()
    cap, = [r for r in recs if r.name == "taskgraph.capture"]
    captured = [r for r in recs if r.name.startswith("model.")
                and cap.start_ns <= r.start_ns <= r.end_ns <= cap.end_ns]
    assert captured and all(r.device_ms is None for r in captured)
    timed = [r for r in recs if r.name == "model.attention"
             and r.device_ms is not None]
    assert len(timed) == 3 * cfg.n_layers
    assert all(r.device_ms > 0 for r in timed)
    # a worker's launch is timed on the card's compute stream
    launches = [r for r in recs if r.name == "runtime.launch"]
    assert len(launches) == 3
    assert all(r.device_ms is not None and r.device_ms > 0
               for r in launches)


# ---------------------------------------------------------------------------
# the SPMD path and gemma3 serving on the card
# ---------------------------------------------------------------------------

def _spmd_case(cuda, devices):
    from repro_torch.launch.mesh import make_smoke_mesh
    u0 = np.random.default_rng(9).random((64, 40, 36)).astype(np.float32)
    want = app.run_reference(u0, 5)
    for bulk in (False, True):
        n = LAUNCHES["jacobi3d_faces"]
        got = app.run_spmd(u0, 5, make_smoke_mesh(4, 1, devices=devices),
                           bulk_sync=bulk)
        assert LAUNCHES["jacobi3d_faces"] == n + 4 * 5
        np.testing.assert_array_equal(got, want)


def test_run_spmd_on_one_card_equals_reference(cuda):
    """Four shards share the card, each on its own stream: both schedules
    equal run_reference bit for bit, one stencil launch a shard a step."""
    _spmd_case(cuda, [cuda] * 4)


def test_run_spmd_across_four_cards(cuda):
    """One shard a card: the exchanges are peer copies."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    _spmd_case(cuda, [torch.device("cuda", i) for i in range(4)])


def test_seq_sharded_decode_on_the_card(cuda):
    """Four shards of the cache on one card, combined by logsumexp: within
    1e-5 of plain decode in float32, 2e-2 in bf16."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import attention as A
    from repro_torch.models.sharding import use_sharding
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((2, 4, 2, 64), generator=g, device=cuda)
    k, v = (torch.randn((2, 256, 4, 64), generator=g, device=cuda)
            for _ in range(2))
    valid = (torch.arange(256, device=cuda) < 150)[None].expand(2, 256)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        args = [x.to(dtype) for x in (q, k, v)]
        want = A.decode_attention(*args, valid=valid)
        with use_sharding(make_smoke_mesh(4, 1, devices=[cuda] * 4)):
            got = A.seq_sharded_decode(*args, valid=valid)
        assert got.device == want.device
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_gemma3_prefill_goes_through_the_kernel(cuda):
    """The gemma3 smoke model on the card (five local layers of window 16,
    one global): one flash launch a prefill of 128 tokens (the global
    layer), the same hidden state as the plain path, and decode past the
    window."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    cfg = get_smoke_config("gemma3-27b")
    on = build_smoke(cfg, use_flash_kernel=True)
    off = build_smoke(cfg)
    params = on.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 128), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    n = LAUNCHES["flash_attention"]
    x_on, _ = on.apply(params, {"tokens": toks}, mode="prefill")
    assert LAUNCHES["flash_attention"] == n + 1
    x_off, _ = off.apply(params, {"tokens": toks}, mode="prefill")
    torch.testing.assert_close(x_on, x_off, rtol=1e-4, atol=1e-4)
    out = Engine(on, params, 2, 160).generate(toks, 24)
    assert out.shape == (2, 24) and out.device.type == "cuda"
    assert LAUNCHES["flash_attention"] == n + 2          # none in decode


def test_traced_gemma3_decode_equals_interpreted(cuda):
    """The tasked decode loop of the gemma3 smoke model under trace_graphs:
    the ring slots (pos % window) stay on the device, so the step replays
    as a CUDA graph, bit for bit the interpreted loop."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    from repro_torch.serve import flatten, tasked_decode_loop
    cfg = get_smoke_config("gemma3-27b")
    model = build_smoke(cfg, use_flash_kernel=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    nxt, cache = Engine(model, params, 2, 60).prefill(toks)
    out = {}
    for traced in (False, True):
        c = {}
        for name, t in flatten(cache):
            node = c
            *path, last = name.split(".")
            for key in path:
                node = node.setdefault(key, {})
            node[last] = t.clone()
        with Runtime(RuntimeConfig(trace_graphs=traced)) as rt:
            tok, lens, c_objs = tasked_decode_loop(
                rt, model, params, c, nxt.clone(),
                torch.full((2,), 40, dtype=torch.int32, device=cuda), 12)
            out[traced] = (tok.get(), lens.get(),
                           {k: o.get() for k, o in c_objs.items()})
            if traced:
                assert rt.stats()["graph_replays"] == 12 - 3
    np.testing.assert_array_equal(out[True][0], out[False][0])
    np.testing.assert_array_equal(out[True][1], out[False][1])
    for k in out[False][2]:
        np.testing.assert_array_equal(out[True][2][k], out[False][2][k])


def test_attention_products_on_bf16_operands_match_the_upcast(cuda,
                                                              monkeypatch):
    """``window_attention`` (a ragged prompt of 3.5 windows) and
    ``decode_attention`` (GQA and MQA caches) on the card multiply the
    bf16 operands with float32 results; with the products on float32
    copies (the CPU's arm) they agree within 2e-2, flash's bf16 bound (the
    float32 sum order can flip a bf16 rounding of p)."""
    from repro_torch.models import attention as A
    g = torch.Generator(device=cuda).manual_seed(4)
    cases = []
    for kh, gq in ((2, 4), (1, 8)):
        q = torch.randn((2, 224, kh, gq, 64), generator=g, device=cuda)
        k, v = (torch.randn((2, 224, kh, 64), generator=g, device=cuda)
                for _ in range(2))
        pos = torch.arange(224, device=cuda)
        cases.append((A.window_attention, (q, k, v),
                      dict(positions=pos, window=64)))
        valid = (torch.arange(224, device=cuda) < 150)[None].expand(2, 224)
        cases.append((A.decode_attention, (q[:, 0], k, v), dict(valid=valid)))
    for fn, args, kw in cases:
        args = [x.bfloat16() for x in args]
        got = fn(*args, **kw)
        with monkeypatch.context() as m:
            m.setattr(A, "bmm_f32", A.bmm_f32_upcast)
            want = fn(*args, **kw)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


# (G, D) of every configuration's self-attention decode, and more
DECODE_HEADS = [(8, 128), (3, 128), (4, 128), (5, 128), (2, 128), (1, 128),
                (1, 64), (16, 256), (16, 128), (7, 8), (9, 64)]


def _decode_operands(dev, b, t, kh, g, d, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=gen, device=dev).bfloat16()
            for s in ((b, kh, g, d), (b, t, kh, d), (b, t, kh, d))]


@pytest.mark.parametrize("g,d", DECODE_HEADS)
def test_decode_attention_kernel_close_to_plain(cuda, g, d):
    """The decode kernel against its plain version on the card (the same
    split arithmetic; float32 sums in another order, one bf16 rounding of
    the output apart) at each configuration's query group and head dim,
    ragged lengths from 1 to T, the default split count and three; and
    NaN in every slot at or past n[b] leaves the output unchanged."""
    b, t, kh = 6, 1000, 2
    q, k, v = _decode_operands(cuda, b, t, kh, g, d, seed=g * 1000 + d)
    n = torch.tensor([1, t, 517, 64, 65, 999], dtype=torch.int32,
                     device=cuda)
    for splits in (None, 3):
        before = LAUNCHES["decode_attention"]
        got = ops.decode_attention(q, k, v, n, splits=splits)
        assert LAUNCHES["decode_attention"] == before + 1
        want = ops.decode_attention_plain(q, k, v, n, splits=splits)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                                   atol=1e-2)
    k2, v2 = k.clone(), v.clone()
    for i, ni in enumerate(n.tolist()):
        k2[i, ni:] = float("nan")
        v2[i, ni:] = float("nan")
    assert torch.equal(ops.decode_attention(q, k2, v2, n),
                       ops.decode_attention(q, k, v, n))


def test_decode_attention_kernel_at_yi_9b_decode_shape(cuda):
    """q [64, 4, 8, 128] against caches [64, 2176, 4, 128] (a view of a
    stacked cache, read through its strides), lengths from 1 to 2,176:
    the kernel within a bf16 rounding of its plain version, and NaN past
    each length changes nothing."""
    b, t, kh, g, d = 64, 2176, 4, 8, 128
    q, _, _ = _decode_operands(cuda, b, 8, kh, g, d, seed=7)
    gen = torch.Generator(device=cuda).manual_seed(8)
    stack = torch.randn((2, 2, b, t, kh, d), generator=gen,
                        device=cuda).bfloat16()
    k, v = stack[1, 0], stack[1, 1]
    n = torch.randint(1, t + 1, (b,), generator=gen, device=cuda).int()
    n[0], n[1] = t, 1
    got = ops.decode_attention(q, k, v, n)
    torch.testing.assert_close(
        got.float(), ops.decode_attention_plain(q, k, v, n).float(),
        rtol=1e-2, atol=1e-2)
    for i, ni in enumerate(n.tolist()):
        stack[1, :, i, ni:] = float("nan")
    assert torch.equal(ops.decode_attention(q, k, v, n), got)


def test_decode_kernel_graph_replays_as_lengths_grow(cuda):
    """Captured once into a CUDA graph, the kernel reads the lengths on
    the card at each replay: each replay after the lengths grow equals an
    interpreted call bit for bit, and the capture counts one launch."""
    from repro_torch import kernels
    q, k, v = _decode_operands(cuda, 8, 512, 4, 8, 128, seed=3)
    n = torch.full((8,), 100, dtype=torch.int32, device=cuda)
    ops.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = dict(LAUNCHES)
    with kernels.recording_launches() as rec, \
            torch.cuda.graph(graph, capture_error_mode="thread_local"):
        got = ops.decode_attention(q, k, v, n)
    assert LAUNCHES == before and rec == {"decode_attention": 1}
    for _ in range(5):
        n.add_(67)
        graph.replay()
        assert torch.equal(got, ops.decode_attention(q, k, v, n))


def test_bf16_tasked_decode_through_the_decode_kernel(cuda):
    """The yi-9b smoke model in bf16 with the kernel flag on: the tasked
    decode loop under trace_graphs replays the decode kernel (one launch a
    layer a step, counted at each replay), bit for bit the interpreted
    loop; a decode step's hidden state is the plain path's within 5e-2
    relative L2, the bf16 bound of a kernel prefill against the plain one
    (chip_smoke.py's ``PREFILL_REL_TOL``): a float32 sum order can flip a
    bf16 rounding that the layers after carry forward."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    from repro_torch.serve import tasked_decode_loop
    cfg = get_smoke_config("yi-9b")
    model = build_smoke(cfg, param_dtype=torch.bfloat16,
                        use_flash_kernel=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    nxt, cache = Engine(model, params, 2, 80).prefill(toks)
    lengths = torch.full((2,), 64, dtype=torch.int32, device=cuda)
    steps, out = 10, {}
    for traced in (False, True):
        c = {k: a.clone() for k, a in cache.items()}
        n = LAUNCHES["decode_attention"]
        with Runtime(RuntimeConfig(trace_graphs=traced)) as rt:
            tok, lens, c_objs = tasked_decode_loop(
                rt, model, params, c, nxt.clone(), lengths.clone(), steps)
            # bf16 caches compared on the card: reading them back needs a
            # numpy bfloat16, which a process without JAX may lack
            out[traced] = (tok.get(), lens.get(),
                           {k: c_objs[k].copies[0].clone() for k in c})
            if traced:
                assert rt.stats()["graph_replays"] == steps - 3
        assert LAUNCHES["decode_attention"] == n + steps * cfg.n_layers
    for i in range(2):
        np.testing.assert_array_equal(out[True][i], out[False][i])
    for k in cache:
        assert torch.equal(out[True][2][k], out[False][2][k])
    plain = build_smoke(cfg, param_dtype=torch.bfloat16)
    x = {}
    for m in (model, plain):
        c = {k: a.clone() for k, a in cache.items()}
        with torch.no_grad():
            x[m is model], _ = m.apply(
                params, {"tokens": nxt, "lengths": lengths}, mode="decode",
                cache=c)
    rel = (x[True].float() - x[False].float()).norm() / x[False].float().norm()
    assert rel <= 5e-2


def test_recurrentgemma_serves_on_the_card(cuda):
    """The recurrentgemma smoke model on the card: no kernel launch in a
    prefill or decode (RG-LRU and window layers are plain torch), the
    prefill within 1e-4 of the same weights on the CPU, and the tasked
    decode loop under trace_graphs bit for bit the interpreted one over
    the mixed cache."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    from repro_torch.serve import flatten, tasked_decode_loop
    cfg = get_smoke_config("recurrentgemma-9b")
    model = build_smoke(cfg, use_flash_kernel=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    before = dict(LAUNCHES)
    x, _ = model.apply(params, {"tokens": toks}, mode="prefill")
    x_cpu, _ = model.apply(copy.deepcopy(params).cpu(),
                           {"tokens": toks.cpu()}, mode="prefill")
    torch.testing.assert_close(x.cpu(), x_cpu, rtol=1e-4, atol=1e-4)
    nxt, cache = Engine(model, params, 2, 60).prefill(toks)
    out = {}
    for traced in (False, True):
        c = {}
        for name, t in flatten(cache):
            node = c
            *path, last = name.split(".")
            for key in path:
                node = node.setdefault(key, {})
            node[last] = t.clone()
        with Runtime(RuntimeConfig(trace_graphs=traced)) as rt:
            tok, lens, c_objs = tasked_decode_loop(
                rt, model, params, c, nxt.clone(),
                torch.full((2,), 40, dtype=torch.int32, device=cuda), 12)
            out[traced] = (tok.get(), lens.get(),
                           {k: o.get() for k, o in c_objs.items()})
            if traced:
                assert rt.stats()["graph_replays"] == 12 - 3
    assert dict(LAUNCHES) == before
    np.testing.assert_array_equal(out[True][0], out[False][0])
    for k in out[False][2]:
        np.testing.assert_array_equal(out[True][2][k], out[False][2][k])


def test_pixtral_prefill_goes_through_the_kernel(cuda):
    """The pixtral smoke model on the card with vision embeddings: one
    flash launch a layer in a prefill of 128 tokens, the plain path's
    hidden state, and none in decode."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    cfg = get_smoke_config("pixtral-12b")
    on = build_smoke(cfg, use_flash_kernel=True)
    off = build_smoke(cfg)
    params = on.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 128), device=cuda, generator=g)
    ve = 0.02 * torch.randn((2, cfg.frontend_tokens, cfg.d_model),
                            device=cuda, generator=g)
    batch = {"tokens": toks, "vision_embeds": ve}
    n = LAUNCHES["flash_attention"]
    x_on, _ = on.apply(params, batch, mode="prefill")
    assert LAUNCHES["flash_attention"] == n + cfg.n_layers
    x_off, _ = off.apply(params, batch, mode="prefill")
    torch.testing.assert_close(x_on, x_off, rtol=1e-4, atol=1e-4)
    out = Engine(on, params, 2, 160).generate(toks, 16,
                                              {"vision_embeds": ve})
    assert out.shape == (2, 16) and out.device.type == "cuda"
    assert LAUNCHES["flash_attention"] == n + cfg.n_layers + cfg.n_layers


# ---------------------------------------------------------------------------
# MoE on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-16e"])
def test_moe_smoke_model_serves_on_the_card(cuda, arch):
    """The MoE smoke model on the card with the flash flag on: one flash
    launch a layer in a prefill of 128 tokens, the hidden state within
    1e-4 of the same weights on the CPU, greedy tokens from the Engine."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    cfg = get_smoke_config(arch)
    model = build_smoke(cfg, use_flash_kernel=True)
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 128), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    n = LAUNCHES["flash_attention"]
    x, _ = model.apply(params, {"tokens": toks}, mode="prefill")
    assert LAUNCHES["flash_attention"] == n + cfg.n_layers
    x_cpu, _ = model.apply(copy.deepcopy(params).cpu(),
                           {"tokens": toks.cpu()}, mode="prefill")
    torch.testing.assert_close(x.cpu(), x_cpu, rtol=1e-4, atol=1e-4)
    out = Engine(model, params, 2, 140).generate(toks, 8)
    assert out.shape == (2, 8) and out.device.type == "cuda"


# (T, D, F, E, k): one MoE layer of OLMoE-1B-7B-0924's prefill of 4 x 2048
# tokens (the benchmark's MoE cell), llama4-scout's prefill layer (top-1 of
# 16 experts, a shared expert beside them), a decode step's 64 tokens, and
# a ragged one (widths off the 64-column boxes, a 64-row tile)
MOE_LAYERS = {"olmoe-0924": (8192, 2048, 1024, 64, 8),
              "llama4-scout": (8192, 5120, 8192, 16, 1),
              "decode": (64, 2048, 1024, 64, 8),
              "ragged": (37, 72, 40, 8, 2)}


def _moe_layer(dev, t, d, f, e, k, seed=3, shared=0):
    from repro_torch.configs import MoEConfig
    from repro_torch.models import moe as M
    mcfg = MoEConfig(num_experts=e, top_k=k, d_ff_expert=f,
                     d_ff_shared=shared)
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = M.moe_init(gen, d, mcfg, True, dtype=torch.bfloat16, device=dev)
    x = torch.randn((1, t, d), generator=gen, device=dev).bfloat16()
    return mcfg, p, x


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm()).item()


@pytest.mark.parametrize("name", sorted(MOE_LAYERS))
def test_routed_moe_kernels_against_plain_and_dense(cuda, name):
    """At each layer shape: the plan's kernels give its plain version's
    integers; the grouped products the plain version's routed rows within
    1e-2 relative L2 (both round h and y to bf16 once; the float32 sum
    order differs); ``moe_ep`` without a mesh takes ``moe_routed`` (one
    launch of each wrapper) and lands within 2e-2 of ``moe_dense`` (which
    also rounds the gate and up products to bf16), with its aux loss;
    llama4-scout's with its shared expert."""
    from repro_torch.kernels import moe_experts as KM
    from repro_torch.models import moe as M
    t, d, f, e, k = MOE_LAYERS[name]
    mcfg, p, x = _moe_layer(cuda, t, d, f, e, k,
                            shared=f if name == "llama4-scout" else 0)
    xf = x[0]
    w, idx, _ = M._route(p["router"], xf, mcfg)
    rows, tiles = ops.routed_plan(idx, e)
    want_rows, want_tiles = KM.routed_plan_plain(idx, e)
    assert torch.equal(rows, want_rows) and torch.equal(tiles, want_tiles)
    ws = (p["wg"], p["wi"], p["wo"])
    sel = rows.long()
    y = ops.moe_experts(xf, rows, tiles, *ws)
    assert _rel(y[sel], ops.moe_experts_plain(xf, rows, tiles, *ws)[sel]) \
        <= 1e-2
    assert torch.equal(ops.moe_combine(y, rows, w),
                       ops.moe_combine_plain(y, rows, w))
    before = dict(LAUNCHES)
    got, aux = M.moe_ep(p, x, mcfg, True)
    assert {n: LAUNCHES[n] - before[n] for n in
            ("moe_plan", "moe_experts", "moe_combine")} == dict.fromkeys(
        ("moe_plan", "moe_experts", "moe_combine"), 1)
    want, want_aux = M.moe_dense(p, x, mcfg, True)
    assert _rel(got, want) <= 2e-2
    assert torch.equal(aux, want_aux)


def test_routed_moe_graph_replays_a_new_routing(cuda):
    """``moe_routed`` captured once as a CUDA graph, then replayed on an x
    whose routing differs: the eager call's bits on the new x (the grids
    and buffers come from shapes; the plan is read on the card only)."""
    from repro_torch.models import moe as M
    mcfg, p, x = _moe_layer(cuda, *MOE_LAYERS["decode"])
    static = x.clone()
    M.moe_routed(p, static, mcfg, True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out, _ = M.moe_routed(p, static, mcfg, True)
    for seed in (5, 6):
        x2 = torch.randn(x.shape, device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(seed)).bfloat16()
        _, i1, _ = M._route(p["router"], static[0], mcfg)
        _, i2, _ = M._route(p["router"], x2[0], mcfg)
        assert not torch.equal(i1, i2)
        static.copy_(x2)
        graph.replay()
        want, _ = M.moe_routed(p, x2, mcfg, True)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_bf16_moe_tasked_decode_through_the_routed_kernels(cuda):
    """The OLMoE-0924 smoke model in bf16 with ``moe_ep`` (no mesh, so the
    routed path: its widths fit the kernels): the tasked decode loop,
    interpreted and under trace_graphs (replaying the routed kernels, one
    launch of each a layer a step), gives the Engine's tokens and KV cache
    bit for bit; the prefill lies within 5e-2 relative L2 of the dense
    oracle's, the bf16 bound of a kernel prefill against the plain one
    (chip_smoke.py's ``PREFILL_REL_TOL``): the paths round the expert
    products to bf16 at other points, which can also reorder near-tied
    experts in the second layer."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    from repro_torch.serve import tasked_decode_loop
    cfg = get_smoke_config("olmoe-1b-7b-0924")
    model = build_smoke(cfg, param_dtype=torch.bfloat16,
                        use_flash_kernel=True, moe_mode="ep")
    params = model.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab, (2, 64), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    steps = 10
    eng = Engine(model, params, 2, 64 + steps)
    n = LAUNCHES["moe_experts"]
    nxt, cache = eng.prefill(toks)
    assert LAUNCHES["moe_experts"] == n + cfg.n_layers
    start = {k: a.clone() for k, a in cache.items()}
    want = eng.decode(cache, nxt, 64, steps)
    lengths = torch.full((2,), 64, dtype=torch.int32, device=cuda)
    for traced in (False, True):
        c = {k: a.clone() for k, a in start.items()}
        n = LAUNCHES["moe_experts"]
        with Runtime(RuntimeConfig(trace_graphs=traced)) as rt:
            tok, lens, c_objs = tasked_decode_loop(
                rt, model, params, c, nxt.clone(), lengths.clone(), steps)
            got_tok = tok.get()
            got_cache = {k: c_objs[k].copies[0].clone() for k in c}
            if traced:
                assert rt.stats()["graph_replays"] == steps - 3
        assert LAUNCHES["moe_experts"] == n + steps * cfg.n_layers
        np.testing.assert_array_equal(got_tok, want[:, -1:].cpu().numpy())
        for k in cache:
            assert torch.equal(got_cache[k], cache[k])
    dense = build_smoke(cfg, param_dtype=torch.bfloat16,
                        use_flash_kernel=True)
    x = {}
    for m in (model, dense):
        x[m is model], _ = m.apply(params, {"tokens": toks}, mode="prefill")
    assert _rel(x[True], x[False]) <= 5e-2


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "llama4-scout-17b-16e"])
def test_moe_ep_on_four_shards_of_the_card(cuda, arch):
    """``moe_ep`` at the smoke config over a (1, 4) mesh of shards sharing
    the card: at capacity factor E/k within 1e-4 of ``moe_dense`` over each
    shard's token slice (float32), and at 1.25, with drops, within 1e-5 of
    the same call over CPU shards (held to the JAX package on the CPU)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.sharding import use_sharding
    cfg = get_smoke_config(arch)
    mcfg = cfg.moe
    gen = torch.Generator(device=cuda).manual_seed(2)
    p = M.moe_init(gen, cfg.d_model, mcfg, cfg.gated_mlp,
                   dtype=torch.float32, device=cuda)
    x = torch.randn((4, 64, cfg.d_model), generator=gen, device=cuda)
    mesh = make_smoke_mesh(1, 4, devices=[cuda] * 4)
    with use_sharding(mesh):
        got, _ = M.moe_ep(p, x, mcfg, cfg.gated_mlp,
                          capacity_factor=mcfg.num_experts / mcfg.top_k)
        low = M.moe_ep(p, x, mcfg, cfg.gated_mlp)
    want = torch.cat([M.moe_dense(p, xs, mcfg, cfg.gated_mlp)[0]
                      for xs in x.chunk(4, dim=1)], dim=1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    cpu = torch.device("cpu")
    p_cpu = {k: {kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict)
             else v.cpu() for k, v in p.items()}
    with use_sharding(make_smoke_mesh(1, 4, devices=[cpu] * 4)):
        low_cpu = M.moe_ep(p_cpu, x.cpu(), mcfg, cfg.gated_mlp)
    for a, b in zip(low, low_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_bmm_f32_backward_on_the_card(cuda, dtype, tol):
    """``attention.bmm_f32`` where autograd records: ``aten::bmm.dtype``
    has no derivative, so the card's product goes through ``_BmmF32``,
    whose gradients (products on the operands' dtype, float32 results)
    agree with the upcast product's within the dtype's bound, in the
    operands' dtype."""
    from repro_torch.models import attention as A
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randn((8, 96, 64), generator=g, device=cuda).to(dtype)
    b = torch.randn((8, 64, 80), generator=g, device=cuda).to(dtype)
    cot = torch.randn((8, 96, 80), generator=g, device=cuda)
    la, lb = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = A.bmm_f32(la, lb)
    assert out.dtype == torch.float32
    ga, gb = torch.autograd.grad((out * cot).sum(), (la, lb))
    assert ga.dtype == gb.dtype == dtype
    ua, ub = a.float().requires_grad_(), b.float().requires_grad_()
    wa, wb = torch.autograd.grad((torch.bmm(ua, ub) * cot).sum(), (ua, ub))
    for got, want in ((ga, wa), (gb, wb)):
        err = (got.float() - want).norm() / want.norm()
        assert err <= tol, err


def test_train_step_on_the_card_launches_no_kernel(cuda):
    """The yi-9b smoke model trained on the card with the kernel flags on
    (float32 weights): no hand-written kernel launches, and after two
    steps the loss and parameters within 1e-4 of the same steps on the
    CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_smoke
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   init_train_state, make_train_step)
    from repro_torch.train.optimizer import tree_flatten, tree_map
    cfg = get_smoke_config("yi-9b")
    model = build_smoke(cfg, use_flash_kernel=True, remat="dots")
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    on_card = dataclasses.replace(
        state, params=tree_map(lambda t: t.to(cuda), state.params),
        opt=dataclasses.replace(
            state.opt, step=state.opt.step.to(cuda),
            m=tree_map(lambda t: t.to(cuda), state.opt.m),
            v=tree_map(lambda t: t.to(cuda), state.opt.v),
            master=tree_map(lambda t: t.to(cuda), state.opt.master)))
    step = make_train_step(model, TrainConfig(opt=AdamWConfig(
        lr_peak=1e-3, warmup_steps=1)))
    toks = torch.randint(0, cfg.vocab, (2, 129),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = dict(LAUNCHES)
    for _ in range(2):
        on_card, m_card = step(on_card, {k: v.to(cuda)
                                         for k, v in batch.items()})
        state, m_cpu = step(state, batch)
    assert dict(LAUNCHES) == before
    assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-4
    for (k, a), (_, b) in zip(tree_flatten(on_card.params),
                              tree_flatten(state.params)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_blockwise_attention_gradients_on_bf16_operands(cuda):
    """``flash_attention`` where autograd records, on bf16 operands on the
    card: gradients within 2e-2 (relative L2) of the same path with its
    products upcast."""
    from repro_torch.models import attention as A
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((2, 256, 2, 4, 64), generator=g, device=cuda)
    k, v = (torch.randn((2, 256, 2, 64), generator=g, device=cuda)
            for _ in range(2))
    cot = torch.randn(q.shape, generator=g, device=cuda)

    def grads(args):
        leaves = [x.detach().requires_grad_() for x in args]
        out = A.flash_attention(*leaves, causal=True, q_block=64,
                                kv_block=64)
        return torch.autograd.grad((out.float() * cot).sum(), leaves)
    got = grads([x.bfloat16() for x in (q, k, v)])
    want = grads([x.bfloat16().float() for x in (q, k, v)])
    for a, b in zip(got, want):
        err = (a.float() - b).norm() / b.norm()
        assert err <= 2e-2, err


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_mesh_train_step_on_two_shards_of_the_card_equals_the_cpu_mesh(
        cuda, arch):
    """The smoke model (float32) trained over a (1, 2) mesh of shards of
    the card, each on its own stream, remat "dots" (the backward's
    adjoint collectives on each shard's thread, the recomputation issuing
    its collectives again): two steps' losses within 1e-4 of the same
    steps over a (1, 2) CPU mesh (held to the one-device step and to JAX
    on the CPU), the parameters within 1e-4, no kernel launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_smoke_mesh, place_train_state
    from repro_torch.models import build_smoke
    from repro_torch.train import (AdamWConfig, TrainConfig,
                                   init_train_state, make_train_step)
    from repro_torch.train.optimizer import tree_flatten
    cfg = get_smoke_config(arch)
    model = build_smoke(cfg, remat="dots", loss_chunk=64)
    one = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    states = [place_train_state(one, model.axes(),
                                make_smoke_mesh(1, 2, devices=[d] * 2))
              for d in (cuda, torch.device("cpu"))]
    step = make_train_step(model, TrainConfig(opt=AdamWConfig(
        lr_peak=1e-3, warmup_steps=1)))
    toks = torch.randint(0, cfg.vocab, (4, 129),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    card, host = states
    before = dict(LAUNCHES)
    for _ in range(2):
        card, m_card = step(card, {k: v.to(cuda) for k, v in batch.items()})
        host, m_cpu = step(host, batch)
        assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-4
    assert dict(LAUNCHES) == before
    for (k, a), (_, b) in zip(tree_flatten(card.params),
                              tree_flatten(host.params)):
        assert a.shards[0].device.type == "cuda"
        torch.testing.assert_close(a.full().cpu(), b.full(), rtol=1e-4,
                                   atol=1e-4, msg=k)


# ---------------------------------------------------------------------------
# serving on a mesh of shards of the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-9b", "llama4-scout-17b-16e"])
def test_served_on_four_shards_of_the_card_equals_the_cpu_mesh(cuda, arch):
    """The smoke model (float32) served by the Engine under a (1, 4) mesh
    of shards of the card, each on its own stream, prompts of 128 (the
    flash kernel at the shards' heads, once a layer and shard): the same
    tokens as over four CPU shards (held to the JAX package on the CPU),
    and the prefill's last logits within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_smoke
    from repro_torch.models.sharding import use_sharding
    cfg = get_smoke_config(arch)
    model = build_smoke(cfg, moe_mode="ep", use_flash_kernel=True)
    cpu = torch.device("cpu")
    params = model.init(torch.Generator().manual_seed(0), cpu).tree()
    toks = torch.randint(0, cfg.vocab, (4, 128),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in (cpu, cuda):
        mesh = make_smoke_mesh(1, 4, devices=[dev] * 4)
        with use_sharding(mesh):
            eng = Engine(model, {k: v for k, v in params.items()}, 4, 136)
            n = LAUNCHES["flash_attention"]
            logits = eng.prefill(toks.to(dev), logits=True)[2]
            launched = LAUNCHES["flash_attention"] - n
            out[dev.type] = (logits.cpu(), eng.generate(toks.to(dev), 6)
                             .cpu(), launched)
    assert out["cuda"][2] == 4 * cfg.n_layers and out["cpu"][2] == 0
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(out["cuda"][1], out["cpu"][1])
