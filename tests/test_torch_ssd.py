"""Parity of the port's Mamba-2 SSD path (``repro_torch.kernels.ssd`` and
``repro_torch.models.ssm``) with the JAX package's Pallas kernel, its
``ref.ssd_chunk_ref`` oracle, its ``models.ssm`` and the naive state
recurrence of ``test_model_properties.py``.

On the CPU the kernel wrapper runs its plain version; the Pallas kernel
runs in interpret mode, as ``test_kernels.py`` runs it. Inputs come from
numpy seeds. The CUDA kernel itself is held against the plain version on a
card by the ``cuda``-marked test at the end.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JSSMConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import ssm as JS
from repro_torch.configs.base import SSMConfig
from repro_torch.convert import to_numpy, to_torch
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.models import ssm as TS

TOL = 1e-4          # the JAX tests' tolerance (test_kernels.py)

# the three shapes of test_kernels.py and the mamba2 smoke shape
KERNEL_SHAPES = [(2, 16, 4, 8, 16), (1, 32, 2, 16, 8), (4, 8, 8, 4, 4),
                 (2, 16, 4, 32, 16)]


def _softplus(x):
    return np.log1p(np.exp(x))


def _chunk_inputs(seed, bc, q, h, p, n):
    """x, dt, A, B, C as test_kernels.py draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bc, q, h, p))
    dt = _softplus(rng.standard_normal((bc, q, h)))
    A = -np.exp(rng.standard_normal(h))
    B = rng.standard_normal((bc, q, n))
    C = rng.standard_normal((bc, q, n))
    return tuple(a.astype(np.float32) for a in (x, dt, A, B, C))


@pytest.mark.parametrize("bc,q,h,p,n", KERNEL_SHAPES)
def test_ssd_chunk_matches_pallas_and_ref(bc, q, h, p, n):
    args = _chunk_inputs(q * h + p, bc, q, h, p, n)
    before = LAUNCHES["ssd_chunk"]
    y, st = ops.ssd_chunk(*map(to_torch, args))
    assert LAUNCHES["ssd_chunk"] == before        # plain version on the CPU
    assert y.dtype == st.dtype == torch.float32
    assert tuple(st.shape) == (bc, h, p, n)
    jargs = tuple(map(jnp.asarray, args))
    for want_y, want_st in (jops.ssd_chunk(*jargs),
                            jref.ssd_chunk_ref(*jargs)):
        np.testing.assert_allclose(to_numpy(y), np.asarray(want_y),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(to_numpy(st), np.asarray(want_st),
                                   rtol=TOL, atol=TOL)


def test_ssd_chunk_long_chunk_matches_pallas_and_ref():
    """Q = 512, P = 128, N = 256, past the first card design's limits.
    Outputs reach magnitudes near 100 here, so the float32 sum order moves
    them by more than 1e-4 absolute: held, as on the card, to 1e-4 of the
    largest magnitude."""
    args = _chunk_inputs(3, 1, 512, 2, 128, 256)
    y, st = ops.ssd_chunk(*map(to_torch, args))
    jargs = tuple(map(jnp.asarray, args))
    for want_y, want_st in (jops.ssd_chunk(*jargs),
                            jref.ssd_chunk_ref(*jargs)):
        for got, want in ((y, want_y), (st, want_st)):
            want = np.asarray(want)
            assert np.abs(to_numpy(got) - want).max() <= \
                TOL * np.abs(want).max()


def _factored_ssd(x, dt, A, B, C, tile=64):
    """The card kernel's decomposition in float64 numpy: cs (float32, a
    float64 scan), per head a flag "cs does not increase"; for flagged
    heads the off-diagonal 64-row tiles as diag(E) . G . (F * x) with
    E = exp(cs_l - cs_{l0-1}) and F = exp(cs_{l0-1} - cs_s) * dt, the
    diagonal tiles (and every tile of the other heads) in the direct masked
    form, the states as (x * D)^T . B."""
    x, dt, A, B, C = (a.astype(np.float64) for a in (x, dt, A, B, C))
    bc, q, h, p = x.shape
    dA = (dt.astype(np.float32) * A.astype(np.float32)).astype(np.float64)
    cs = np.cumsum(dA, axis=1).astype(np.float32).astype(np.float64)
    G = np.einsum("bln,bsn->bls", C, B)
    y = np.zeros_like(x)
    for b in range(bc):
        for hh in range(h):
            c = cs[b, :, hh]
            mono = bool(np.all(dA[b, :, hh] <= 0))
            xdt = x[b, :, hh] * dt[b, :, hh, None]
            for l0 in range(0, q, tile):
                rows = slice(l0, min(q, l0 + tile))
                lr = np.arange(l0, min(q, l0 + tile))
                s_lo = l0 if mono else 0
                sr = np.arange(s_lo, min(q, l0 + tile))
                with np.errstate(over="ignore"):
                    W = np.where(sr[None, :] <= lr[:, None],
                                 G[b][np.ix_(lr, sr)]
                                 * np.exp(c[lr, None] - c[None, sr]), 0.0)
                y[b, rows, hh] = W @ xdt[sr]
                if mono and l0 > 0:
                    E = np.exp(c[lr] - c[l0 - 1])
                    F = np.exp(c[l0 - 1] - c[:l0]) * dt[b, :l0, hh]
                    y[b, rows, hh] += E[:, None] * (
                        G[b][np.ix_(lr, np.arange(l0))]
                        @ (F[:, None] * x[b, :l0, hh]))
    D = np.exp(cs[:, -1:] - cs) * dt
    st = np.einsum("bsh,bshp,bsn->bhpn", D, x, B)
    return y, st


@pytest.mark.parametrize("bc,q,h,p,n,a_scale", [
    (2, 256, 3, 8, 16, (-16.0, -1.0, -0.05)),     # decay past e^-88
    (1, 200, 4, 4, 8, (-8.0, 0.05, -2.0, 0.3)),    # A > 0 on two heads
    (2, 130, 2, 6, 5, (-12.0, -0.5))])
def test_factored_ssd_form_matches_pallas(bc, q, h, p, n, a_scale):
    """The factorization that the card kernel computes, modelled in
    float64, is within 1e-4 of the Pallas kernel's largest magnitude:
    with |dt·A| summing past 88 inside a 64-row tile (the factors
    underflow, the direct form's products do too) and with heads whose A
    is positive (their cs increases: they take the direct form)."""
    x, dt, _, B, C = _chunk_inputs(q + h, bc, q, h, p, n)
    A = np.asarray(a_scale, np.float32)
    assert (np.cumsum(dt * np.abs(A), axis=1).max(axis=1) > 88).any()
    want_y, want_st = (np.asarray(a) for a in jops.ssd_chunk(
        *map(jnp.asarray, (x, dt, A, B, C))))
    got_y, got_st = _factored_ssd(x, dt, A, B, C)
    for got, want in ((got_y, want_y), (got_st, want_st)):
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_ssd_chunk_rejects_mismatched_shapes():
    x, dt, A, B, C = map(to_torch, _chunk_inputs(0, 2, 8, 4, 4, 4))
    with pytest.raises(ValueError):
        ops.ssd_chunk(x, dt, A, B, C[:, :4])
    with pytest.raises(ValueError):
        ops.ssd_chunk(x[0], dt, A, B, C)


# ---------------------------------------------------------------------------
# chunked scan against the JAX one and the naive recurrence
# ---------------------------------------------------------------------------

def _naive_ssd(x, dt, Av, B, C):
    """The sequential state recurrence of test_model_properties.py, in
    float64 numpy. x: [b,s,h,p]; B,C: [b,s,1,n]."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    st = np.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        dA = np.exp(dt[:, t] * Av[None, :])                        # [b,h]
        st = st * dA[:, :, None, None] + np.einsum(
            "bhp,bn,bh->bhpn", x[:, t], B[:, t, 0], dt[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", st, C[:, t, 0]))
    return np.stack(ys, axis=1), st


def _scan_inputs(seed, s, g=1, b=2, h=2, p=4, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = _softplus(rng.standard_normal((b, s, h)))
    Av = -np.exp(rng.standard_normal(h))
    B = rng.standard_normal((b, s, g, n))
    C = rng.standard_normal((b, s, g, n))
    return tuple(a.astype(np.float32) for a in (x, dt, Av, B, C))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("s,chunk", [(16, 4), (24, 8), (32, 32), (40, 16)])
def test_ssd_chunked_matches_jax_and_naive_recurrence(s, chunk, use_kernel):
    args = _scan_inputs(s + chunk, s)
    got_y, got_st = TS._ssd_chunked(*map(to_torch, args), chunk,
                                    use_kernel=use_kernel)
    jy, jst = JS._ssd_chunked(*map(jnp.asarray, args), chunk)
    ny, nst = _naive_ssd(*(a.astype(np.float64) for a in args))
    for want_y, want_st in ((np.asarray(jy), np.asarray(jst)), (ny, nst)):
        np.testing.assert_allclose(to_numpy(got_y), want_y, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(to_numpy(got_st), want_st, rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_chunked_groups_and_initial_state_match_jax(use_kernel):
    """Two groups of two heads (the kernel takes one group, so the flag
    falls back to the einsums) and a non-zero initial state."""
    x, dt, Av, B, C = _scan_inputs(7, 24, g=2, h=4)
    s0 = np.random.default_rng(8).standard_normal((2, 4, 4, 8)).astype(
        np.float32)
    got_y, got_st = TS._ssd_chunked(*map(to_torch, (x, dt, Av, B, C)), 8,
                                    init_state=to_torch(s0),
                                    use_kernel=use_kernel)
    jy, jst = JS._ssd_chunked(*map(jnp.asarray, (x, dt, Av, B, C)), 8,
                              init_state=jnp.asarray(s0))
    np.testing.assert_allclose(to_numpy(got_y), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(to_numpy(got_st), np.asarray(jst), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the whole block: prefill and decode, caches compared
# ---------------------------------------------------------------------------

D_MODEL = 32
SCFG = dict(d_state=8, expand=2, headdim=16, chunk_size=8, conv_width=4)


def _layer_params(seed):
    """ssd_init's shapes with numpy-drawn values (A_log, D and dt_bias
    spread out, so every term of the block matters)."""
    rng = np.random.default_rng(seed)
    di, n = 2 * D_MODEL, SCFG["d_state"]
    nh, ch = di // SCFG["headdim"], di + 2 * n
    shapes = {"in_proj": (D_MODEL, 2 * di + 2 * n + nh),
              "conv_w": (4, ch), "conv_b": (ch,), "A_log": (nh,),
              "D": (nh,), "dt_bias": (nh,), "norm": (di,),
              "out_proj": (di, D_MODEL)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    p["in_proj"] /= np.sqrt(D_MODEL)
    p["out_proj"] /= np.sqrt(di)
    p["dt_bias"] -= 2.0
    return p


def _both_layers(p, u, mode, cache=None, use_kernel=False):
    jy, jc = JS.ssd_layer({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(u), scfg=JSSMConfig(**SCFG), mode=mode,
                          cache=None if cache is None else
                          {k: jnp.asarray(v) for k, v in cache.items()})
    ty, tc = TS.ssd_layer({k: to_torch(v) for k, v in p.items()},
                          to_torch(u), scfg=SSMConfig(**SCFG), mode=mode,
                          cache=None if cache is None else
                          {k: to_torch(v) for k, v in cache.items()},
                          use_kernel=use_kernel)
    return (np.asarray(jy), jc), (to_numpy(ty), tc)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_ssd_layer_prefill_then_decode_matches_jax(use_kernel):
    p = _layer_params(11)
    rng = np.random.default_rng(12)
    u = rng.standard_normal((2, 20, D_MODEL)).astype(np.float32)   # pads
    (jy, jc), (ty, tc) = _both_layers(p, u, "prefill",
                                      use_kernel=use_kernel)
    np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
    assert set(tc) == {"conv", "state"} and tc["state"].dtype == torch.float32
    for key in ("conv", "state"):
        np.testing.assert_allclose(to_numpy(tc[key]), np.asarray(jc[key]),
                                   rtol=TOL, atol=TOL)
    cache = {k: np.asarray(v) for k, v in jc.items()}
    for t in range(3):
        u1 = rng.standard_normal((2, 1, D_MODEL)).astype(np.float32)
        (jy, jc), (ty, tc) = _both_layers(p, u1, "decode", cache)
        np.testing.assert_allclose(ty, jy, rtol=TOL, atol=TOL)
        for key in ("conv", "state"):
            np.testing.assert_allclose(to_numpy(tc[key]), np.asarray(jc[key]),
                                       rtol=TOL, atol=TOL, err_msg=str(t))
        cache = {k: np.asarray(v) for k, v in jc.items()}


def test_ssd_layer_train_matches_prefill_and_decode_chain():
    """A train pass over S tokens equals a prefill of the first S - 3 and
    three decode steps (the recurrent update against the chunked scan)."""
    p = {k: to_torch(v) for k, v in _layer_params(13).items()}
    u = to_torch(np.random.default_rng(14).standard_normal(
        (2, 19, D_MODEL)).astype(np.float32))
    scfg = SSMConfig(**SCFG)
    full, _ = TS.ssd_layer(p, u, scfg=scfg, mode="train")
    out, cache = TS.ssd_layer(p, u[:, :16], scfg=scfg, mode="prefill",
                              cache=TS.init_ssd_cache(2, D_MODEL, scfg,
                                                      dtype=torch.float32,
                                                      device="cpu"))
    outs = [out]
    for t in range(16, 19):
        out, cache = TS.ssd_layer(p, u[:, t:t + 1], scfg=scfg, mode="decode",
                                  cache=cache)
        outs.append(out)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=TOL,
                               atol=TOL)


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for state in (None, st):
        jy, js = JS._causal_conv(*map(jnp.asarray, (x, w, b)),
                                 None if state is None else jnp.asarray(state))
        ty, ts = TS._causal_conv(*map(to_torch, (x, w, b)),
                                 None if state is None else to_torch(state))
        np.testing.assert_allclose(to_numpy(ty), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(to_numpy(ts), np.asarray(js), rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (skips without a card)
# ---------------------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bc,q,h,p,n", KERNEL_SHAPES + [(3, 100, 5, 64, 128),
                                                        (2, 1, 3, 7, 5),
                                                        (4, 256, 32, 64, 128),
                                                        (2, 512, 4, 128, 256),
                                                        (3, 100, 5, 96, 200)])
def test_ssd_chunk_kernel_close_to_plain(cuda, bc, q, h, p, n):
    """Kernel and plain version share ``cs`` (a float64 scan rounded to
    float32); only the float32 sum order of the products differs: 1e-4
    relative to the output's largest magnitude."""
    args = tuple(to_torch(a, cuda) for a in _chunk_inputs(q + n, bc, q, h, p,
                                                           n))
    before = LAUNCHES["ssd_chunk"]
    y, st = ops.ssd_chunk(*args)
    assert LAUNCHES["ssd_chunk"] == before + 1
    want_y, want_st = ops.ssd_chunk_plain(*args)
    for got, want in ((y, want_y), (st, want_st)):
        assert bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        assert err <= TOL * want.abs().max().item(), err
    with pytest.raises(ValueError):
        ops.ssd_chunk(*(a.double() for a in args))
