"""OLMoE-1B-7B-0924 as published on the port (``configs/
olmoe_1b_7b_0924.py``: QK-norm, top-k routing without renormalisation,
eps 1e-5), a configuration the JAX package does not have, so the plain
float32 reference ``portbench/reference/moe_lm.py`` is its oracle here:
the smoke model's prefill, and its prefill then decode through the cache,
against the reference's full forward on the benchmark's seeded weights;
QK-norm off is the attention the other configurations run, bit for bit;
the routing with and without renormalisation; ``moe.COUNTS`` under the
dense oracle. Float32 throughout."""
import dataclasses
import pathlib
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import lm, spec, weights  # noqa: E402
from portbench.reference import moe_lm  # noqa: E402
from repro_torch.configs import (ARCH_IDS, PORT_ONLY_IDS, MoEConfig,  # noqa: E402
                                 PortModelConfig, PortMoEConfig, get_config,
                                 get_smoke_config)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import Engine  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import build_smoke  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.sharding import split_weights  # noqa: E402

ARCH = "olmoe-1b-7b-0924"
# float32 against float32: the port and the reference sum in other orders
# (blockwise attention, batched expert products, the dense combine), a
# few ulps a product over 2-3 layers; 1e-5 leaves two decades above what
# they read and lies far below what a missing norm or a wrong routing
# weight moves (1e-1 and more)
TOL = 1e-5


def _conf(cfg) -> dict:
    """The harness's configuration dict of a port configuration."""
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "rope_theta": cfg.rope_theta,
            "norm_eps": cfg.norm_eps, "num_experts": cfg.moe.num_experts,
            "top_k": cfg.moe.top_k, "d_ff_expert": cfg.moe.d_ff_expert,
            "dtype": "float32"}


@pytest.fixture(scope="module")
def smoke():
    """The smoke model (float32, dense oracle) holding the benchmark's
    seeded weights (norms and QK-norm scales 1 + 0.1 normal), the same
    tensors the reference takes, and prompts."""
    cfg = get_smoke_config(ARCH)
    conf = _conf(cfg)
    model = build_smoke(cfg)
    kind = spec.kind("moe_prefill_batches")
    w = weights.draw(kind.shapes(conf), 11, "cpu")
    tree = weights.into_tree(w, model.init_abstract().tree())
    tokens = torch.randint(0, cfg.vocab, (3, 40),
                           generator=torch.Generator().manual_seed(2))
    return cfg, conf, model, w, tree, tokens


def test_registered_beside_the_jax_packages_ten():
    cfg = get_config(ARCH)
    assert "olmoe_1b_7b_0924" in PORT_ONLY_IDS
    assert "olmoe_1b_7b_0924" not in ARCH_IDS and len(ARCH_IDS) == 10
    assert cfg.qk_norm and cfg.moe.norm_topk_prob is False
    assert (cfg.norm_eps, cfg.max_seq, cfg.moe.num_experts, cfg.moe.top_k,
            cfg.moe.d_ff_shared) == (1e-5, 4096, 64, 8, 0)
    assert cfg.param_count() == pytest.approx(6.92e9, rel=1e-3)
    # the twin keeps the JAX package's routing and no QK-norm
    twin = get_config("olmoe-1b-7b")
    assert not getattr(twin, "qk_norm", False)
    assert getattr(twin.moe, "norm_topk_prob", True)


def test_prefill_matches_the_reference(smoke):
    cfg, conf, model, w, tree, tokens = smoke
    b, s = tokens.shape
    cache = model.init_cache(b, s, "cpu")
    x, cache = model.apply(tree, {"tokens": tokens}, mode="prefill",
                           cache=cache)
    got = model.unembed(tree, x)
    want, kv = moe_lm.forward(w, conf, tokens, range(s),
                              kv_positions=slice(0, s))
    assert lm.rel_err(got, want) < TOL
    for layer, (k, v) in enumerate(kv):
        assert lm.rel_err(cache["k"][layer], k) < TOL
        assert lm.rel_err(cache["v"][layer], v) < TOL
    # the Engine's prefill: the same last logits and first tokens
    nxt, _, last = Engine(model, tree, b, s).prefill(tokens, logits=True)
    assert lm.rel_err(last, want[:, -1:]) < TOL
    assert torch.equal(nxt[:, 0].long(), want[:, -1].argmax(-1))


def test_prefill_then_decode_matches_the_full_forward(smoke):
    """A prefill of 32 positions, then 8 decode steps through the cache
    (each writes its normed k), against the reference's forward over all
    40 tokens at once: every step's logits, and the cache's K and V."""
    cfg, conf, model, w, tree, tokens = smoke
    b, s = tokens.shape
    s0 = 32
    cache = model.init_cache(b, s, "cpu")
    x, cache = model.apply(tree, {"tokens": tokens[:, :s0]}, mode="prefill",
                           cache=cache)
    got = [model.unembed(tree, x[:, -1:])]
    for pos in range(s0, s - 1):
        lengths = torch.full((b,), pos, dtype=torch.int32)
        x, cache = model.apply(tree, {"tokens": tokens[:, pos:pos + 1],
                                      "lengths": lengths},
                               mode="decode", cache=cache)
        got.append(model.unembed(tree, x))
    want, kv = moe_lm.forward(w, conf, tokens, range(s0 - 1, s - 1),
                              kv_positions=slice(0, s - 1))
    assert lm.rel_err(torch.cat(got, dim=1), want) < TOL
    for layer, (k, v) in enumerate(kv):
        assert lm.rel_err(cache["k"][layer][:, :s - 1], k) < TOL
        assert lm.rel_err(cache["v"][layer][:, :s - 1], v) < TOL


def test_qk_norm_off_is_the_attention_of_today(monkeypatch):
    """The twin's smoke configuration restated as a port-only one with
    both settings at their defaults draws the same tree (no QK-norm
    leaves) and serves the same logits and cache bit for bit; and with
    QK-norm off the attention layer never reaches a norm."""
    twin = get_smoke_config("olmoe-1b-7b")
    same = PortModelConfig(**{f.name: getattr(twin, f.name)
                              for f in dataclasses.fields(twin)})
    same = dataclasses.replace(same, moe=PortMoEConfig(
        **dataclasses.asdict(twin.moe)))
    out = []
    for cfg in (twin, same):
        model = build_smoke(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        assert "q_norm" not in params.tree()["layers"]["attn"]
        toks = torch.randint(0, cfg.vocab, (2, 24),
                             generator=torch.Generator().manual_seed(1))
        nxt, cache, last = Engine(model, params, 2, 28).prefill(
            toks, logits=True)
        out.append((last, cache["k"], Engine(model, params, 2, 28).generate(
            toks, 4)))
    for a, b in zip(*out):
        assert torch.equal(a, b)

    def no_norm(*a, **k):
        raise AssertionError("a norm inside attention with QK-norm off")
    monkeypatch.setattr(L, "rms_norm", no_norm)
    p = A.attn_init(torch.Generator().manual_seed(0), 32, 4, 2, 8,
                    dtype=torch.float32, device="cpu")
    x = torch.randn(2, 6, 32, generator=torch.Generator().manual_seed(3))
    cache = A.init_attn_cache(2, 8, 2, 8, dtype=torch.float32, device="cpu")
    A.attention_layer(p, x, kind="global_attn", rope_theta=1e4,
                      n_kv_heads=2, mode="prefill", cache=cache)
    A.attention_layer(p, x[:, :1], kind="global_attn", rope_theta=1e4,
                      n_kv_heads=2, mode="decode", cache=cache,
                      lengths=torch.full((2,), 6, dtype=torch.int32))


def test_qk_norm_takes_the_whole_width_and_refuses_split_heads():
    g = torch.Generator().manual_seed(4)
    p = A.attn_init(g, 32, 4, 2, 8, dtype=torch.float32, device="cpu",
                    qk_norm=True)
    assert p["q_norm"].shape == (32,) and p["k_norm"].shape == (16,)
    assert A.attn_axes(qk_norm=True)["k_norm"] == ("qk_norm",)
    p["q_norm"] = 1 + 0.1 * torch.randn(32, generator=g)
    q = torch.randn(2, 3, 4, 8, generator=g)
    k = torch.randn(2, 3, 2, 8, generator=g)
    qn, kn = A.qk_norm(p, q, k, 1e-5)
    flat = q.reshape(2, 3, 32)
    want = flat * torch.rsqrt(flat.square().mean(-1, keepdim=True) + 1e-5) \
        * p["q_norm"]
    torch.testing.assert_close(qn, want.view_as(q), rtol=1e-6, atol=1e-6)
    assert torch.allclose(kn.reshape(2, 3, 16).square().mean(-1),
                          torch.ones(2, 3), atol=1e-4)
    for axis in ("heads", "kv_heads"):
        with split_weights(frozenset({axis})):
            with pytest.raises(NotImplementedError, match="QK-norm"):
                A.qk_norm(p, q, k, 1e-5)


@pytest.mark.parametrize("renormalise", [True, False])
def test_route_with_and_without_renormalisation(renormalise):
    g = torch.Generator().manual_seed(5)
    router = torch.randn(16, 8, generator=g) / 4
    x = torch.randn(10, 16, generator=g)
    mcfg = MoEConfig(num_experts=8, top_k=3, d_ff_expert=4) if renormalise \
        else PortMoEConfig(num_experts=8, top_k=3, d_ff_expert=4,
                           norm_topk_prob=False)
    weights_, idx, aux = M._route(router, x, mcfg)
    probs = torch.softmax(x @ router, dim=-1)
    top, want_idx = probs.topk(3, dim=-1)
    assert torch.equal(idx, want_idx)
    want = top / top.sum(-1, keepdim=True) if renormalise else top
    torch.testing.assert_close(weights_, want)
    assert torch.allclose(weights_.sum(-1), torch.ones(10)) == renormalise
    assert aux.shape == ()


def test_counts_under_the_dense_oracle(monkeypatch):
    monkeypatch.setattr(M, "COUNTS", {"routed_rows": 0, "computed_rows": 0})
    cfg = get_smoke_config(ARCH)
    p = M.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.moe,
                   True, dtype=torch.float32, device="cpu")
    x = torch.randn(2, 5, cfg.d_model)
    M.moe_dense(p, x, cfg.moe, True)
    M.moe_dense(p, x[:, :3], cfg.moe, True)
    assert M.COUNTS == {"routed_rows": 16 * cfg.moe.top_k,
                        "computed_rows": 16 * cfg.moe.num_experts}


def test_serve_resolves_the_configuration(capsys):
    out = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert out.shape == (2, 3)
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
