"""The dropless routed MoE path on the CPU: the plan, the plain version of
the grouped products and the combine, ``moe_routed`` against the dense
oracle, and the dispatch.

``routed_plan_plain`` gives each (token, k) assignment one row of a
padded buffer and each row tile its expert; ``moe_experts_plain`` and
``moe_combine_plain`` are the kernels' arithmetic in PyTorch. Here they
are held to ``moe_dense`` (float32 within the JAX MoE tests' 1e-5, bf16
within their 2e-2) over top-1 with a shared expert, top-2 and top-8, with
and without renormalised weights, skewed routings and fewer assignments
than experts. ``moe_ep`` keeps the dense oracle for a CPU tensor (bit for
bit, ``test_torch_moe.py``); on ``meta`` (the dry-run's stand-in for the
card) a bf16 call takes the routed wrappers. The CUDA kernels are held to
these plain versions on a card by ``test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch import opcount
from repro_torch.configs import MoEConfig
from repro_torch.configs.base import PortMoEConfig
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import moe_experts as KM
from repro_torch.models import moe as M

META = torch.device("meta")
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _layer(d, e, k, f, shared=0, norm=True, dtype=torch.float32, seed=0,
           t=24):
    mcfg = PortMoEConfig(num_experts=e, top_k=k, d_ff_expert=f,
                         d_ff_shared=shared, norm_topk_prob=norm)
    gen = torch.Generator().manual_seed(seed)
    p = M.moe_init(gen, d, mcfg, True, dtype=dtype, device="cpu")
    x = torch.randn((2, t // 2, d), generator=gen).to(dtype)
    return mcfg, p, x


def _plan_facts(idx, e):
    rows, tiles = KM.routed_plan(idx, e)
    assert rows.dtype == tiles.dtype == torch.int32
    a = idx.numel()
    bm = KM.row_tile(a, e)
    counts = torch.bincount(idx.reshape(-1), minlength=e)
    return rows.long(), tiles.long(), bm, counts


ROUTINGS = {
    "top1": (64, 4, 1), "top2": (24, 8, 2), "top8": (160, 64, 8),
    "wide_tiles": (256, 4, 4),            # 1,024 rows over 4 experts: bm 128
    "few_rows": (3, 16, 2),               # T*k < E
}


@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_plan_places_every_assignment_once(name):
    """Every assignment gets its own row inside its expert's segment, at
    the segment's start plus its rank in token then k order (the EP
    path's slot ranks, with no capacity); segments start on row-tile
    boundaries; the tile table covers each expert's count with exactly
    ceil(count / bm) tiles and marks the rest -1."""
    t, e, k = ROUTINGS[name]
    idx = torch.stack([torch.randperm(e, generator=torch.Generator()
                                      .manual_seed(i))[:k] for i in range(t)])
    rows, tiles, bm, counts = _plan_facts(idx, e)
    assert rows.unique().numel() == t * k
    assert tiles.numel() == KM.tile_count(t * k, e)
    assert int(rows.max()) < tiles.numel() * bm
    flat = idx.reshape(-1)
    seen, rank = {}, []
    for x in flat.tolist():                  # earlier assignments to x
        rank.append(seen.get(x, 0))
        seen[x] = rank[-1] + 1
    start = rows - torch.tensor(rank)
    assert bool((start % bm == 0).all())
    for x in range(e):
        mine = start[flat == x]
        assert mine.unique().numel() <= 1
        want = -(-int(counts[x]) // bm)
        assert int((tiles == x).sum()) == want
        if want:
            first = int(mine[0]) // bm
            assert tiles[first:first + want].eq(x).all()
    used = sum(-(-int(c) // bm) for c in counts)
    assert bool((tiles[used:] == -1).all()) and bool((tiles[:used] >= 0).all())


def test_plan_on_a_skewed_routing():
    """Every assignment to one expert (one segment, the other experts
    without a tile), and a routing that leaves half the experts idle."""
    idx = torch.full((300, 1), 5)
    rows, tiles, bm, _ = _plan_facts(idx, 8)
    assert bm == 64 and torch.equal(rows, torch.arange(300))
    assert tiles.tolist() == [5] * 5 + [-1] * (tiles.numel() - 5)
    idx = torch.arange(40).reshape(20, 2) % 4 * 2        # experts 0, 2, 4, 6
    rows, tiles, bm, counts = _plan_facts(idx, 8)
    assert counts.tolist() == [10, 0, 10, 0, 10, 0, 10, 0]
    assert tiles.tolist()[:4] == [0, 2, 4, 6]
    assert bool((tiles[4:] == -1).all())


def test_row_tile_follows_the_rows_an_expert_gets():
    """128-row tiles from two tiles an expert on average (OLMoE's prefill
    batch, llama4-scout's), 64 below (decode); the table's bound."""
    assert KM.row_tile(8192 * 8, 64) == 128 and KM.row_tile(64 * 8, 64) == 64
    assert KM.row_tile(8192, 16) == 128
    assert KM.tile_count(65536, 64) == (65536 + 64 * 127) // 128
    assert KM.tile_count(6, 16) == 6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("e,k,shared", [(4, 1, 24), (8, 2, 0), (64, 8, 0)])
def test_routed_matches_dense(e, k, shared, norm, dtype):
    """``moe_routed`` on CPU tensors (the plain versions) against the dense
    oracle: top-1 with a shared expert, top-2, top-8, the top-k weights
    renormalised or not; the same aux loss."""
    mcfg, p, x = _layer(16, e, k, 32, shared, norm, dtype)
    want, want_aux = M.moe_dense(p, x, mcfg, True)
    got, aux = M.moe_routed(p, x, mcfg, True)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert torch.equal(aux, want_aux)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["one_expert", "idle_experts", "few_rows"])
def test_routed_matches_dense_on_skewed_routings(case, dtype):
    """Every token to one expert; half the experts without a token; T*k
    below E (three tokens, top-2 of 16)."""
    e, k, t = (16, 2, 6) if case == "few_rows" else (8, 2, 40)
    mcfg, p, x = _layer(16, e, k, 32, dtype=dtype, seed=3, t=t)
    if case != "few_rows":
        with torch.no_grad():
            p["router"].zero_()
            hot = [3, 6] if case == "one_expert" else [0, 2, 4, 6]
            p["router"][:, hot] = torch.linspace(1.0, 2.0, len(hot))
            x = x.abs() + 0.1
    w, idx, _ = M._route(p["router"], x.reshape(-1, 16), mcfg)
    if case == "one_expert":
        assert set(idx.unique().tolist()) == {3, 6}
    want, _ = M.moe_dense(p, x, mcfg, True)
    got, _ = M.moe_routed(p, x, mcfg, True)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_plain_experts_compute_each_row_with_its_expert():
    """``moe_experts_plain``: a routed row is its token through its
    expert's SwiGLU (float32 products, h rounded once); the padding rows
    are zero."""
    mcfg, p, x = _layer(16, 8, 2, 32, dtype=torch.bfloat16, seed=5)
    xf = x.reshape(-1, 16)
    _, idx, _ = M._route(p["router"], xf, mcfg)
    rows, tiles = KM.routed_plan(idx, 8)
    y = KM.moe_experts_plain(xf, rows, tiles, p["wg"], p["wi"], p["wo"])
    for a in (0, 7, 33):
        t, e = a // 2, int(idx.reshape(-1)[a])
        xs = xf[t].float()
        h = (torch.nn.functional.silu(xs @ p["wg"][e].float())
             * (xs @ p["wi"][e].float())).bfloat16()
        want = (h.float() @ p["wo"][e].float()).bfloat16()
        assert torch.equal(y[rows[a]], want)
    pad = torch.ones(y.shape[0], dtype=torch.bool)
    pad[rows.long()] = False
    assert not y[pad].any()


def test_plain_combine_sums_in_k_order():
    """``moe_combine_plain``: the weights rounded to y's dtype, float32
    products summed over k in order, one rounding at the end."""
    g = torch.Generator().manual_seed(7)
    y = torch.randn((10, 8), generator=g).bfloat16()
    rows = torch.tensor([3, 0, 9, 4, 1, 2], dtype=torch.int32)
    w = torch.rand((3, 2), generator=g)
    got = KM.moe_combine_plain(y, rows, w)
    wb = w.bfloat16().float()
    for t in range(3):
        acc = torch.zeros(8)
        for j in range(2):
            acc = acc + wb[t, j] * y[rows[2 * t + j]].float()
        assert torch.equal(got[t], acc.bfloat16())


def test_counts_under_the_routed_path():
    """``COUNTS`` adds T*k routed rows and T*k computed rows a call: the
    ratio reads 1.0."""
    mcfg, p, x = _layer(16, 8, 2, 32)
    saved = dict(M.COUNTS)
    try:
        M.COUNTS.update(routed_rows=0, computed_rows=0)
        M.moe_routed(p, x, mcfg, True)
        M.moe_routed(p, x, mcfg, True)
        assert M.COUNTS == {"routed_rows": 2 * 24 * 2,
                            "computed_rows": 2 * 24 * 2}
        M.moe_dense(p, x, mcfg, True)
        assert M.COUNTS["computed_rows"] == 2 * 24 * 2 + 24 * 8
    finally:
        M.COUNTS.update(saved)


def _meta_layer(dtype=torch.bfloat16, d=64, f=32, e=8, k=2, t=40):
    mcfg = MoEConfig(num_experts=e, top_k=k, d_ff_expert=f)
    p = {"router": torch.empty((d, e), device=META),
         "wg": torch.empty((e, d, f), dtype=dtype, device=META),
         "wi": torch.empty((e, d, f), dtype=dtype, device=META),
         "wo": torch.empty((e, f, d), dtype=dtype, device=META)}
    return mcfg, p, torch.empty((2, t // 2, d), dtype=dtype, device=META)


def test_meta_takes_the_routed_wrappers():
    """On meta (the card's route without a card), ``moe_ep`` without a mesh
    takes ``moe_routed`` for bf16 and records the plan, the experts and
    the combine at their costs, leaving ``LAUNCHES`` alone; float32, an x
    that autograd records, ungated experts and widths the kernels do not
    tile keep the dense oracle and record none."""
    def kernels(**kw):
        grad = kw.pop("grad", False)
        gated = kw.pop("gated", True)
        mcfg, p, x = _meta_layer(**kw)
        if grad:
            x.requires_grad_(True)
        counter = opcount.Counter()
        with opcount.counting(counter):
            out, _ = M.moe_ep(p, x, mcfg, gated)
        assert out.shape == x.shape and out.device == META
        return counter.shards[None].kernels
    before = dict(LAUNCHES)
    got = kernels()
    assert dict(LAUNCHES) == before
    x = torch.empty((40, 64), dtype=torch.bfloat16, device=META)
    rows = torch.empty(80, dtype=torch.int32, device=META)
    wg = torch.empty((8, 64, 32), dtype=torch.bfloat16, device=META)
    c = KM.cost(x, rows, wg)
    cc = KM.combine_cost(torch.empty((0, 64), device=META).bfloat16(),
                         rows, 40)
    assert got["moe_experts"] == {"launches": 1, "flops": c.flops,
                                  "bytes": c.bytes}
    assert got["moe_combine"] == {"launches": 1, "flops": cc.flops,
                                  "bytes": cc.bytes}
    assert got["moe_plan"]["launches"] == 1
    assert c.flops == 6 * 80 * 64 * 32
    for kw in (dict(dtype=torch.float32), dict(grad=True),
               dict(gated=False), dict(f=36)):
        assert not {"moe_plan", "moe_experts", "moe_combine"} & set(
            kernels(**kw)), kw


def test_routes_on_card_keeps_the_cpu_dense():
    """A CPU tensor never takes the routed path, in either dtype."""
    for dtype in (torch.float32, torch.bfloat16):
        mcfg, p, x = _layer(16, 8, 2, 32, dtype=dtype)
        assert not M.routes_on_card(p, x, mcfg, True)


def test_routed_raises_for_ungated_experts():
    mcfg, p, x = _layer(16, 8, 2, 32)
    with pytest.raises(ValueError, match="SwiGLU"):
        M.moe_routed(p, x, mcfg, False)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    """The card's checks, on meta: dtypes, the plan's index type and
    expert count, the tile table's length, widths, contiguity."""
    mcfg, p, x = _meta_layer()
    xf = x.reshape(-1, 64)
    idx = torch.empty((40, 2), dtype=torch.int64, device=META)
    rows, tiles = ops.routed_plan(idx, 8)
    assert rows.shape == (80,) and tiles.shape == (KM.tile_count(80, 8),)
    y = ops.moe_experts(xf, rows, tiles, p["wg"], p["wi"], p["wo"])
    assert y.shape == (tiles.numel() * KM.row_tile(80, 8), 64)
    w = torch.empty((40, 2), device=META)
    assert ops.moe_combine(y, rows, w).shape == (40, 64)
    with pytest.raises(ValueError):
        ops.routed_plan(idx.int(), 8)
    with pytest.raises(ValueError):
        ops.routed_plan(idx, KM.MAX_EXPERTS + 1)
    ws = (p["wg"], p["wi"], p["wo"])
    bad = [(xf.float(), rows, tiles) + ws,
           (xf, rows.long(), tiles) + ws,
           (xf, rows, tiles[:-1]) + ws,
           (xf, rows, tiles, p["wg"][:, :, :12], p["wi"][:, :, :12],
            p["wo"][:, :12]),
           (xf.t().contiguous().t(), rows, tiles) + ws]
    for args in bad:
        with pytest.raises(ValueError):
            ops.moe_experts(*args)
    for args in ((y.float(), rows, w), (y, rows, w.bfloat16()),
                 (y, rows[:-2], w)):
        with pytest.raises(ValueError):
            ops.moe_combine(*args)


def test_routed_prefill_matches_the_dense_smoke_model(monkeypatch):
    """The OLMoE-0924 smoke model with bf16 weights, its MoE layers through
    ``moe_routed`` on the CPU: a prefill within the bf16 bound of the same
    model on ``moe_dense``."""
    from repro_torch import configs
    from repro_torch.models import build_smoke
    cfg = configs.get_smoke_config("olmoe-1b-7b-0924")
    model = build_smoke(cfg, param_dtype=torch.bfloat16)
    assert model.flags.moe_mode == "dense"
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 12),
                         generator=torch.Generator().manual_seed(1))
    want, _ = model.apply(params, {"tokens": toks}, mode="prefill")
    monkeypatch.setattr(M, "moe_dense", M.moe_routed)
    got, _ = model.apply(params, {"tokens": toks}, mode="prefill")
    rel = (got.float() - want.float()).norm() / want.float().norm()
    assert 0 < rel <= 2e-2
