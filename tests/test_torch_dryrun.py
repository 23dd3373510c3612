"""The dry-run of the port (``repro_torch.launch.{dryrun,roofline,
autotune}``, the counter of ``repro_torch.opcount`` and the kernels'
``meta`` arms) against the JAX package where it runs here: the shape
cells, the input specs, the abstract weights and caches, ``layer_norm``
and the analytic FLOP model equal JAX's; the counted FLOPs equal the
analytic model exactly where it is exact; the counts grow linearly with
depth (why no probe correction is ported); collectives count their
payloads; ZeRO-1 on the production mesh places the optimizer state as
without it; seq-sharded KV decode with placed weights serves the tokens
of the one-device Engine and of the JAX Engine; results round-trip
through the roofline table and ``tune``. JAX's own dry-run lowers a
512-device mesh, which does not work here, so the port's lowering is
held to these parts of JAX and, on the card, to the card's own counts
(``chip_smoke.py`` phase 23).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.launch import roofline as JR
from repro.launch.serve import Engine as JEngine
from repro.models import build_model as jbuild_model
from repro.models import build_smoke as jbuild_smoke
from repro.models.layers import layer_norm as jlayer_norm
from repro.models.layers import unbox
from repro.serve import serve_step as JSS
from repro_torch import configs as tconfigs
from repro_torch import opcount
from repro_torch.configs import base as tbase
from repro_torch.convert import (cache_tree_from_jax, lm_from_jax,
                                 lm_tree_from_jax)
from repro_torch.distributed import spmd
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import jacobi3d as JC
from repro_torch.kernels import matmul as MM
from repro_torch.kernels import ssd as SS
from repro_torch.launch import autotune, dryrun
from repro_torch.launch import mesh as TLM
from repro_torch.launch import roofline as TR
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.serve import Engine as TEngine
from repro_torch.models import build_model as tbuild_model
from repro_torch.models import build_smoke as tbuild_smoke
from repro_torch.models.layers import layer_norm as tlayer_norm
from repro_torch.models.sharding import use_sharding
from repro_torch.serve import serve_step as TSS
from repro_torch.train import abstract_train_state
from repro_torch.train.compression import payload_bytes

META = torch.device("meta")
CELLS = [(arch, shape.name) for arch, shape in tbase.all_cells()]


def _shape_tuple(s):
    return (s.name, s.seq_len, s.global_batch, s.kind)


def test_shapes_and_cells_equal_jaxs():
    """``ShapeConfig``, the four shapes, ``shapes_for`` and ``all_cells``
    field for field: 33 cells."""
    assert [f.name for f in dataclasses.fields(tbase.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jbase.ShapeConfig)]
    assert [_shape_tuple(s) for s in tbase.ALL_SHAPES] == \
        [_shape_tuple(s) for s in jbase.ALL_SHAPES]
    assert {k: _shape_tuple(v) for k, v in tbase.SHAPES_BY_NAME.items()} \
        == {k: _shape_tuple(v) for k, v in jbase.SHAPES_BY_NAME.items()}
    for arch in tbase.ARCH_IDS:
        assert [s.name for s in tbase.shapes_for(tbase.get_config(arch))] \
            == [s.name for s in jbase.shapes_for(jbase.get_config(arch))]
    cells = [(a, s.name) for a, s in jbase.all_cells()]
    assert CELLS == cells and len(cells) == 33


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_jaxs(arch, shape):
    """Keys, shapes and dtypes of ``Model.input_specs`` at full configs,
    every tensor on meta."""
    want = jbuild_model(jget_config(arch)).input_specs(
        jbase.SHAPES_BY_NAME[shape])
    got = tbuild_model(tconfigs.get_config(arch)).input_specs(
        tbase.SHAPES_BY_NAME[shape])
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert v.device == META
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(want[k].dtype), k


def _dtype_bytes(leaves):
    out = {}
    for shape, dtype in leaves:
        n = int(np.prod(shape, dtype=np.int64))
        out[dtype] = out.get(dtype, 0) + n
    return out


def _jleaf(x):
    return (tuple(x.shape), str(x.dtype))


def _tleaf(x):
    return (tuple(x.shape), str(x.dtype).split(".")[-1])


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_abstract_params_and_cache_equal_jaxs(arch):
    """``abstract_params`` and ``abstract_cache`` at ``decode_32k``: leaf
    count, elements and bytes by dtype equal JAX's at the full config,
    and leaf for leaf in shape and dtype through ``convert``'s tree
    mapping (shape stand-ins; the smoke config where the full one's JAX
    tree does not map)."""
    shape = jbase.SHAPES_BY_NAME["decode_32k"]
    for smoke in (False, True):
        jcfg = (jget_smoke if smoke else jget_config)(arch)
        tcfg = (tconfigs.get_smoke_config if smoke
                else tconfigs.get_config)(arch)
        jm, tm = jbuild_model(jcfg), tbuild_model(tcfg)
        jp = JSS.abstract_params(jm)
        jc = JSS.abstract_cache(jm, shape.global_batch, shape.seq_len)
        tp = TSS.abstract_params(tm)
        tc = TSS.abstract_cache(tm, shape.global_batch, shape.seq_len)
        for t in _tree_leaves(tp) + _tree_leaves(tc):
            assert t.device == META
        for jt, tt in ((jp, tp), (jc, tc)):
            jl = [_jleaf(x) for x in jax.tree.leaves(jt)]
            tl = [_tleaf(x) for x in _tree_leaves(tt)]
            assert len(jl) == len(tl)
            assert _dtype_bytes(jl) == _dtype_bytes(tl)
        try:
            want_p = lm_tree_from_jax(jax.tree.map(_jleaf, jp,
                                                   is_leaf=_is_sds))
            want_c = cache_tree_from_jax(jax.tree.map(_jleaf, jc,
                                                      is_leaf=_is_sds))
        except NotImplementedError:
            assert not smoke
            continue
        assert want_p == _map(tp, _tleaf)
        assert want_c == _map(tc, _tleaf)
        return


def _is_sds(x):
    return isinstance(x, jax.ShapeDtypeStruct)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jd = getattr(jnp, dtype)
    want = np.asarray(jlayer_norm(jnp.asarray(x).astype(jd),
                                  jnp.asarray(scale), jnp.asarray(bias))
                      .astype(jnp.float32))
    got = tlayer_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 0.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol if dtype == "float32" else 1e-6)


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_analytic_flops_equal_jaxs(arch):
    """``analytic_forward_flops`` and ``analytic_total_flops`` (both remat
    policies) equal the JAX package's exactly on every cell."""
    jcfg, tcfg = jget_config(arch), tconfigs.get_config(arch)
    for shape in tbase.shapes_for(tcfg):
        jshape = jbase.SHAPES_BY_NAME[shape.name]
        assert TR.analytic_forward_flops(tcfg, shape) == \
            JR.analytic_forward_flops(jcfg, jshape)
        for remat in ("full", "dots"):
            assert TR.analytic_total_flops(tcfg, shape, remat) == \
                JR.analytic_total_flops(jcfg, jshape, remat)
    assert TR._layer_kinds(tcfg) == JR._layer_kinds(jcfg)


@pytest.mark.parametrize("arch", ["yi_9b", "phi4_mini_3_8b",
                                  "codeqwen15_7b"])
def test_counted_flops_equal_the_analytic_model(arch):
    """Dense smoke configs under the dry-run's flags on one shard: a
    decode step counts the analytic total exactly, its attention the
    decode kernel's (one launch a layer) where the heads are whole 16-byte
    rows (codeqwen's smoke head of 12 keeps the plain path); a
    prefill's (32,768 tokens, a multiple of 128: the flash kernel's
    route, one launch a layer) outside the kernel are its projections,
    MLP and last-position logits exactly."""
    cfg = tconfigs.get_smoke_config(arch)
    for shape in ("decode_32k", "prefill_32k"):
        r = dryrun.lower_cell(arch, shape, chips=1, smoke=True)
        ana = TR.analytic_forward_flops(cfg, tbase.SHAPES_BY_NAME[shape])
        kernel = sum(v["flops"] for v in r["kernels"].values())
        if shape == "decode_32k":
            if cfg.resolved_head_dim % 8:
                assert r["kernels"] == {}
            else:
                assert list(r["kernels"]) == ["decode_attention"]
                assert r["kernels"]["decode_attention"]["launches"] == \
                    cfg.n_layers
                assert kernel == ana["attn"]
            assert r["flops_per_device"] == ana["total"]
        else:
            assert r["kernels"]["flash_attention"]["launches"] == \
                cfg.n_layers
            assert r["flops_per_device"] - kernel == \
                ana["proj"] + ana["mlp"] + ana["loss"]


@pytest.mark.parametrize("arch", ["yi_9b", "mamba2_370m"])
def test_counts_are_linear_in_depth(arch):
    """At probe 0, 1 and 2 (periods) over (1, 2) meta shards, FLOPs,
    bytes and collective bytes grow by the same amount a period, and the
    full depth is c0 + n_periods · (c1 − c0): the eager count needs none
    of the JAX package's probe corrections."""
    def counts(probe):
        r = dryrun.lower_cell(arch, "decode_32k", chips=2, smoke=True,
                              probe=probe)
        return np.array([r["flops_per_device"], r["bytes_per_device"],
                         r["collective_total_bytes"]], dtype=object)
    c0, c1, c2, full = (counts(p) for p in (0, 1, 2, None))
    assert list(c2 - c1) == list(c1 - c0)
    cfg = tconfigs.get_smoke_config(arch)
    n = cfg.n_layers // len(cfg.layer_pattern)
    assert list(full) == list(c0 + n * (c1 - c0))
    assert c1[0] > c0[0] and c1[1] > c0[1]


def test_dryrun_machinery_smoke():
    """The counterpart of the JAX package's machinery smoke: olmoe-1b-7b's
    decode at full size over four meta shards."""
    r = dryrun.lower_cell("olmoe_1b_7b", "decode_32k", chips=4)
    assert r["chips"] == 4 and r["mesh"] == {"data": 1, "model": 4}
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["argument_size_in_bytes"] > r["alias_size_in_bytes"] > 0
    assert r["collective_bytes_per_device"]["all-to-all"] > 0
    assert r["card"] == "NVIDIA H100 80GB HBM3, 700 W"
    json.dumps(r)


# the smoke cell each variant changes and its shards (yi-9b's smoke kv
# heads, 2, do not divide 4: its decode can split the slots;
# compress_pod on the multi-pod mesh (2, 1, 2); the sequence-parallel
# stacks over a model axis of 2)
VARIANT_CELLS = {"od2": ("yi_9b", "train_4k", 1),
                 "od4": ("yi_9b", "train_4k", 1),
                 "od8": ("yi_9b", "train_4k", 1),
                 "dots": ("yi_9b", "train_4k", 1),
                 "loss_chunk512": ("yi_9b", "train_4k", 1),
                 "kvseq_model": ("yi_9b", "decode_32k", 4),
                 "ssd_chunk128": ("mamba2_370m", "prefill_32k", 1),
                 "compress_pod": ("yi_9b", "train_4k", 4, True),
                 # the sequence-parallel stacks on one prefill over
                 # (1, 2): the rule changes it (their other parts have
                 # rows of their own; the sp train step is
                 # test_torch_seqpar.py's)
                 "sp": ("yi_9b", "prefill_32k", 2),
                 "sp_od4": ("yi_9b", "prefill_32k", 2),
                 "sp_od8": ("yi_9b", "prefill_32k", 2),
                 "dots_sp": ("yi_9b", "prefill_32k", 2),
                 "dots_sp_od4": ("yi_9b", "prefill_32k", 2),
                 "dots_sp_od8": ("yi_9b", "prefill_32k", 2),
                 "ssd_chunk128_dots_sp": ("yi_9b", "prefill_32k", 2)}


@functools.lru_cache(maxsize=None)
def _variant_counts(arch, shape, chips, multi_pod=False, *, variant):
    """One step's counts at batch 8, one attention block (fewer ops to
    count; the variants change neither); a cell's baseline is counted
    once for the variants that share it."""
    kw = dict(dryrun.VARIANTS[variant])
    kw["extra_flags"] = {"flash_block": 4096, **kw.get("extra_flags", {})}
    cell = dryrun.build_cell(arch, shape, chips=chips, probe=1, smoke=True,
                             batch=8, multi_pod=multi_pod, **kw)
    return dryrun.count_step(cell)[0].summary()


@pytest.mark.parametrize("variant", sorted(VARIANT_CELLS))
def test_each_variant_changes_the_step(variant):
    """Every named stack but ``baseline`` changes what its cell's step
    does: its counts differ from the baseline's."""
    assert set(VARIANT_CELLS) == set(dryrun.VARIANTS) - {"baseline"}
    cell = VARIANT_CELLS[variant]
    assert _variant_counts(*cell, variant=variant) != \
        _variant_counts(*cell, variant="baseline")


def test_multi_pod_compress_pod_lowers_yi_train_on_meta():
    """``--multi-pod --data 2 --variant compress_pod``: yi-9b's
    ``train_4k`` at full width, probe 1 (batch 8, one attention block)
    lowers on (2, 2, 2) meta shards with residuals placed; the all-gather
    bytes exceed the uncompressed step's (the same mesh and rules) by the
    int8 payload and its scales exactly; the tag names the mesh."""
    kw = dict(multi_pod=True, data=2, probe=1, batch=8,
              extra_flags={"flash_block": 4096})
    cell = dryrun.build_cell("yi_9b", "train_4k",
                             **dryrun.VARIANTS["compress_pod"], **kw)
    plain = dryrun.build_cell("yi_9b", "train_4k",
                              extra_rules={"vocab": None}, **kw)
    assert cell.mesh.shape == {"pod": 2, "data": 2, "model": 2}
    state = cell.args["state"]
    assert plain.args["state"].ef is None
    assert all(tuple(r.spec)[0] == "pod" for r in _tree_leaves(state.ef))
    assert not any(state.params["embed"].spec)         # vocab replicated
    got = dryrun.result_of(cell, *dryrun.count_step(cell), 0.0, "baseline")
    want = dryrun.result_of(plain, *dryrun.count_step(plain), 0.0,
                            "baseline")
    assert got["mesh"] == {"pod": 2, "data": 2, "model": 2}
    assert got["collective_bytes_per_device"]["all-gather"] - \
        want["collective_bytes_per_device"]["all-gather"] == \
        sum(payload_bytes(state.params))
    assert got["argument_size_in_bytes"] - want["argument_size_in_bytes"] \
        == 4 * sum(int(np.prod(p.shards[0].shape))
                   for p in _tree_leaves(state.params))
    assert dryrun.result_path("r", "yi_9b", "train_4k", 8, "baseline",
                              multi_pod=True, data=2) == \
        "r/yi_9b__train_4k__pod2dp2tp8__baseline.json"


@pytest.mark.parametrize("multi_pod", [False, True], ids=["2x4", "2x2x2"])
def test_data_axis_places_zero1_as_jaxs_opt_specs(multi_pod):
    """``--data 2`` over 8 meta shards, (2, 4) and with ``--multi-pod``
    (2, 2, 2): every parameter, moment and master leaf of yi-9b's train
    cell lies by JAX's ``opt_specs(zero=True)`` on an abstract JAX mesh
    of that shape (leaf for leaf through ``convert``'s layout mapping)."""
    from jax.sharding import AbstractMesh
    from repro.launch.mesh import opt_specs as jopt_specs
    from repro.train import abstract_train_state as jabstract_train_state
    shape, names = ((2, 2, 2), ("pod", "data", "model")) if multi_pod \
        else ((2, 4), ("data", "model"))
    jm = jbuild_model(jget_config("yi_9b"))
    _, axes = unbox(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))))
    jspecs = jopt_specs(jabstract_train_state(jm), axes,
                        AbstractMesh(shape, names), zero=True)
    cell = dryrun.build_cell("yi_9b", "train_4k", multi_pod=multi_pod,
                             data=2, probe=None)
    assert cell.mesh.shape == dict(zip(names, shape))
    state = cell.args["state"]
    split = 0
    for part in ("params", "m", "v", "master"):
        tree = state.params if part == "params" else getattr(state.opt, part)
        jtree = jspecs.params if part == "params" else \
            getattr(jspecs.opt, part)
        want = lm_tree_from_jax(jax.tree.map(
            lambda ns: tuple(ns.spec), jtree,
            is_leaf=lambda x: hasattr(x, "spec")))
        got = _map(tree, lambda x: tuple(x.spec))
        assert got == want, part
        split += sum("data" in str(s) for s in _tree_leaves(got))
    assert split > 0


def test_default_tag_and_result_keys_are_unchanged():
    """Without ``--data`` and ``--multi-pod`` a cell lowers on (1, chips)
    under its former tag, with the former result keys."""
    assert dryrun.result_path("r", "yi_9b", "decode_32k", 8, "opt") == \
        "r/yi_9b__decode_32k__tp8__opt.json"
    assert dryrun.result_path("r", "a", "s", 4, "baseline", probe=1,
                              data=1) == "r/a__s__tp4__baseline__probe1.json"
    r = dryrun.lower_cell("yi_9b", "decode_32k", chips=2, smoke=True,
                          probe=1)
    assert r["mesh"] == {"data": 1, "model": 2}
    assert sorted(r) == sorted(RESULT_KEYS)


# the keys of a default cell's result, which the multi-pod options leave
# as they were
RESULT_KEYS = (
    "arch", "shape", "mesh", "chips", "opt_level", "over_decompose",
    "seq_shard_kv", "probe", "n_layers", "period", "setup_s", "run_s",
    "card", "constants", "flops_per_device", "bytes_per_device",
    "flops_per_device_max", "bytes_per_device_max",
    "argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes",
    "temp_size_in_bytes", "collective_bytes_per_device",
    "collective_total_bytes", "ops_dispatched", "ops", "kernels",
    "t_compute", "t_memory", "t_collective", "bottleneck",
    "step_time_bound_s", "model_flops_per_device", "model_vs_hlo_flops")


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_count_their_payloads(n):
    """Each collective on a (1, n) meta mesh adds its payload bytes on
    every shard under JAX's names."""
    mesh = make_smoke_mesh(1, n, devices=[META] * n)
    P = spmd.P

    def body(x):
        a = spmd.psum(x, "model")                     # 4·8·4 B
        b = spmd.pmean(x[:1], "model")                # 8·4
        c = spmd.pmax(x[:2], "model")                 # 16·4
        d = spmd.all_gather(x[:3], "model")           # 24·4
        e = spmd.all_to_all(x, "model", 0, 1, tiled=True)  # 32·4
        f = spmd.ppermute(x, "model", [(0, 1)])       # 32·4
        g = spmd.psum_scatter(x, "model", 1)          # 32·4
        return a + b + c[:1] + d[0, :1] + e[:1, :8] + f + g[:, :1]
    x = torch.empty((4 * n, 8), device=META)
    counter = opcount.Counter()
    with opcount.counting(counter):
        spmd.shard_map(body, mesh, P("model"), P("model"))(x)
    for i in range(n):
        got = counter.shards[i].collectives
        assert got == {"all-reduce": (32 + 8 + 16) * 4, "all-gather": 96,
                       "all-to-all": 128, "collective-permute": 128,
                       "reduce-scatter": 128}, (i, got)
    assert sum(counter.shards[None].collectives.values()) == 0


@pytest.mark.parametrize("n", [2, 4, 8])
def test_zero1_on_the_production_mesh_places_as_without(n):
    """``opt_specs(zero=True)`` on (1, n) gives every leaf the blocks
    ``zero=False`` gives it: ZeRO-1 over a data axis of 1 shards nothing."""
    mesh = TLM.make_production_mesh(devices=[META] * n)
    tm = tbuild_model(tconfigs.get_config("yi_9b"))
    state = abstract_train_state(tm)
    on = TLM.opt_specs(state, tm.axes(), mesh, zero=True)
    off = TLM.opt_specs(state, tm.axes(), mesh, zero=False)
    for part in ("m", "v", "master"):
        a, b = getattr(on.opt, part), getattr(off.opt, part)
        leaves = _tree_leaves(getattr(state.opt, part))
        for x, sa, sb in zip(leaves, _tree_leaves(a), _tree_leaves(b),
                             strict=True):
            assert [_region(mesh, sa.spec, i, x.shape) for i in range(n)] \
                == [_region(mesh, sb.spec, i, x.shape) for i in range(n)]


def _region(mesh, spec, i, shape):
    """Shard ``i``'s block of a value of ``shape`` under ``spec``, every
    dim named."""
    r = spmd._blocks(mesh, spec, i, shape)
    return r + tuple(slice(0, n) for n in shape[len(r):])


def _engine_tokens(model, params, toks, extra, mesh=None):
    if mesh is None:
        eng = TEngine(model, params, toks.shape[0], 40)
        nxt, cache, logits = eng.prefill(toks, extra, logits=True)
        return eng.decode(cache, nxt, toks.shape[1], 8), cache, logits
    with use_sharding(mesh):
        eng = TEngine(model, params, toks.shape[0], 40)
        nxt, cache, logits = eng.prefill(toks, extra, logits=True)
        return eng.decode(cache, nxt, toks.shape[1], 8), cache, logits


@pytest.mark.parametrize("arch", ["yi_9b", "gemma3_27b", "recurrentgemma_9b",
                                  "whisper_large_v3"])
def test_seq_shard_kv_serves_with_placed_weights(arch):
    """``Flags.seq_shard_kv="model"`` over (1, 4) CPU shards, smoke
    configs whose kv heads do not divide the model axis (whisper's do:
    its cache gathers the kv heads): the weights placed, each shard
    holding T / 4 of every attention cache's slots; the prefill's logits
    within 1e-5 of the one-device Engine's, 8 greedy tokens equal and the
    cache after them within 1e-5; for yi-9b the tokens also equal the JAX
    Engine's on the same weights."""
    cfg = tconfigs.get_smoke_config(arch)
    one = tbuild_smoke(cfg)
    seq = tbuild_smoke(cfg, seq_shard_kv="model")
    params = one.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)))
    extra = {}
    if cfg.enc_dec:
        extra = {"frames": torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.1)}
    want, want_cache, want_logits = _engine_tokens(one, params, toks, extra)
    mesh = make_smoke_mesh(1, 4, devices=["cpu"] * 4)
    got, cache, logits = _engine_tokens(seq, params, toks, extra, mesh)
    assert torch.equal(got, want)
    torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-5)
    for name, leaf in TSS.flatten(cache):
        if name.endswith((".k", ".v")) or name in ("k", "v"):
            t_dim = len(leaf.shape) - 3
            assert leaf.shards[0].shape[t_dim] * 4 == leaf.shape[t_dim]
        torch.testing.assert_close(
            leaf.full(), dict(TSS.flatten(want_cache))[name], rtol=1e-5,
            atol=1e-5)
    if arch == "yi_9b":
        jm = jbuild_smoke(jget_smoke(arch))
        jp, _ = unbox(jm.init(jax.random.PRNGKey(0)))
        tp = lm_from_jax(jax.tree.map(np.asarray, jp))
        jtok = np.asarray(JEngine(jm, jp, 2, 40).generate(
            jnp.asarray(toks.numpy()), 9))
        got, _, _ = _engine_tokens(seq, tp, toks, {}, mesh)
        np.testing.assert_array_equal(got.numpy(), jtok[:, 1:])


def test_lowerings_round_trip_through_the_table_and_tune(tmp_path):
    """``lower_cell`` → result files → ``build_table`` → ``tune`` on two
    smoke cells at both levels over (1, 4) meta shards: yi-9b's decode
    (kv heads 2: the opt level splits the cache's slots) and mamba2-370m's;
    ``tune`` keeps the level with the smaller bound."""
    cells = (("yi_9b", "decode_32k"), ("mamba2_370m", "decode_32k"))
    for arch, shape in cells:
        for level in ("baseline", "opt"):
            r = dryrun.lower_cell(arch, shape, chips=4, opt_level=level,
                                  smoke=True)
            with open(dryrun.result_path(str(tmp_path), arch, shape, 4,
                                         level), "w") as f:
                json.dump(r, f)
    base = {r["arch"]: r for r in TR.build_table(str(tmp_path), "baseline",
                                                  4)}
    opt = {r["arch"]: r for r in TR.build_table(str(tmp_path), "opt", 4)}
    assert sorted(base) == sorted(opt) == ["mamba2_370m", "yi_9b"]
    assert base["yi_9b"]["collectives"] != opt["yi_9b"]["collectives"]
    tuned = autotune.tune(str(tmp_path), 4)
    assert sorted(tuned) == [f"{a}__{s}" for a, s in sorted(cells)]
    for arch, shape in cells:
        b, o = base[arch]["step_time_bound_s"], opt[arch]["step_time_bound_s"]
        t = tuned[f"{arch}__{shape}"]
        assert t["config"] == ("opt" if o < b else "baseline")
        assert t["step_bound_s"] == min(b, o)


def test_meta_kernel_arms_record_a_launch_and_its_cost():
    """On meta, flash (both entry points), decode attention and ssd_chunk
    return empty outputs of the kernel's shapes and record one launch and
    its cost with the counter, leaving ``LAUNCHES`` alone; on the CPU they
    still take the plain version and record nothing."""
    before = dict(LAUNCHES)
    q = torch.empty((2, 256, 2, 4, 64), dtype=torch.bfloat16, device=META)
    k = torch.empty((2, 256, 2, 64), dtype=torch.bfloat16, device=META)
    q3 = torch.empty((16, 128, 64), device=META)
    k3 = torch.empty((16, 128, 64), device=META)
    qd = torch.empty((2, 2, 4, 64), dtype=torch.bfloat16, device=META)
    nd = torch.empty((2,), dtype=torch.int32, device=META)
    ssd_args = [torch.empty(s, device=META) for s in
                ((4, 64, 8, 16), (4, 64, 8), (8,), (4, 64, 16), (4, 64, 16))]
    counter = opcount.Counter()
    with opcount.counting(counter):
        out = FA.flash_attention_gqa(q, k, k)
        out3 = FA.flash_attention(q3, k3, k3)
        outd = DA.decode_attention(qd, k, k, nd)
        y, st = SS.ssd_chunk(*ssd_args)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out3.shape == q3.shape and out.device == META
    assert outd.shape == qd.shape and outd.dtype == qd.dtype
    assert y.shape == (4, 64, 8, 16) and st.shape == (4, 8, 16, 16)
    got = counter.shards[None].kernels
    c1, c3 = FA.cost(q, k), FA.cost(q3, k3)
    cd, cs = DA.cost(qd, k), SS.cost(*ssd_args)
    assert got == {"flash_attention": {"launches": 2,
                                       "flops": c1.flops + c3.flops,
                                       "bytes": c1.bytes + c3.bytes},
                   "decode_attention": {"launches": 1, "flops": cd.flops,
                                        "bytes": cd.bytes},
                   "ssd_chunk": {"launches": 1, "flops": cs.flops,
                                 "bytes": cs.bytes}}
    # ssd's three buffers and decode's two partials (the outputs are
    # ``empty_like``)
    assert counter.shards[None].ops["aten.empty.memory_format"] == 5
    assert dict(LAUNCHES) == before
    gen = torch.Generator().manual_seed(0)
    qc = torch.randn((1, 64, 1, 2, 16), generator=gen)
    kc = torch.randn((1, 64, 1, 16), generator=gen)
    qdc = torch.randn((1, 1, 2, 16), generator=gen)
    ndc = torch.tensor([40], dtype=torch.int32)
    counter = opcount.Counter()
    with opcount.counting(counter):
        got = FA.flash_attention_gqa(qc, kc, kc)
        gotd = DA.decode_attention(qdc, kc, kc, ndc)
    assert torch.equal(got, FA.flash_attention_plain(qc, kc, kc))
    assert torch.equal(gotd, DA.decode_attention_plain(qdc, kc, kc, ndc))
    assert counter.shards[None].kernels == {}
    assert dict(LAUNCHES) == before


def test_ssd_meta_arm_copies_a_misaligned_view_as_the_card_does():
    """The card copies an operand view that starts off a 16-byte
    boundary; the meta arm decides by the storage offset, the same
    answer (every meta tensor's ``data_ptr()`` is 0)."""
    x = torch.empty((4 * 64 * 8 * 16 + 1,), device=META)[1:].view(
        4, 64, 8, 16)
    rest = [torch.empty(s, device=META) for s in
            ((4, 64, 8), (8,), (4, 64, 16), (4, 64, 16))]
    counter = opcount.Counter()
    with opcount.counting(counter):
        SS.ssd_chunk(x, *rest)
    assert counter.shards[None].ops["aten.clone.default"] == 1


def test_costs_are_phase_twos_formulas():
    """Each kernel's ``cost`` at phase 2's shapes equals the formula
    ``chip_smoke.py`` inlined before it called them, to the digit."""
    n, c = 768, 384
    u_pad = torch.empty((n + 2,) * 3, device=META)
    assert JC.cost(u_pad) == (6 * n ** 3, 4 * ((n + 2) ** 3 + n ** 3))
    u = torch.empty((c,) * 3, device=META)
    faces = [torch.empty((c, c), device=META)] * 6
    assert JC.faces_cost(u, *faces) == (6 * c ** 3,
                                        4 * (2 * c ** 3 + 6 * c * c))
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.empty((4096, 4096), dtype=dtype, device=META)
        assert MM.cost(a, a) == (2 * 4096 ** 3,
                                 3 * 4096 * 4096 * a.element_size())
    for b, s, kh, g, d in ((4, 2048, 4, 8, 128), (4, 2048, 1, 16, 256),
                           (2, 4096, 16, 2, 128)):
        bh = b * kh * g
        q = torch.empty((b, s, kh, g, d), dtype=torch.bfloat16, device=META)
        k = torch.empty((b, s, kh, d), dtype=torch.bfloat16, device=META)
        work = FA.cost(q, k)
        assert float(work.flops) == bh * s * (s + 1) / 2 * 4 * d
        assert work.bytes == (2 * q.numel() + 2 * k.numel()) * 2
        q3 = torch.empty((bh, s, d), device=META)
        work = FA.cost(q3, q3)
        assert float(work.flops) == bh * s * (s + 1) / 2 * 4 * d
        assert work.bytes == 4 * bh * s * d * 4
    # decode attention at yi-9b's decode shape: q [64, 4, 8, 128] against
    # a cache of 2,176 slots
    b, t, kh, g, d = 64, 2176, 4, 8, 128
    qd = torch.empty((b, kh, g, d), dtype=torch.bfloat16, device=META)
    kd = torch.empty((b, t, kh, d), dtype=torch.bfloat16, device=META)
    work = DA.cost(qd, kd)
    assert work.flops == 4 * b * kh * g * d * t
    assert work.bytes == (2 * b * kh * g * d + 2 * b * t * kh * d) * 2
    bc, q, h, p, nn = 128, 256, 32, 64, 128
    args = [torch.empty(sh, device=META) for sh in
            ((bc, q, h, p), (bc, q, h), (h,), (bc, q, nn), (bc, q, nn))]
    pairs = q * (q + 1) / 2
    work = SS.cost(*args)
    assert float(work.flops) == 2 * bc * (pairs * nn + h * pairs * p
                                          + h * q * p * nn)
    assert work.bytes == 4 * (2 * bc * q * h * p + bc * q * h + h
                              + 2 * bc * q * nn + bc * h * p * nn)


def test_shares_tells_meta_shards_apart():
    """``spmd.shares`` by storage identity: a replicated leaf placed with
    sharing is shared on a meta mesh as on a card, ``unshare`` copies."""
    mesh = make_smoke_mesh(1, 4, devices=[META] * 4)
    x = torch.empty((8, 8), device=META)
    shared = spmd.place({"x": x}, {"x": spmd.NamedSharding(mesh,
                                                           spmd.P())})["x"]
    assert spmd.shares(shared)
    assert not spmd.shares(spmd.unshare(shared))
    split = spmd.place({"x": x}, {"x": spmd.NamedSharding(
        mesh, spmd.P("model"))})["x"]
    assert not spmd.shares(split)


def test_counter_tracks_live_bytes_and_their_peak():
    """Bytes the step allocates are live while a tensor (a view too)
    holds their storage; the peak keeps the most at once."""
    counter = opcount.Counter()
    with opcount.counting(counter):
        a = torch.empty((1024,), device=META)          # 4 KiB
        b = a[:10]
        del a
        c = torch.empty((256,), device=META)            # 1 KiB
        del b
        d = c + 1                                       # 1 KiB
        del c, d
    top = counter.shards[None]
    assert top.live == 0
    assert counter.peak_with_caller[None] == 5 * 1024
    assert counter.peak_all == 5 * 1024
