"""Decoder-only LM assembly (``repro/models/transformer.py`` at the same
path), for stacks of attention layers (global, or a pattern of local and
global, each + MLP, or + MoE where the config has one), of Mamba-2 SSD
blocks (no MLP, no ``norm2``) and of RG-LRU and local attention layers
(each + MLP), with the vision frontend's precomputed embeddings written
over the head of the sequence.

As in the JAX package, the layer stack is ``cfg.layer_pattern`` (a
repeating period, e.g. 5 x local_attn + 1 x global_attn for gemma3)
repeated ``n_layers // period`` times, then the pattern's first
``n_layers % period`` kinds as remainder layers. The parameters of each
position of the period are stacked along a leading axis over the periods,
and so is the cache. Where the period is one layer the stack sits at
``layers`` and its cache at the root: ``{"k", "v"}: [L, B, T, KH, D]`` for
attention, ``{"conv": [L, B, W-1, C], "state": [L, B, H, P, N]}`` for SSD.
A longer period keeps the JAX package's tree: ``periods`` (one entry per
position, keyed "0", "1", ...) and ``rem_{i}``, in the parameters and the
cache alike; a local layer's cache has ``min(window, capacity)`` slots, an
RG-LRU layer's is ``{"conv": [B, K-1, W], "state": [B, W]}`` (the state in
float32).
The stack runs as a Python loop over layer views, where the JAX package
scans. The weights live in a ``ParamTree`` module (or a nested dict of
tensors, as training passes them); the apply functions are plain
functions over it, like their JAX counterparts. Train mode returns the
MoE aux loss beside the hidden states, runs each layer under
``Flags.remat`` and takes no forward-only kernel; ``chunked_ce_loss`` is
the training loss.

``lm_axes`` gives the weights' logical sharding axes, leaf for leaf, and
``init_placed`` draws them straight onto a mesh. Inside a ``shard_map``
body (a model served or trained on a mesh: ``serve.serve_step``,
``train.train_step``) the same functions run on each shard's blocks: the
embedding vocab-parallel (a masked lookup and a ``psum``), the logits the
shard's slice of the vocabulary and ``chunked_ce_loss`` vocab-parallel
(``layers.softmax_cross_entropy``), the attention, MLP and MoE layers
split as their modules say. Under ``remat`` the backward recomputes a
layer's collectives on every shard in the same order. Where the body
splits the sequence (``sharding.split_sequence``: the rule ``act_seq ->
model``), the embedding returns the shard's slice of the positions, the
blocks, their norms and residual adds and the final norm run on slices,
and each layer gathers and reduce-scatters as its module says.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import (GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD,
                                      ModelConfig)
from repro_torch.core import spans
from repro_torch.distributed import spmd
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.sharding import constrain, seq_gather, seq_start


@dataclasses.dataclass(frozen=True)
class Flags:
    """The lowering flags this path reads.

    ``use_flash_kernel`` is the counterpart of the JAX package's
    ``use_pallas_flash``: causal global self-attention with S a multiple
    of 128 goes through the hand-written CUDA kernel (its plain version on
    a CPU tensor) in prefill, and a decode step's self-attention against
    a bf16 cache on the card through the decode kernel, which replaces no
    Pallas kernel (``attention.attention_layer``). It is on in
    ``DEFAULT_FLAGS``, the serving path on the card. Train mode never takes a forward-only kernel: the
    Pallas kernel has no backward, and the JAX model's defaults
    (``use_pallas_flash`` False) train on the blockwise path, so global
    attention in train mode takes the plain blockwise path whatever this
    flag says, and an SSD layer the einsum path: the JAX semantics, not a
    fallback. ``flash_block`` is the block of the plain blockwise path;
    the JAX package declares the same field and its attention uses 512,
    the default here. ``use_ssd_kernel`` takes the SSD block's
    intra-chunk form (one group) from the hand-written CUDA kernel (its
    plain version on a CPU tensor) instead of the einsum path in prefill;
    the JAX model never calls its Pallas kernel, whose function is the
    same. ``seq_shard_kv`` names the mesh axis over which the
    serving steps split every attention cache's slots when the weights are
    placed (``serve.serve_step.init_mesh_cache``); each layer then decodes
    over its shard's slots and combines the partials over that axis
    (``attention._seq_split_decode``). ``moe_mode`` takes an MoE layer
    through ``moe.moe_ep`` ("ep": expert-parallel over the active mesh,
    the dense oracle without one) or ``moe.moe_dense`` ("dense").

    Training reads two more, with the JAX package's defaults.
    ``loss_chunk`` is the sequence chunk of ``chunked_ce_loss``.
    ``remat`` is what a train-mode forward keeps for the backward, each
    layer under ``torch.utils.checkpoint`` where the JAX package wraps
    each period of its scan in ``jax.checkpoint``: "none" keeps every
    activation; "full" keeps only each layer's input and recomputes the
    layer in the backward; "dots" (``checkpoint_dots_with_no_batch_dims``)
    keeps the outputs of the products without batch dims, that is every
    ``aten.mm`` / ``aten.addmm`` (the projections and MLP products), and
    recomputes the rest (norms, rope, the attention's batched score and
    value products and softmax), by selective checkpointing. Under either
    the loss recomputes each chunk's logits in the backward."""
    param_dtype: Any = torch.bfloat16
    moe_mode: str = "ep"
    use_flash_kernel: bool = True
    flash_block: int = 512
    use_ssd_kernel: bool = True
    seq_shard_kv: Optional[str] = None
    remat: str = "dots"
    loss_chunk: int = 1024


DEFAULT_FLAGS = Flags()
SMOKE_FLAGS = Flags(param_dtype=torch.float32, moe_mode="dense",
                    use_flash_kernel=False, use_ssd_kernel=False,
                    remat="none", loss_chunk=64)

_NOT_PORTED = "not ported (see ROADMAP.md)"


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration whose layers the port does not run. An
    encoder-decoder (``models.encdec``) takes the audio frontend's frame
    embeddings; a decoder-only LM (this module) no frontend or the vision
    one."""
    if cfg.enc_dec or cfg.frontend == "audio":
        if not (cfg.enc_dec and cfg.frontend == "audio"
                and cfg.layer_pattern == (GLOBAL_ATTN,)):
            raise NotImplementedError(
                f"{cfg.name}: only an encoder-decoder of global attention "
                f"layers fed by the audio frontend runs; enc_dec "
                f"{cfg.enc_dec}, frontend {cfg.frontend!r}, layers "
                f"{cfg.layer_pattern} are {_NOT_PORTED}")
        return
    if cfg.frontend not in ("none", "vision"):
        raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} "
                                  f"is {_NOT_PORTED}")
    kinds = set(cfg.layer_pattern)
    if not (kinds <= {GLOBAL_ATTN, LOCAL_ATTN} or kinds == {SSD}
            or kinds <= {RGLRU, LOCAL_ATTN}):
        raise NotImplementedError(f"{cfg.name}: layer kinds {sorted(kinds)} "
                                  f"(only attention stacks, global and "
                                  f"local, all-SSD stacks and RG-LRU with "
                                  f"local attention run) are {_NOT_PORTED}")


class ParamTree(nn.Module):
    """A nested dict of tensors held as parameters, registered without
    gradients (serving records nothing). ``tree()`` hands out the
    parameters themselves, so that autograd reaches them once
    ``requires_grad_()`` asks for it; the train step differentiates
    detached copies of its state's leaves instead
    (``train.train_step.make_grad_fn``)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        """The nested dict of parameters."""
        out: Dict[str, Any] = dict(self._parameters)
        for key, m in self._modules.items():
            out[key] = m.tree()
        return out


def _tree(params) -> Dict[str, Any]:
    """The weights as a nested dict, from a ``ParamTree`` or a dict."""
    return params.tree() if isinstance(params, ParamTree) else params


def _at(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Views of every leaf at position ``i`` of its leading axis."""
    return {k: _at(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Per-layer block = (attention | RG-LRU) + (MLP | MoE), or SSD alone;
# pre-norm residual
# ---------------------------------------------------------------------------

def _qk_norm(cfg: ModelConfig) -> bool:
    """Whether the attention layers norm q and k (``configs.
    PortModelConfig.qk_norm``; False for every other configuration)."""
    return getattr(cfg, "qk_norm", False)


def _is_moe_layer(cfg: ModelConfig, kind: str) -> bool:
    return cfg.moe is not None and kind in (GLOBAL_ATTN, LOCAL_ATTN) \
        and cfg.moe.interleave == 1


def block_init(gen, cfg: ModelConfig, kind: str, *, dtype, device,
               lead: Tuple[int, ...] = ()) -> Dict[str, Any]:
    if kind == SSD:   # mamba2 blocks have no separate MLP
        return {"norm1": L.scale_init(cfg.d_model, device=device, lead=lead),
                "ssd": S.ssd_init(gen, cfg.d_model, cfg.ssm, dtype=dtype,
                                  device=device, lead=lead)}
    if kind == RGLRU:
        mix = {"rglru": R.rglru_init(gen, cfg.d_model, cfg.rglru, cfg.n_heads,
                                     dtype=dtype, device=device, lead=lead)}
    else:
        mix = {"attn": A.attn_init(gen, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.resolved_head_dim,
                                   dtype=dtype, device=device, lead=lead,
                                   qk_norm=_qk_norm(cfg))}
    if _is_moe_layer(cfg, kind):
        ffn = {"moe": M.moe_init(gen, cfg.d_model, cfg.moe, cfg.gated_mlp,
                                 dtype=dtype, device=device, lead=lead)}
    else:
        ffn = {"mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                                 dtype=dtype, device=device, lead=lead)}
    return {
        "norm1": L.scale_init(cfg.d_model, device=device, lead=lead),
        **mix,
        "norm2": L.scale_init(cfg.d_model, device=device, lead=lead),
        **ffn,
    }


def block_axes(cfg: ModelConfig, kind: str,
               lead: L.Axes = ()) -> Dict[str, Any]:
    """``block_init``'s logical axes."""
    scale = lead + L.SCALE_AXES
    if kind == SSD:
        return {"norm1": scale, "ssd": S.ssd_axes(lead)}
    mix = {"rglru": R.rglru_axes(lead)} if kind == RGLRU else \
        {"attn": A.attn_axes(lead, _qk_norm(cfg))}
    if _is_moe_layer(cfg, kind):
        ffn = {"moe": M.moe_axes(cfg.gated_mlp, bool(cfg.moe.d_ff_shared),
                                 lead)}
    else:
        ffn = {"mlp": L.mlp_axes(cfg.gated_mlp, lead)}
    return {"norm1": scale, **mix, "norm2": scale, **ffn}


def block_apply(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
                kind: str, mode: str, flags: Flags,
                cache: Optional[Dict] = None,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (x, new_cache, aux_loss): aux is an MoE layer's
    load-balance loss, a float32 zero for any other layer. Train mode
    takes no forward-only kernel (``Flags``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    with spans.span("model.norm"):
        h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == SSD:
        mix, new_cache = S.ssd_layer(p["ssd"], h, scfg=cfg.ssm, mode=mode,
                                     cache=cache,
                                     use_kernel=flags.use_ssd_kernel)
        return x + mix, new_cache, aux
    if kind == RGLRU:
        mix, new_cache = R.rglru_layer(p["rglru"], h, rcfg=cfg.rglru,
                                       mode=mode, cache=cache)
    else:
        with spans.span("model.attention"):
            mix, new_cache = A.attention_layer(
                p["attn"], h, kind=kind, window=cfg.window,
                rope_theta=cfg.rope_theta, n_kv_heads=cfg.n_kv_heads,
                mode=mode, lengths=lengths, cache=cache,
                use_kernel=flags.use_flash_kernel,
                flash_block=flags.flash_block,
                qk_norm_eps=cfg.norm_eps if _qk_norm(cfg) else None)
    x = x + mix
    with spans.span("model.norm"):
        h = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    with spans.span("model.mlp"):
        if "moe" in p:
            moe = M.moe_ep if flags.moe_mode == "ep" else M.moe_dense
            y, aux = moe(p["moe"], h, cfg.moe, cfg.gated_mlp)
        else:
            y = L.mlp_apply(p["mlp"], h, cfg.gated_mlp)
    return x + y, new_cache, aux


# the products without batch dims, whose outputs ``remat="dots"`` keeps
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_dots(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the activation checkpointing ``remat`` names
    (``Flags``): as it is for "none" or where autograd records nothing
    (grad mode off, or no tensor of ``args`` requires grad), else through
    ``torch.utils.checkpoint`` (non-reentrant), with the "dots" policy
    selecting what the forward keeps. The layers draw no random numbers,
    so no generator's state is stashed for the recomputation (the card's
    would be, the ``meta`` device's not: the dry-run's counts would
    differ)."""
    if remat == "none" or not L.records(args):
        return fn(*args)
    from torch.utils import checkpoint as C
    if remat == "full":
        return C.checkpoint(fn, *args, use_reentrant=False,
                            preserve_rng_state=False)
    if remat == "dots":
        return C.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False,
            context_fn=lambda: C.create_selective_checkpoint_contexts(
                _keep_dots))
    raise ValueError(f"remat {remat!r}: none, full or dots")


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                     *, dtype, device, lead: Tuple[int, ...] = ()
                     ) -> Dict[str, torch.Tensor]:
    if kind == SSD:
        return S.init_ssd_cache(batch, cfg.d_model, cfg.ssm, dtype=dtype,
                                device=device, lead=lead)
    if kind == RGLRU:
        return R.init_rglru_cache(batch, cfg.d_model, cfg.rglru, dtype=dtype,
                                  device=device, lead=lead)
    if kind == LOCAL_ATTN:
        cache_len = min(cfg.window, cache_len)
    return A.init_attn_cache(batch, cache_len, cfg.n_kv_heads,
                             cfg.resolved_head_dim, dtype=dtype,
                             device=device, lead=lead)


# ---------------------------------------------------------------------------
# Layout of the stack in the parameter and cache trees
# ---------------------------------------------------------------------------

Path = Tuple[str, ...]


def _period_layout(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    period = len(cfg.layer_pattern)
    n_periods = cfg.n_layers // period
    remainder = tuple(cfg.layer_pattern[:cfg.n_layers % period])
    return n_periods, remainder


def block_paths(period: int, n_rem: int) -> List[Tuple[Path, Path]]:
    """(parameter path, cache path) of the blocks at each of the
    ``period`` positions of the stacked periods (0 where there are none),
    then of each of the ``n_rem`` remainder layers. A one-layer period
    without remainder keeps its stack at ``layers`` and its cache at the
    root; otherwise the JAX package's ``periods`` (keyed "0", "1", ...)
    and ``rem_{i}``."""
    if period == 1 and n_rem == 0:
        return [(("layers",), ())]
    return ([(("periods", str(j)),) * 2 for j in range(period)]
            + [((f"rem_{i}",),) * 2 for i in range(n_rem)])


def _stacks(cfg: ModelConfig) -> List[Tuple[Path, Path, str, Optional[int]]]:
    """Each stack of blocks: (its path in the parameters, in the cache, its
    kind, its depth or None for a remainder layer's single block)."""
    n_periods, remainder = _period_layout(cfg)
    stacked = cfg.layer_pattern if n_periods else ()
    kinds = [(k, n_periods) for k in stacked] + [(k, None) for k in remainder]
    return [(pp, cp, kind, depth) for (pp, cp), (kind, depth) in
            zip(block_paths(len(stacked), len(remainder)), kinds,
                strict=True)]


def _layers(cfg: ModelConfig):
    """(parameter path, cache path, kind, index in its stack or None) of
    every layer, in the order the stack runs them."""
    stacks = _stacks(cfg)
    stacked = [st for st in stacks if st[3] is not None]
    n_periods = stacked[0][3] if stacked else 0
    for i in range(n_periods):
        for ppath, cpath, kind, _ in stacked:
            yield ppath, cpath, kind, i
    for ppath, cpath, kind, depth in stacks:
        if depth is None:
            yield ppath, cpath, kind, None


def _get(tree: Dict[str, Any], path: Path) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def put_path(tree: Dict[str, Any], path: Path,
             value: Dict[str, Any]) -> None:
    """Merge ``value`` into ``tree`` at ``path`` (the root where empty)."""
    for key in path:
        tree = tree.setdefault(key, {})
    tree.update(value)


# ---------------------------------------------------------------------------
# Whole-model init / apply
# ---------------------------------------------------------------------------

def lm_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of ``lm_init``'s tree, leaf for leaf: the JAX
    package's (``unbox(model.init(key))[1]``) in the port's layout, the
    stacked blocks' leading ``layers``."""
    _check_supported(cfg)
    axes: Dict[str, Any] = {"embed": L.EMBED_AXES,
                            "final_norm": L.SCALE_AXES}
    if not cfg.tie_embeddings:
        axes["unembed"] = ("embed", "vocab")
    for ppath, _, kind, depth in _stacks(cfg):
        put_path(axes, ppath, block_axes(
            cfg, kind, () if depth is None else ("layers",)))
    return axes


def lm_init(gen: torch.Generator, cfg: ModelConfig,
            flags: Flags = DEFAULT_FLAGS, device="cuda") -> ParamTree:
    """``lm_params`` held in a ``ParamTree``."""
    return ParamTree(lm_params(gen, cfg, flags, device))


def lm_params(gen: torch.Generator, cfg: ModelConfig,
              flags: Flags = DEFAULT_FLAGS, device="cuda") -> Dict[str, Any]:
    """Random weights from ``gen`` (a generator on ``device``):
    ``embed`` [V, D], ``final_norm`` [D], ``unembed`` [D, V] (absent when
    tied) and the blocks (module docstring), each stacked leaf with a
    leading axis: ``norm1``, ``attn.{wq,wk,wv,wo[,q_norm,k_norm]}`` (the
    norms where the config has QK-norm), ``norm2``,
    ``mlp.{wi,wo[,wg]}`` (an MoE layer: ``moe.{router,wi,wo[,wg]
    [,shared.{wi,wo[,wg]}]}``) for attention, the same with ``rglru.{in_x,
    in_gate,conv_w,conv_b,w_r,b_r,w_i,b_i,lam,out}`` in place of ``attn``
    for RG-LRU, ``norm1``, ``ssd.{in_proj,conv_w,conv_b,A_log,D,dt_bias,
    norm,out_proj}`` for SSD."""
    _check_supported(cfg)
    dtype = flags.param_dtype
    params: Dict[str, Any] = {
        "embed": L.embed_init(gen, cfg.vocab, cfg.d_model, dtype=dtype,
                              device=device),
        "final_norm": L.scale_init(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, cfg.d_model, cfg.vocab,
                                         dtype=dtype, device=device)
    for ppath, _, kind, depth in _stacks(cfg):
        put_path(params, ppath, block_init(
            gen, cfg, kind, dtype=dtype, device=device,
            lead=() if depth is None else (depth,)))
    return params


def _leaf_paths(tree: Dict[str, Any], prefix: Path = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def init_placed(init, axes: Dict[str, Any], gen: torch.Generator, mesh,
                device) -> Dict[str, Any]:
    """The weights ``init(gen, device)`` (a nested dict) draws, drawn
    straight onto ``mesh`` by ``launch.mesh.param_specs`` of ``axes``: a
    nested dict of ``spmd.Sharded``. The generator (on ``device``) draws
    the same values in the same order as without a mesh, each
    ``layers.normal`` leaf a leading slice at a time, and each slice goes
    to the shards that hold it; no device holds more of a leaf than its
    blocks and one float32 slice. The few leaves ``normal`` does not draw
    (norm scales, constants) are made whole on ``device`` and placed."""
    from repro_torch.launch.mesh import param_specs
    drawn: List[torch.Tensor] = []

    def record(gen_, shape, scale, dtype, device_):
        drawn.append(torch.empty(shape, dtype=dtype, device="meta"))
        return drawn[-1]

    with L.drawing_into(record):
        abstract = init(None, "meta")
    specs = param_specs(abstract, axes, mesh)
    ids = {id(t): i for i, t in enumerate(drawn)}
    order: List[Optional[Path]] = [None] * len(drawn)
    for path, leaf in _leaf_paths(abstract):
        i = ids.get(id(leaf))
        if i is not None:
            order[i] = path
    if None in order:
        raise RuntimeError("init_placed: a drawn leaf is not in the tree")
    placed: Dict[Path, spmd.Sharded] = {}

    def draw(gen_, shape, scale, dtype, device_):
        path = order[len(placed)]
        sh = _get(specs, path)
        out = spmd.zeros(shape, dtype, sh)
        regions = [spmd._blocks(mesh, sh.spec, i, shape)
                   + tuple(slice(0, n) for n in shape[len(sh.spec):])
                   for i in range(mesh.size)]
        for i, v in L.normal_slices(gen_, shape, scale, device_):
            v = v.to(dtype)
            for t, reg in zip(out.shards, regions):
                if i is None:
                    t.copy_(v[reg])
                elif reg[0].start <= i < reg[0].stop:
                    t[i - reg[0].start].copy_(v[reg[1:]])
            del v
        placed[path] = out
        return torch.empty(shape, dtype=dtype, device="meta")

    with L.drawing_into(draw):
        rest = init(gen, device)
    out: Dict[str, Any] = {}
    for path, leaf in _leaf_paths(rest):
        val = placed.get(path)
        if val is None:
            val = spmd.place({"x": leaf},
                             {"x": _get(specs, path)})["x"]
        put_path(out, path[:-1], {path[-1]: val})
    return out


def lm_init_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  flags: Flags = DEFAULT_FLAGS, device="cuda"
                  ) -> Dict[str, Any]:
    """Zeroed cache (module docstring for the tree): a KV cache at capacity
    ``cache_len`` for a global layer, ``min(window, cache_len)`` slots for
    a local one, or the SSD or RG-LRU cache (float32 state), whose size
    does not depend on ``cache_len``."""
    _check_supported(cfg)
    cache: Dict[str, Any] = {}
    for _, cpath, kind, depth in _stacks(cfg):
        put_path(cache, cpath, init_block_cache(
            cfg, kind, batch, cache_len, dtype=flags.param_dtype,
            device=device, lead=() if depth is None else (depth,)))
    return cache


def _embed_inputs(p: Dict[str, Any], cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings [B,S,D]; for the vision frontend, the batch's
    precomputed ``vision_embeds`` [B, n_tok, D] (cast to the weight dtype)
    over the first n_tok positions. Decode batches carry none. Where the
    body splits the sequence, the shard's slice of them: the embeddings
    of the positions it holds."""
    x = L.embed_lookup(p["embed"], batch["tokens"])
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        ve = batch["vision_embeds"]
        s0 = seq_start(x.shape[1])
        n = min(ve.shape[1] - s0, x.shape[1])
        if n > 0:
            x[:, :n] = ve[:, s0:s0 + n].to(x.dtype)
    return constrain(x, "act_batch", "act_seq", "act_embed")


@spans.spanned("model.forward")
def lm_apply(params, batch: Dict[str, torch.Tensor], *,
             cfg: ModelConfig, mode: str, flags: Flags = DEFAULT_FLAGS,
             cache: Optional[Dict[str, Any]] = None):
    """Returns (final hidden [B,S,D], cache) in prefill and decode, and
    (final hidden, None, aux_loss) in train, as the JAX function returns
    in every mode: aux is the sum of the MoE layers' load-balance losses
    (a float32 zero without MoE). The unembedding is applied by the
    caller. A prefill or decode with ``cache`` writes the new entries
    into it in place (KV slots, or each layer's conv and state) and returns
    it; a prefill without one returns a new cache (KV of length S, a local
    layer's last window). ``batch`` holds ``tokens`` [B,S], ``lengths`` [B]
    in decode, and may hold ``vision_embeds`` (``_embed_inputs``). In
    train mode each layer runs under ``flags.remat`` (``remat_call``).
    ``params`` is a ``ParamTree`` or a nested dict of tensors. Where a
    ``shard_map`` body splits the sequence, the final hidden is the
    shard's slice of it (``Model.loss`` gathers it; the serving steps take
    its last position by ``sharding.seq_last``)."""
    p = _tree(params)
    lengths = batch.get("lengths")
    x = _embed_inputs(p, cfg, batch)
    train = mode == "train"
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_layers: Dict[Path, List[Dict[str, torch.Tensor]]] = {}
    for ppath, cpath, kind, i in _layers(cfg):
        bp = _get(p, ppath)
        bp = bp if i is None else _at(bp, i)
        if train:
            x, _, a = remat_call(
                flags.remat, lambda bp_, x_, kind_=kind: block_apply(
                    bp_, x_, cfg=cfg, kind=kind_, mode=mode, flags=flags),
                bp, x)
            aux = aux + a
            continue
        c_in = None
        if cache is not None:
            c_in = _get(cache, cpath)
            if i is not None:
                c_in = {k: v[i] for k, v in c_in.items()}
        x, c_out, _ = block_apply(bp, x, cfg=cfg, kind=kind, mode=mode,
                                  flags=flags, cache=c_in, lengths=lengths)
        if cache is None:
            new_layers.setdefault(cpath, []).append(c_out)
        else:
            for k, v in c_out.items():
                # a layer that wrote its cache view in place returns it
                if v is not c_in[k]:
                    c_in[k].copy_(v)
    with spans.span("model.norm"):
        x = L.rms_norm(x, p["final_norm"], cfg.norm_eps)
    if train:
        return x, None, aux
    if cache is None:
        cache = {}
        for _, cpath, _, depth in _stacks(cfg):
            outs = new_layers[cpath]
            put_path(cache, cpath, outs[0] if depth is None else
                 {k: torch.stack([c[k] for c in outs]) for k in outs[0]})
    return x, cache


@spans.spanned("model.unembed")
def unembed(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits for a (small) x. [B,S,D] -> [B,S,V]; inside a ``shard_map``
    body, the shard's slice of the vocabulary [B,S,V/tp] where the
    embedding is split. ``x`` holds the positions wanted, whole: where the
    body splits the sequence the caller gathers them first
    (``sharding.seq_gather`` or ``seq_last``)."""
    p = _tree(params)
    if cfg.tie_embeddings:
        logits = x @ p["embed"].T
    else:
        logits = x @ p["unembed"]
    return constrain(logits, "act_batch", None, "act_vocab")


def chunked_ce_loss(params, x: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig, flags: Flags) -> torch.Tensor:
    """Mean token cross-entropy of the hidden states x [B,S,D] against
    ``labels`` [B,S] without materialising [B,S,V]: a loop over
    ``flags.loss_chunk`` positions, each chunk's logits [B,chunk,V] in
    float32 (the product in the weights' dtype, then cast), ``logsumexp``
    minus the label's logit, summed. Under ``flags.remat`` other than
    "none" each chunk runs under ``torch.utils.checkpoint``, so the
    backward too holds one chunk's logits at a time. Where the body splits
    the sequence, ``x`` is the shard's slice: the whole sequence is
    gathered first, and the loss is the whole batch's on every shard."""
    p = _tree(params)
    x = seq_gather(x)
    b, s, _ = x.shape
    chunk = min(flags.loss_chunk, s)
    if s % chunk:
        raise ValueError(f"chunked_ce_loss: S={s} is not a multiple of "
                         f"loss_chunk {chunk}")
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    remat = "none" if flags.remat == "none" else "full"
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        total = total + remat_call(remat, _ce_sum, x[:, c0:c0 + chunk], w,
                                   labels[:, c0:c0 + chunk])
    return total / (b * s)


def _ce_sum(x: torch.Tensor, w: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk: x [B,T,D], w [D,V], labels
    [B,T]."""
    return L.softmax_cross_entropy(x @ w, labels) * labels.numel()
