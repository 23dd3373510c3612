"""Serving steps: batched prefill and single-token greedy decode
(``repro/serve/serve_step.py`` at the same path).

Both steps run without autograd (``torch.no_grad``), whatever the
weights' ``requires_grad``. Under an active mesh
(``models.sharding.use_sharding``; ``serving_mesh``) each call is one
``spmd.shard_map`` over the weights placed by ``launch.mesh.param_specs``
and the cache by ``cache_specs`` (``place_params``, ``init_mesh_cache``):
every layer runs on its shard's blocks and reduces explicitly (the JAX
package's GSPMD layout written out), and the greedy token comes from the
vocab-sharded logits. Under ``Flags.seq_shard_kv`` the cache's slots
split over that axis (``cache_specs(..., seq_axis=)``), and each
attention layer writes and reads its shard's slots, combining the
decode's partials over the axis (``models.attention``). Under the rule
``"act_seq": "model"`` a prefill's activations split along the sequence
over the model axis (``sharding.sequence_axis``), and the last position's
hidden comes from the shard holding it; a decode step (S = 1) never
splits. ``tasked_decode_loop`` drives the same decode step through the port's
task runtime: every step is one hetero task over the model state
(weights read, cache, tokens and lengths read and written), followed by
``Runtime.step_boundary()``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core import spans
from repro_torch.distributed import spmd
from repro_torch.models.layers import TP_AXIS
from repro_torch.models.model_zoo import Model
from repro_torch.models.sharding import (active_mesh, is_split, seq_last,
                                         sequence_axis, split_axes,
                                         split_cache, split_sequence,
                                         split_weights)
from repro_torch.models.transformer import ParamTree

_NOT_PORTED = "not ported (see ROADMAP.md)"


def serving_mesh(model: Model, mesh: Optional[spmd.Mesh] = None
                 ) -> Optional[spmd.Mesh]:
    """The mesh a step of ``model`` runs over: ``mesh``, else the active
    one; None without either."""
    return mesh or active_mesh()


def place_params(model: Model, params, mesh: spmd.Mesh):
    """``params`` (a ``ParamTree`` or nested dict) placed on ``mesh`` by
    ``launch.mesh.param_specs`` of ``model.axes()``; placed leaves stay."""
    from repro_torch.launch.mesh import param_specs
    tree = params.tree() if isinstance(params, ParamTree) else params
    return spmd.place(tree, param_specs(tree, model.axes(), mesh))


def init_mesh_cache(model: Model, batch: int, cache_len: int,
                    mesh: spmd.Mesh) -> Dict[str, Any]:
    """``model.init_cache`` laid out on ``mesh`` by ``launch.mesh.
    cache_specs`` (the slots split over ``Flags.seq_shard_kv``'s axis
    where it names one): zero blocks, each shard's its own."""
    from repro_torch.launch.mesh import cache_specs
    abstract = model.init_cache(batch, cache_len, "meta")
    specs = cache_specs(abstract, mesh, model.cfg,
                        seq_axis=model.flags.seq_shard_kv)

    def zeros(a, sh):
        if isinstance(a, dict):
            return {k: zeros(v, sh[k]) for k, v in a.items()}
        return spmd.zeros(a.shape, a.dtype, sh)
    return zeros(abstract, specs)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the vocabulary [B,S] int32 of ``logits`` [B,S,V],
    or inside a ``shard_map`` body whose weights split ``vocab`` of a
    shard's slice of it: each shard's best and its index are gathered
    over the model axis and the best of the bests taken, ties to the lower
    index as ``argmax``'s."""
    if not is_split("vocab"):
        return logits.argmax(dim=-1).to(torch.int32)
    v_loc = logits.shape[-1]
    best, idx = logits.max(dim=-1)                  # the first best
    idx = idx + spmd.axis_index(TP_AXIS) * v_loc
    both = spmd.all_gather(torch.stack([best.float(), idx.float()]),
                           TP_AXIS)                  # [tp, 2, B, S]
    win = both[:, 0].argmax(dim=0)                  # the lowest shard
    return both[:, 1].gather(0, win[None])[0].to(torch.int32)


def _mesh_step(model: Model, mesh: spmd.Mesh, mode: str, params, batch,
               cache, logits: bool):
    """One prefill or decode step as one ``shard_map``: (next token [B,1]
    as a ``Sharded``, the cache tree of ``Sharded`` written in place[, the
    last position's logits as a ``Sharded``, vocab-split])."""
    from repro_torch.launch.mesh import batch_specs
    params = place_params(model, params, mesh)
    p_named = flatten(params)
    c_named = flatten(cache)
    if not all(isinstance(t, spmd.Sharded) for _, t in c_named):
        raise TypeError("a step on a mesh takes the cache "
                        "init_mesh_cache makes")
    b_names = sorted(batch)
    n_p, n_c = len(p_named), len(c_named)
    bspec = batch_specs(mode, mesh, batch["tokens"].shape[0])["batch"]
    split = split_axes(model.axes(), params)
    seq = sequence_axis(mesh, *batch["tokens"].shape)
    bax = bspec[0] if len(bspec) else None
    logits_spec = spmd.P(bax, None, TP_AXIS) if "vocab" in split \
        else spmd.P(bax)

    slot_axes = [_slot_axis(name, t) for name, t in c_named]

    @torch.no_grad()        # grad mode is per thread: the shards' own
    def body(*leaves):
        p = _unflatten([n for n, _ in p_named], leaves[:n_p])
        c = _unflatten([n for n, _ in c_named], leaves[n_p:n_p + n_c])
        b = dict(zip(b_names, leaves[n_p + n_c:]))
        split_slots: Dict[str, list] = {}
        for ax, t in zip(slot_axes, leaves[n_p:n_p + n_c]):
            if ax is not None:
                split_slots.setdefault(ax, []).append(t)
        with split_weights(split), split_cache(split_slots), \
                split_sequence(seq):
            x, c_out = model.apply(p, b, mode=mode, cache=c)
            last = model.unembed(p, seq_last(x))
            out = (_greedy(last), *(t for _, t in flatten(c_out)))
        return out + (last,) if logits else out

    in_specs = tuple(t.spec for _, t in p_named + c_named) + \
        (bspec,) * len(b_names)
    out_specs = (bspec, *(t.spec for _, t in c_named)) + \
        ((logits_spec,) if logits else ())
    res = spmd.shard_map(body, mesh, in_specs, out_specs)(
        *(t for _, t in p_named + c_named), *(batch[k] for k in b_names))
    new_cache = _unflatten([n for n, _ in c_named], res[1:1 + n_c])
    return (res[0], new_cache) + ((res[-1],) if logits else ())


def _slot_axis(name: str, leaf: spmd.Sharded) -> Optional[str]:
    """The mesh axis splitting a KV cache leaf's slots ([..., B, T, K, D],
    ``cache_specs(..., seq_axis=)``) over more than one shard, else
    None."""
    if name.rsplit(".", 1)[-1] not in ("k", "v"):
        return None
    t_dim = len(leaf.shape) - 3
    part = leaf.spec[t_dim] if t_dim < len(leaf.spec) else None
    axes = spmd._axes(part)
    if not axes or math.prod(leaf.mesh.shape[a] for a in axes) == 1:
        return None
    if len(axes) > 1:
        raise NotImplementedError("a cache whose slots split over two mesh "
                                  "axes is not ported (see ROADMAP.md)")
    return axes[0]


def make_prefill_step(model: Model, mesh: Optional[spmd.Mesh] = None,
                      logits: bool = False):
    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor], cache):
        """``batch``: ``tokens`` [B,S] and the model's other prefill
        inputs (``vision_embeds``, an encoder-decoder's ``frames``; on a
        mesh each split along its batch dim as the tokens are).
        Returns (next_token [B,1] int32, cache after prefill), with
        ``logits`` the last position's logits [B,1,V] too. On a mesh
        (``serving_mesh``) they are ``Sharded``, the cache's leaves too."""
        m = serving_mesh(model, mesh)
        if m is not None:
            return _mesh_step(model, m, "prefill", params, batch, cache,
                              logits)
        x, new_cache = model.apply(params, batch, mode="prefill",
                                   cache=cache)
        last = model.unembed(params, x[:, -1:])
        out = (last.argmax(dim=-1).to(torch.int32), new_cache)
        return out + (last,) if logits else out
    return prefill_step


def make_decode_step(model: Model, mesh: Optional[spmd.Mesh] = None):
    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor,
                    lengths: torch.Tensor):
        """tokens: [B,1] current token; lengths: [B] tokens so far.
        Returns (next_token [B,1] int32, cache), the cache written in
        place (a KV cache at slot ``lengths[b]``, a local layer's ring at
        ``lengths[b] % window``). On a mesh (``serving_mesh``) the token
        is ``Sharded``, and ``tokens`` may be the last step's."""
        batch = {"tokens": tokens, "lengths": lengths}
        m = serving_mesh(model, mesh)
        if m is not None:
            return _mesh_step(model, m, "decode", params, batch, cache,
                              False)
        x, new_cache = model.apply(params, batch, mode="decode", cache=cache)
        logits = model.unembed(params, x)
        return logits.argmax(dim=-1).to(torch.int32), new_cache
    return decode_step


def flatten(tree: Dict[str, Any], prefix: str = ""
            ) -> List[Tuple[str, torch.Tensor]]:
    """The leaves of a nested dict, named by their dotted paths."""
    out = []
    for key, val in tree.items():
        if isinstance(val, dict):
            out += flatten(val, f"{prefix}{key}.")
        else:
            out.append((f"{prefix}{key}", val))
    return out


def _unflatten(names: List[str], leaves) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, leaf in zip(names, leaves, strict=True):
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _device_id(runtime, device: torch.device) -> int:
    for d in runtime.devices:
        if d.torch_device == device:
            return d.info.device_id
    raise ValueError(f"no runtime device holds {device}")


def tasked_decode_loop(runtime, model: Model, params, cache, tokens,
                       lengths, n_steps: int,
                       device_type: Optional[str] = None,
                       timeout: float = 120.0):
    """Run ``n_steps`` of greedy single-token decode as hetero tasks.

    The weights, the cache (a tree: ``{"k", "v"}``, ``{"conv", "state"}``,
    per stack of a longer layer pattern, or an encoder-decoder's
    ``{"decoder": {"self", "cross"}}``, whose cross leaves decode only
    reads), ``tokens`` [B,1] and
    ``lengths`` [B] (int32) are tensors on one device; each is adopted in
    place as a hetero object on the runtime device that holds it, so
    nothing round-trips through the host. Each step submits ONE task over
    them (weights read, the rest read-write: the cache is donated and
    written in place, not copied). Returns ``(tokens_obj, lengths_obj,
    cache_objs)`` after the loop's barrier; ``cache_objs`` maps each cache
    leaf's dotted path (``"k"``, ``"periods.5.v"``,
    ``"decoder.cross.k"``) to its object. The call is one request
    (``serve.generation``, ``core/spans.py``)."""
    if serving_mesh(model) is not None or any(
            isinstance(t, spmd.Sharded) for t in (tokens, lengths)):
        raise NotImplementedError(f"tasked_decode_loop on a mesh is "
                                  f"{_NOT_PORTED}")
    with spans.request("serve.generation", steps=n_steps):
        decode = make_decode_step(model)
        tree = params.tree() if isinstance(params, ParamTree) else params
        named = flatten(tree)
        names = [n for n, _ in named]
        n_p = len(named)
        c_named = flatten(cache)
        keys = [n for n, _ in c_named]
        dev = _device_id(runtime, tokens.device)
        with spans.span("serve.adopt"):
            p_objs = [runtime.adopt_device_array(t, dev, name=f"dec-p:{n}")
                      for n, t in named]
            c_objs = {key: runtime.adopt_device_array(t, dev,
                                                      name=f"dec-cache:{key}")
                      for key, t in c_named}
            tok_obj = runtime.adopt_device_array(tokens, dev, name="dec-tok")
            len_obj = runtime.adopt_device_array(lengths, dev, name="dec-len")

        # one kernel object for the whole loop: the device's launcher cache
        # hits every step
        def step_kernel(tok, lens, *leaves):
            params_ = _unflatten(names, leaves[:n_p])
            cache_ = _unflatten(keys, leaves[n_p:])
            new_tok, new_cache = decode(params_, cache_, tok, lens)
            new_c = dict(flatten(new_cache))
            # outputs bind to the write-args in arg order: tok, lens, cache
            return (new_tok, lens + 1, *(new_c[k] for k in keys))

        args = ([(tok_obj, "rw"), (len_obj, "rw")]
                + [(o, "r") for o in p_objs]
                + [(c_objs[k], "rw") for k in keys])
        for _ in range(n_steps):
            runtime.run(step_kernel, args, device_type=device_type,
                        name="decode_step")
            runtime.step_boundary()
        runtime.barrier(timeout=timeout)
        return tok_obj, len_obj, c_objs


def abstract_params(model: Model) -> Dict[str, Any]:
    """The weights of ``model`` as a nested dict of meta tensors."""
    return model.init_abstract().tree()


def abstract_cache(model: Model, batch: int, cache_len: int
                   ) -> Dict[str, Any]:
    """``model.init_cache(batch, cache_len)`` on the meta device."""
    return model.init_cache(batch, cache_len, "meta")
