"""Train-step factory with over-decomposition (microbatch) support
(``repro/train/train_step.py`` at the same path).

The paper's over-decomposition insight — split the domain into more chunks
than processing elements so transfers pipeline behind compute — maps to
microbatched gradient accumulation: the batch is split into
``over_decompose`` microbatches whose gradients accumulate in float32, and
activation memory drops by that factor. ``over_decompose=1`` is the
paper-faithful "no over-decomposition" baseline (one monolithic batch).

A state placed on a mesh (``init_train_state(..., mesh=)`` or
``launch.mesh.place_train_state``: every leaf an ``spmd.Sharded`` by its
parameter's spec) trains tensor-parallel, the explicit form of what GSPMD
makes of the JAX step under ``use_sharding``: each step is one
``spmd.shard_map`` whose body, on each shard, runs the forward and the
backward on its blocks (the layers split as ``sharding.split_weights``
says, the loss vocab-parallel), reduces the gradients, takes the norm of
the whole gradient and updates its blocks in place. The collectives'
backwards are their exact adjoints (``distributed.spmd``), so each shard
seeds its backward with 1 / (the shards the loss is replicated over,
the non-data axes): the gradient of a split leaf's block is then exact
as it stands, a replicated leaf's is the ``psum`` of the shards' parts,
and the data axes' shards average theirs (``pmean``). Where the moments
and master lie split over ``data`` as well (ZeRO-1, ``init_train_state(...,
zero=True)``), each shard updates its slice of them from its slice of the
averaged gradient and the new parameter block is all-gathered over
``data`` from the slices: AdamW is elementwise, so the result is the
unsplit step's, bit for bit. With ``compress_pod_grads`` on a mesh with a
``pod`` axis the gradients are averaged inside each pod (over ``model``
and ``data``) and then over ``pod`` by the int8 error-feedback reduction
of ``train.compression``, each shard with its pod's residual of its
block, the quantization blocks the whole leaf's. Under the rule
``"act_seq": "model"`` (``use_sharding``'s rules where the step is
called) the body splits the activations along the sequence over the model
axis where it divides (``sharding.sequence_axis``): the loss is still the
whole batch's on every shard, and a replicated leaf's gradient (a norm's)
is then the sum of its slices' parts, which the same ``psum`` takes.

Under an active mesh (``models.sharding.use_sharding``) whose data axes
(``pod``, ``data``) span more than one shard, a state that is not placed
is trained data-parallel: each shard takes its slice of the batch inside
``spmd.shard_map`` with the whole parameters and the gradients and
metrics are averaged with ``spmd.pmean``. ``compress_pod_grads``
replaces the reduction over ``pod`` with the int8 error-feedback one of
``train.compression`` on this path too. As in the JAX step, compression
applies to a step of one microbatch (``over_decompose`` 1).

Gradients come from ``torch.autograd.grad`` on detached copies of the
parameter leaves that require grad, so the state's tensors never carry
autograd history, and the optimizer (``train.optimizer.adamw_update``)
updates them in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import to_numpy, to_torch
from repro_torch.distributed import spmd
from repro_torch.models.model_zoo import Model
from repro_torch.models.sharding import (active_mesh, sequence_axis,
                                         split_axes, split_sequence,
                                         split_weights)
from repro_torch.train.optimizer import (AdamWConfig, AdamWState, TrainState,
                                         adamw_apply, adamw_update,
                                         init_opt_state, tree_flatten,
                                         tree_leaves, tree_map,
                                         tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    over_decompose: int = 1      # microbatches per step (paper: OD level)
    z_loss: float = 0.0
    # int8 + error-feedback compression of the cross-pod gradient reduction
    # (meshes with a pod axis only; see train/compression.py)
    compress_pod_grads: bool = False


def make_loss_fn(model: Model):
    """``loss_fn(params, batch) -> (ce + aux, {"ce", "aux"})`` from a
    train-mode forward and ``Model.loss``."""
    def loss_fn(params, batch):
        x, _, aux = model.apply(params, batch, mode="train")
        ce = model.loss(params, x, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_grad_fn(model: Model):
    """``grad_fn(params, batch) -> (grads, {"ce", "aux"})``: the gradient
    of ``make_loss_fn``'s loss with respect to every parameter leaf, each
    in its parameter's dtype (zeros for a leaf the loss does not reach)."""
    loss_fn = make_loss_fn(model)

    def grad_fn(params, batch):
        flat = tree_flatten(params)
        live = [leaf.detach().requires_grad_() for _, leaf in flat]
        loss, metrics = loss_fn(tree_unflatten([p for p, _ in flat], live),
                                batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(live, grads)]
        return (tree_unflatten([p for p, _ in flat], grads),
                {k: v.detach() for k, v in metrics.items()})
    return grad_fn


_DATA_AXES = ("pod", "data")


def _batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data axes that span more than one shard."""
    return tuple(a for a in _DATA_AXES
                 if a in mesh.shape and mesh.shape[a] > 1)


def _over_mesh(body, mesh, params, batch, batch_spec, extra=(),
               extra_spec=None, n_out_sharded: int = 0):
    """``body(params, batch, *extra)`` once per shard of ``mesh``: the
    parameters replicated, each batch leaf split along its first dim by
    ``batch_spec``, each ``extra`` leaf by ``extra_spec``. ``body``
    returns (grads tree, metrics dict, sharded leaves); the first two
    are replicated. Returns them on the parameters' device, the sharded
    leaves joined."""
    pflat, bflat = tree_flatten(params), tree_flatten(batch)
    npar, nbat = len(pflat), len(bflat)
    device = pflat[0][1].device
    shapes = {}

    def run(*args):
        p = tree_unflatten([k for k, _ in pflat], args[:npar])
        b = tree_unflatten([k for k, _ in bflat], args[npar:npar + nbat])
        g, m, sharded = body(p, b, *args[npar + nbat:])
        gflat, mflat = tree_flatten(g), sorted(m.items())
        shapes["g"], shapes["m"] = [k for k, _ in gflat], [k for k, _ in mflat]
        return (*[v for _, v in gflat], *[v for _, v in mflat], *sharded)

    out = spmd.shard_map(
        run, mesh,
        in_specs=(spmd.P(),) * npar + (batch_spec,) * nbat
        + (extra_spec,) * len(extra),
        out_specs=(spmd.P(),) * (npar + 2) + (extra_spec,) * n_out_sharded,
    )(*[v for _, v in pflat], *[v for _, v in bflat], *extra)
    full = [o.full(device) for o in out]
    grads = tree_unflatten(shapes["g"], full[:npar])
    metrics = dict(zip(shapes["m"], full[npar:npar + 2]))
    return grads, metrics, full[npar + 2:]


# ---------------------------------------------------------------------------
# the tensor-parallel step over a placed state
# ---------------------------------------------------------------------------

def _is_placed(tree) -> bool:
    """Whether the leaves of ``tree`` lie on a mesh (``spmd.Sharded``)."""
    return any(isinstance(x, spmd.Sharded) for x in tree_leaves(tree))


def _named_axes(spec) -> Tuple[str, ...]:
    return tuple(a for entry in spec if entry is not None
                 for a in ((entry,) if isinstance(entry, str) else entry))


def _placed_norm(grads, specs, mesh: spmd.Mesh) -> torch.Tensor:
    """Inside a ``shard_map`` body: the L2 norm of the whole gradient, of
    which this shard holds ``grads`` (a list of blocks, laid out by
    ``specs``), summed in float32: each leaf's squared sum over its block,
    added over the shards along the axes that split it (``psum``), a
    leaf replicated along an axis counted once. Every shard gets the same
    bits."""
    groups: Dict[Tuple[str, ...], torch.Tensor] = {}
    for g, spec in zip(grads, specs, strict=True):
        axes = tuple(a for a in _named_axes(spec) if mesh.shape[a] > 1)
        sq = g.detach().float().square().sum()
        groups[axes] = sq if axes not in groups else groups[axes] + sq
    total = None
    for axes in sorted(groups):
        v = groups[axes]
        for a in axes:
            v = spmd.psum(v, a)
        total = v if total is None else total + v
    return torch.sqrt(total)


def _shard_grads(loss_fn, leaves, paths, batch, od: int, seed: float):
    """Inside a body: the gradients of this shard's loss (seeded with
    ``seed``) with respect to its blocks ``leaves``, over ``od``
    microbatches of its batch accumulated in float32 and divided by their
    count, as the one-device step does; and the metrics' mean."""
    n = next(iter(batch.values())).shape[0]
    if n % od:
        raise ValueError(f"a shard's batch of {n} does not split into "
                         f"{od} microbatches")
    acc, metrics = None, None
    for i in range(od):
        mb = batch if od == 1 else \
            {k: v[i * (n // od):(i + 1) * (n // od)] for k, v in batch.items()}
        live = [x.detach().requires_grad_() for x in leaves]
        with torch.enable_grad():
            loss, m = loss_fn(tree_unflatten(paths, live), mb)
            gs = torch.autograd.grad(loss, live, torch.full_like(loss, seed),
                                     allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g
              for x, g in zip(live, gs)]
        del live, loss
        m = {k: v.detach() for k, v in m.items()}
        if od == 1:
            acc, metrics = gs, m
        elif acc is None:
            acc, metrics = [g.float() for g in gs], m
        else:
            for a, g in zip(acc, gs):
                a.add_(g)
            metrics = {k: metrics[k] + m[k] for k in metrics}
        del gs
    if od > 1:
        acc = [a.div_(od) for a in acc]
        metrics = {k: v / od for k, v in metrics.items()}
    return acc, metrics


def _last_split(spec, ndim: int) -> Tuple[str, ...]:
    """The mesh axes (major first) that split a leaf's last dim under
    ``spec``."""
    if ndim == 0 or len(spec) < ndim or spec[ndim - 1] is None:
        return ()
    entry = spec[ndim - 1]
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _zero_split(pspec, zspec, mesh: spmd.Mesh):
    """Where the optimizer state's spec ``zspec`` (``launch.mesh.
    zero_shard``) splits a dim its parameter's ``pspec`` leaves whole
    over mesh axes of more than one shard: (that dim, those axes, major
    first); None where the two lay out the same blocks."""
    n = max(len(pspec), len(zspec))
    pp = tuple(pspec) + (None,) * (n - len(pspec))
    zz = tuple(zspec) + (None,) * (n - len(zspec))
    for dim, (a, b) in enumerate(zip(pp, zz)):
        if a == b:
            continue
        if a is not None:
            raise ValueError(f"an optimizer spec {zspec} does not refine "
                             f"its parameter's {pspec}")
        axes = _named_axes((b,))
        if math.prod(mesh.shape[x] for x in axes) > 1:
            return dim, axes
    return None


def _zero_slice(g: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """Inside a body: this shard's ZeRO-1 slice of ``g`` along ``dim``."""
    index, parts = spmd.axes_index(axes)
    size = g.shape[dim] // parts
    return g.narrow(dim, index * size, size)


def _zero_gather(t: torch.Tensor, dim: int, axes) -> torch.Tensor:
    """Inside a body: the shards' ZeRO-1 slices ``t`` joined along
    ``dim`` (all-gathers over ``axes``, minor first)."""
    for a in reversed(axes):
        t = spmd.all_gather(t, a, tiled_dim=dim)
    return t


def _mesh_run(model: Model, state, batch: Dict[str, torch.Tensor], od: int,
              opt: Optional[AdamWConfig], compress: bool = False):
    """One ``shard_map`` over the mesh the placed ``state.params`` lie on
    (module docstring). With ``opt`` (a ``TrainState``) the body updates
    the state's blocks in place and returns (state, metrics); without
    (``state`` a tree of placed parameters) it returns (the gradients, a
    tree of ``spmd.Sharded`` laid out as the parameters, and ``{"ce",
    "aux", "grad_norm"}``). ``compress``: the gradients are averaged over
    ``pod`` by ``compression.compressed_pmean`` with the state's
    residuals, after the reduction inside each pod. The metrics are
    tensors on shard 0's device."""
    from repro_torch.launch.mesh import batch_specs
    from repro_torch.train.compression import compressed_pmean
    params = state.params if opt is not None else state
    pflat = tree_flatten(params)
    if not all(isinstance(x, spmd.Sharded) for _, x in pflat):
        raise TypeError("a step on a mesh takes a state whose every leaf "
                        "is placed (init_train_state(..., mesh=))")
    paths = [k for k, _ in pflat]
    mesh = pflat[0][1].mesh
    specs = [x.spec for _, x in pflat]
    placed = [x for _, x in pflat]
    npar = len(paths)
    zero = [None] * npar
    if opt is not None:
        o = state.opt
        ms = tree_leaves(o.m)
        for part in (o.v, o.master):
            if [x.spec for x in tree_leaves(part)] != [x.spec for x in ms]:
                raise ValueError("a placed state's moments and master lie "
                                 "by different specs")
        zero = [_zero_split(p, m.spec, mesh) for p, m in zip(specs, ms)]
        placed += ms + tree_leaves(o.v) + tree_leaves(o.master) + [o.step]
    if compress:
        if "pod" not in mesh.shape:
            raise ValueError("compress_pod_grads needs a mesh with a pod "
                             "axis (launch.mesh.make_production_mesh("
                             "multi_pod=True))")
        if state.ef is None:
            raise ValueError("compress_pod_grads needs EF residuals: "
                             "init_train_state(..., ef_pods=mesh.shape"
                             "['pod'])")
        ef = tree_leaves(state.ef)
        if [tuple(x.spec) for x in ef] != [("pod", *s) for s in specs]:
            raise ValueError("the residuals lie otherwise than "
                             "launch.mesh.ef_specs places them")
        placed += ef
    if opt is not None and any(spmd.shares(x) for x in placed):
        raise ValueError("a placed state whose shards share a tensor "
                         "would be updated once a shard: place it "
                         "with share=False (launch.mesh."
                         "place_train_state)")
    names = sorted(batch)
    bspec = batch_specs("train", mesh, batch["tokens"].shape[0])["batch"]
    split = split_axes(model.axes(), params)
    seq = sequence_axis(mesh, *batch["tokens"].shape)
    data_axes = _batch_axes(mesh)
    # compressed: the mean inside each pod, then the compressed one over
    # pod (JAX compresses each pod's reduced gradient)
    in_pod = tuple(a for a in data_axes if a != "pod") if compress \
        else data_axes
    # the loss is the same on the shards along every other axis
    seed = 1.0 / math.prod(n for a, n in mesh.shape.items()
                           if a not in _DATA_AXES)
    loss_fn = make_loss_fn(model)
    first_ef = 4 * npar + 1

    def body(*args):
        leaves = args[:npar]
        b = dict(zip(names, args[len(placed):]))
        with split_weights(split), split_sequence(seq):
            grads, m = _shard_grads(loss_fn, leaves, paths, b, od, seed)
            # each leaf's reduced gradient replaces its own, which is
            # dropped as soon as its float32 copy is made
            for i, spec in enumerate(specs):
                g, grads[i] = grads[i], None
                named = _named_axes(spec)
                for a, size in mesh.shape.items():
                    if size > 1 and a not in named and a not in _DATA_AXES:
                        g = spmd.psum(g.float(), a)
                if in_pod:
                    g = spmd.pmean(g.float(), in_pod)
                grads[i] = g
                del g
            if in_pod:
                m = {k: spmd.pmean(v, in_pod) for k, v in m.items()}
            if compress:
                res = args[first_ef:first_ef + npar]
                for i, (g, spec, r) in enumerate(zip(grads, specs, res)):
                    grads[i], new = compressed_pmean(
                        g, "pod", r[0], _last_split(spec, g.dim()))
                    r.copy_(new[None])
                m = {k: spmd.pmean(v, "pod") for k, v in m.items()}
            gnorm = _placed_norm(grads, specs, mesh)
        metrics = (m["ce"], m["aux"], gnorm)
        if opt is None:
            return (*metrics, *grads)
        mo, vo, wo = (args[npar * k:npar * (k + 1)] for k in (1, 2, 3))
        step = args[4 * npar]
        new_step = step + 1
        # ZeRO-1: each shard updates its slice; the parameter's block is
        # gathered back from the slices
        gs, ps = [], []
        for g, p, z in zip(grads, leaves, zero):
            if z is None:
                gs.append(g)
                ps.append(p)
            else:
                gs.append(_zero_slice(g, *z))
                ps.append(torch.empty(gs[-1].shape, dtype=p.dtype,
                                      device=p.device))
        lr = adamw_apply(opt, new_step, gnorm, gs, mo, vo, wo, ps)
        for p, t, z in zip(leaves, ps, zero):
            if z is not None:
                p.copy_(_zero_gather(t, *z))
        step.copy_(new_step)
        return (*metrics, lr)

    out_specs = (spmd.P(),) * 3 + ((spmd.P(),) if opt is not None
                                   else tuple(specs))
    res = spmd.shard_map(body, mesh,
                         tuple(x.spec for x in placed) + (bspec,) * len(names),
                         out_specs)(*placed, *(batch[k] for k in names))
    device = mesh.devices[0]
    metrics = {k: r.full(device) for k, r in
               zip(("ce", "aux", "grad_norm"), res[:3])}
    if opt is None:
        return tree_unflatten(paths, list(res[3:])), metrics
    # the state's blocks were written in the body: later readers
    # (``Sharded.full``, a checkpoint) wait for it
    for x in placed:
        x.events = list(res[0].events)
    metrics["lr"] = res[3].full(device)
    metrics["loss"] = metrics["ce"] + metrics["aux"]
    return state, metrics


def make_mesh_grad_fn(model: Model, over_decompose: int = 1):
    """``grad_fn(params, batch) -> (grads, {"ce", "aux", "grad_norm"})``
    for parameters placed on a mesh (a nested dict of ``spmd.Sharded``):
    the tensor-parallel step's gradients (``_mesh_run``) without the
    update, each leaf laid out as its parameter."""
    def grad_fn(params, batch):
        return _mesh_run(model, params, batch, over_decompose, None)
    return grad_fn


def make_train_step(model: Model, tcfg: TrainConfig
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, batch) -> (state, metrics)``: the gradients of
    the batch (``over_decompose`` microbatches accumulated in float32 and
    divided by their count; tensor-parallel for a placed state,
    data-parallel or compressed over an active mesh, module docstring),
    then the AdamW update, which consumes the state. ``metrics``: ce, aux,
    loss = ce + aux, grad_norm, lr. Runs where the state's tensors are;
    nothing moves to another device."""
    grad_fn = make_grad_fn(model)
    od = tcfg.over_decompose

    def grads_of(params, batch):
        """One batch's gradients, data-parallel over an active mesh."""
        mesh = active_mesh()
        axes = _batch_axes(mesh) if mesh is not None else ()
        if not axes:
            return grad_fn(params, batch)
        spec_axes = axes if len(axes) > 1 else axes[0]

        def body(p, b):
            g, m = grad_fn(p, b)
            g = tree_map(lambda x: spmd.pmean(x, spec_axes), g)
            return g, {k: spmd.pmean(v, spec_axes) for k, v in m.items()}, ()
        g, m, _ = _over_mesh(body, mesh, params, batch, spmd.P(spec_axes))
        return g, m

    def compressed_grads(state, batch):
        """Gradients with the cross-pod reduction compressed (int8 + EF):
        each pod's shards take the pod's slice of the batch, the gradients
        are averaged by ``compressed_pmean_tree`` over ``pod`` and the new
        error-feedback residuals returned per pod."""
        from repro_torch.train.compression import compressed_pmean_tree
        mesh = active_mesh()
        if mesh is None or "pod" not in mesh.shape:
            raise ValueError("compress_pod_grads needs an active mesh with "
                             "a pod axis (models.sharding.use_sharding)")
        if state.ef is None:
            raise ValueError("compress_pod_grads needs EF residuals: "
                             "init_train_state(..., ef_pods=mesh.shape"
                             "['pod'])")
        eflat = tree_flatten(state.ef)

        def body(p, b, *res):
            g, m = grad_fn(p, b)
            res_in = tree_unflatten([k for k, _ in eflat],
                                    [r[0] for r in res])
            g, new_res = compressed_pmean_tree(g, "pod", res_in)
            m = {k: spmd.pmean(v, "pod") for k, v in m.items()}
            return g, m, [r[None] for r in tree_leaves(new_res)]

        g, m, res = _over_mesh(body, mesh, state.params, batch,
                               spmd.P("pod"), [v for _, v in eflat],
                               spmd.P("pod"), len(eflat))
        return g, m, tree_unflatten([k for k, _ in eflat], res)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if _is_placed(state.params):
            # as in JAX, compression applies to a step of one microbatch
            return _mesh_run(model, state, batch, od, tcfg.opt,
                             compress=tcfg.compress_pod_grads and od == 1)
        mesh = active_mesh()
        if mesh is not None and \
                sequence_axis(mesh, *batch["tokens"].shape) is not None:
            raise NotImplementedError(
                "sequence parallelism on a state that is not placed: the "
                "step runs no tensor-parallel body; place it "
                "(init_train_state(..., mesh=)) (see ROADMAP.md)")
        new_ef = state.ef
        if tcfg.compress_pod_grads and od == 1:
            grads, metrics, new_ef = compressed_grads(state, batch)
        elif od == 1:
            grads, metrics = grads_of(state.params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % od:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{od} microbatches")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            metrics = None
            for i in range(od):
                mb = {k: v[i * (n // od):(i + 1) * (n // od)]
                      for k, v in batch.items()}
                g, m = grads_of(state.params, mb)
                tree_map(lambda a, b: a.add_(b), grads, g)
                del g
                metrics = m if metrics is None else \
                    {k: metrics[k] + m[k] for k in metrics}
            grads = tree_map(lambda g: g.div_(od), grads)
            metrics = {k: v / od for k, v in metrics.items()}
        state, opt_metrics = adamw_update(tcfg.opt, state, grads)
        del grads
        state.ef = new_ef
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = metrics["ce"] + metrics["aux"]
        return state, metrics

    return train_step


def runtime_allreduce(group, grad_trees, average: bool = True):
    """Gradient sync over the message-driven runtime (``CollectiveGroup``
    of ``distributed.collectives_rt``).

    ``grad_trees`` is one gradient tree per group member (identical
    structure and leaf shapes; numpy arrays or tensors, each member's
    local gradients). Leaves are flattened and concatenated into one
    vector per member so a single collective moves the whole gradient set
    — large trees take the pipelined chunked ring, small ones the eager
    binomial tree — then the summed (or averaged) vector is split back
    into the tree. Bit-deterministic: every member unflattens the *same*
    reduced vector, so replicas agree exactly.

    Returns one reduced tree per member, in group-member order: numpy
    leaves, or tensors on the device of the member's leaf where its leaf
    was a tensor."""
    if len(grad_trees) != len(group.members):
        raise ValueError(
            f"expected {len(group.members)} gradient trees, "
            f"got {len(grad_trees)}")
    flat0 = tree_flatten(grad_trees[0])
    paths = [p for p, _ in flat0]
    shapes = [tuple(leaf.shape) for _, leaf in flat0]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    packed = []
    for tree in grad_trees:
        leaves = tree_leaves(tree)
        if len(leaves) != len(paths):
            raise ValueError("gradient trees disagree on structure")
        packed.append(np.concatenate(
            [(to_numpy(leaf) if isinstance(leaf, torch.Tensor)
              else np.asarray(leaf)).reshape(-1) for leaf in leaves]))
    reduced = group.allreduce(packed, average=average)
    outs = []
    for tree, vec in zip(grad_trees, reduced):
        leaves, off = [], 0
        for like, shape, size in zip(tree_leaves(tree), shapes, sizes):
            arr = vec[off:off + size].reshape(shape)
            leaves.append(to_torch(arr, like.device)
                          if isinstance(like, torch.Tensor) else arr)
            off += size
        outs.append(tree_unflatten(paths, leaves))
    return outs


def init_train_state(model: Model, gen: Optional[torch.Generator],
                     device="cuda", ef_pods: int = 0,
                     mesh: Optional[spmd.Mesh] = None,
                     zero: bool = False) -> TrainState:
    """Parameters from ``model.init(gen, device)`` (plain tensors: the
    ``ParamTree``'s leaves detached), the AdamW state, and with
    ``ef_pods`` zero float32 error-feedback residuals [ef_pods, ...] per
    leaf. With ``mesh`` the parameters are drawn straight onto it
    (``Model.init(..., mesh=)``: the same values) and every leaf of the
    state is placed as ``launch.mesh.place_train_state(..., zero=zero)``
    places it: the moments and master by their parameters' specs, with
    ``zero`` split over ``data`` as well (ZeRO-1), the residuals by
    ``ef_specs``, the step replicated. Each shard makes only its own
    blocks (its slice of the master from its block of the parameter), so
    that no device ever holds more than them."""
    if mesh is not None:
        from repro_torch.launch.mesh import ef_specs, zero_shard
        # each shard updates its blocks in place: no two share a tensor
        params = tree_map(spmd.unshare, model.init(gen, device, mesh=mesh))

        def zspec(p):
            return spmd.P(*zero_shard(p.spec, p.shape, mesh)) if zero \
                else p.spec

        def zeros(p):
            return spmd.zeros(p.shape, torch.float32,
                              spmd.NamedSharding(mesh, zspec(p)))

        def master(p):
            return spmd.map_shards(lambda t: t.to(torch.float32, copy=True),
                                   spmd.reshard(p, zspec(p)))
        step = spmd.place({"s": torch.zeros((), dtype=torch.int32,
                                            device=device)},
                          {"s": spmd.NamedSharding(mesh, spmd.P())},
                          share=False)["s"]
        ef = None
        if ef_pods:
            abs_ef = tree_map(lambda p: torch.empty(
                (ef_pods,) + tuple(p.shape), device="meta"), params)
            ef = tree_map(lambda x, sh: spmd.zeros(x.shape, torch.float32,
                                                   sh),
                          abs_ef, ef_specs(abs_ef, model.axes(), mesh))
        return TrainState(params=params, opt=AdamWState(
            step=step, m=tree_map(zeros, params), v=tree_map(zeros, params),
            master=tree_map(master, params)), ef=ef)
    params = tree_map(lambda p: p.detach(), model.init(gen, device).tree())
    ef = None
    if ef_pods:
        ef = tree_map(lambda p: torch.zeros((ef_pods,) + tuple(p.shape),
                                            dtype=torch.float32,
                                            device=p.device), params)
    return TrainState(params=params, opt=init_opt_state(params), ef=ef)


def abstract_train_state(model: Model, ef_pods: int = 0) -> TrainState:
    """The ``TrainState`` of ``model`` on the ``meta`` device: every leaf's
    shape and dtype, no storage (with ``ef_pods``, the residuals too).
    ``Checkpointer.restore`` takes it as the structure and dtypes to
    restore into (with ``device=`` for where)."""
    return init_train_state(model, None, "meta", ef_pods=ef_pods)
