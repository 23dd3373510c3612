"""AdamW with mixed precision (``repro/train/optimizer.py`` at the same
path).

Parameters are stored in the compute dtype (bf16); the optimizer keeps
float32 master weights and moments, and each step casts the updated master
back into the parameters. Every leaf lives where its parameter does: on
one device, or on a mesh (``launch.mesh.place_train_state``) by its
parameter's spec, where ``train.train_step`` runs the update on each
shard's blocks (``adamw_apply``) with the norm of the whole gradient
(``train_step._placed_norm``); under ZeRO-1 (the moments and master
split over the data axis as well, ``launch.mesh.opt_specs(zero=True)``)
on each shard's slice of them.

Trees are nested dicts of tensors. The update runs under ``torch.no_grad``
and writes the state's tensors in place, as the JAX drivers donate the
state to the step (``donate_argnums=(0,)``): the returned ``TrainState``
holds the same tensors, and the state passed in is consumed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass
class AdamWState:
    step: torch.Tensor          # int32 scalar on the parameters' device
    m: Any
    v: Any
    master: Any


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: AdamWState
    # error-feedback residuals for compressed cross-pod gradient reduction
    # (None unless TrainConfig.compress_pod_grads; leading dim = pod)
    ef: Any = None

    @property
    def step(self):
        return self.opt.step


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


# ---------------------------------------------------------------------------
# trees of tensors (nested dicts)
# ---------------------------------------------------------------------------

Path = Tuple[str, ...]


def tree_flatten(tree: Any, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """``[(path, leaf)]`` of a nested dict, keys in sorted order (the order
    of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def tree_unflatten(paths: List[Path], leaves) -> Any:
    """The nested dict with ``leaves`` at ``paths`` (a lone leaf at the
    empty path)."""
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves, strict=True):
        if not path:
            return leaf
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak`` over ``warmup_steps``, then a cosine
    to 0 at ``total_steps``, in float32 on ``step``'s device."""
    step = step.to(torch.float32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr_peak * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params) -> AdamWState:
    """Zero moments and a float32 master copy (never aliasing the
    parameters) of every leaf; step 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                        params),
    )


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of all leaves together, summed in float32."""
    sq = sum(x.detach().float().square().sum() for x in tree_leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, state: TrainState, grads
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One AdamW step on ``grads`` (a tree like the parameters, any float
    dtype): the global-norm clip to ``grad_clip``, bias-corrected moments,
    the update with decoupled weight decay on the float32 master, and the
    parameters cast back from it. The state's tensors are written in place
    (module docstring). Returns (state, {"grad_norm", "lr"})."""
    opt = state.opt
    step = opt.step + 1
    gnorm = global_norm(grads)
    lr = adamw_apply(cfg, step, gnorm, tree_leaves(grads), tree_leaves(opt.m),
                     tree_leaves(opt.v), tree_leaves(opt.master),
                     tree_leaves(state.params))
    opt.step = step
    return state, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_apply(cfg: AdamWConfig, step: torch.Tensor, gnorm: torch.Tensor,
                grads, ms, vs, masters, params) -> torch.Tensor:
    """``adamw_update``'s arithmetic on lists of matching leaves (a whole
    tree's, or one shard's blocks of a placed one): ``step`` the new step
    count, ``gnorm`` the norm of the whole gradient. Writes the moments,
    master and parameters in place; returns the learning rate."""
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    bc2 = 1.0 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    for g, m, v, w, p in zip(grads, ms, vs, masters, params, strict=True):
        g = g.to(torch.float32, copy=True).mul_(scale)
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        upd.add_(w, alpha=cfg.weight_decay).mul_(lr)
        w.sub_(upd)
        del upd
        p.copy_(w)
    return lr
