"""A language-model configuration file made into the program's model, with
the benchmark's weights loaded into it by leaf name, and the helpers the
model cells' checks share.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from portbench import weights

# the keys of a configuration file that the program's config holds
MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "rope_theta", "norm_eps", "tie_embeddings",
              "gated_mlp", "layer_pattern")


def port_config(conf: dict):
    """The program's configuration of ``conf["model"]`` with the file's
    sizes. Every key the file does not list under ``reduced`` must agree
    with the program's registered configuration."""
    from repro_torch.configs import get_config
    base = get_config(conf["model"])
    fields = {k: tuple(conf[k]) if isinstance(conf[k], list) else conf[k]
              for k in MODEL_KEYS if k in conf}
    differ = {k: (getattr(base, k), v) for k, v in fields.items()
              if getattr(base, k) != v and k not in conf.get("reduced", [])}
    if differ:
        raise ValueError(f"configuration {conf['name']} disagrees with the "
                         f"program's {conf['model']} on (program, file): "
                         f"{differ}")
    return dataclasses.replace(base, **fields)


def load(conf: dict, seed: int, device) -> Tuple[object, Dict, Dict]:
    """(the program's model, the drawn weights by leaf name, the program's
    parameter tree holding those same tensors)."""
    from repro_torch.models import build_model
    model = build_model(port_config(conf))
    if model.flags.param_dtype != getattr(torch, conf["dtype"]):
        raise ValueError(f"the program serves {conf['model']} in "
                         f"{model.flags.param_dtype}, the file says "
                         f"{conf['dtype']}")
    w = weights.draw(weights.dense_lm_shapes(conf), seed, device)
    tree = weights.into_tree(w, model.init_abstract().tree())
    return model, w, tree


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position: ``ref_logits`` [..., V],
    ``served`` [...] token ids."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long().unsqueeze(-1)).squeeze(-1)
    return float((best - got).max())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float32."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp_min(1e-30))
