"""Serving steps: batched prefill and single-token greedy decode
(``repro/serve/serve_step.py`` at the same path).

Both steps run without autograd (``torch.no_grad``), whatever the
weights' ``requires_grad``. ``tasked_decode_loop`` drives the same decode
step through the port's task runtime: every step is one hetero task over the model state (weights read,
cache, tokens and lengths read and written), followed by
``Runtime.step_boundary()``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.model_zoo import Model
from repro_torch.models.transformer import ParamTree


def make_prefill_step(model: Model):
    @torch.no_grad()
    def prefill_step(params, batch: Dict[str, torch.Tensor], cache):
        """``batch``: ``tokens`` [B,S] and the model's other prefill
        inputs (``vision_embeds``, an encoder-decoder's ``frames``).
        Returns (next_token [B,1] int32, cache after prefill)."""
        x, new_cache = model.apply(params, batch, mode="prefill",
                                   cache=cache)
        logits = model.unembed(params, x[:, -1:])
        return logits.argmax(dim=-1).to(torch.int32), new_cache
    return prefill_step


def make_decode_step(model: Model):
    @torch.no_grad()
    def decode_step(params, cache, tokens: torch.Tensor,
                    lengths: torch.Tensor):
        """tokens: [B,1] current token; lengths: [B] tokens so far.
        Returns (next_token [B,1] int32, cache), the cache written in
        place (a KV cache at slot ``lengths[b]``, a local layer's ring at
        ``lengths[b] % window``)."""
        batch = {"tokens": tokens, "lengths": lengths}
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
    ``"decoder.cross.k"``) to its object."""
    decode = make_decode_step(model)
    tree = params.tree() if isinstance(params, ParamTree) else params
    named = flatten(tree)
    names = [n for n, _ in named]
    n_p = len(named)
    c_named = flatten(cache)
    keys = [n for n, _ in c_named]
    dev = _device_id(runtime, tokens.device)
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
