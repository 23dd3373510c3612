"""Serving entry point: batched prefill + greedy decode engine
(``repro/launch/serve.py`` at the same path), on one device or, under
``models.sharding.use_sharding(mesh)``, over the mesh (``Engine``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --smoke \
        --device cpu --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
        --smoke --device cpu --prompt-len 40 --gen 24
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch olmoe-1b-7b-0924 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-large-v3 --smoke --device cpu

Serves the dense attention configurations (global, or gemma3-27b's local
and global layers), pixtral-12b (its vision frontend a stub: ``main``
passes zero ``vision_embeds`` for the first ``frontend_tokens``
positions, as the JAX package's does), mamba2-370m, recurrentgemma-9b
(RG-LRU and local attention layers), the MoE configurations
(olmoe-1b-7b, llama4-scout-17b-16e: without a mesh every MoE layer takes
the dense oracle, as under the JAX Engine's 1x1 mesh; and
olmoe-1b-7b-0924, the port's own: OLMoE as published, with QK-norm and
top-8 routing weights left unrenormalised) and the
encoder-decoder whisper-large-v3 (its audio frontend a stub: ``main``
passes zero ``frames`` of [B, encoder_seq, D], as the JAX package's
does). Runs on the CUDA card unless ``--device cpu`` is given.
``--production-mesh`` serves any of them over ``launch.mesh.
make_production_mesh`` (``("data", "model") = (1, n)`` over the node's
cards, or with ``--device cpu`` over two CPU shards), tensor-parallel:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --smoke --device cpu --production-mesh
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import canon, get_config, get_smoke_config
from repro_torch.core import spans
from repro_torch.distributed import spmd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, build_smoke
from repro_torch.models.sharding import use_sharding
from repro_torch.serve import make_decode_step, make_prefill_step
from repro_torch.serve.serve_step import (init_mesh_cache, place_params,
                                          serving_mesh)


class Engine:
    """Minimal batched engine: one prefill, then token-by-token decode.
    A global layer's KV cache is allocated at capacity ``[B, max_len, KH,
    D]`` (stacked over layers); the prefill writes slots ``[0, S)`` and
    each decode step writes slot ``lengths[b]``, all in place. A local
    layer's cache is a ring of ``min(window, max_len)`` slots written at
    ``position % slots`` (the JAX Engine's ``grow``, which pads a ring no
    longer than the prompt out to ``max_len``, is not copied). An SSD or
    RG-LRU layer's cache (``conv`` and ``state``) does not grow with
    length: the prefill and every decode step overwrite it in place. An
    encoder-decoder's cross cache (``encoder_seq`` rounded up to 128
    slots) is written whole by the prefill and only read by decode.
    Serving runs without autograd (``torch.no_grad``).

    Built under ``use_sharding(mesh)`` (the JAX Engine runs inside it
    too) the Engine serves over that mesh (``serve_step.serving_mesh``):
    it places the weights once by ``launch.mesh.param_specs`` (weights
    already placed stay where they are), each prefill makes its cache by
    ``cache_specs``, and every step is one ``shard_map`` over them. The
    tokens it returns are whole tensors on the first shard's device.
    Under ``Flags.seq_shard_kv`` the weights are placed the same way and
    the cache's slots split over that axis."""

    def __init__(self, model, params, batch: int, max_len: int):
        self.model = model
        self.mesh = serving_mesh(model)
        if self.mesh is not None:
            params = place_params(model, params, self.mesh)
        self.params = params
        self.max_len = max_len
        self.batch = batch
        self._prefill = make_prefill_step(model, self.mesh, logits=True)
        self._decode = make_decode_step(model, self.mesh)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                extra: Optional[Dict[str, torch.Tensor]] = None,
                logits: bool = False) -> Tuple:
        """tokens [B,S] → (next token [B,1] int32, cache after the
        prefill), and with ``logits`` the last position's logits [B,1,V].
        ``extra`` (``{"vision_embeds": [B, n_tok, D]}``, or an
        encoder-decoder's ``{"frames": [B, T, D]}``) joins the prefill's
        batch. On a mesh the cache's leaves are ``spmd.Sharded``. The
        batch is one request (``engine.prefill``, ``core/spans.py``)."""
        b, s = tokens.shape
        if s > self.max_len:
            raise ValueError(f"prompt of {s} tokens exceeds max_len "
                             f"{self.max_len}")
        with spans.request("engine.prefill", batch=b, tokens=s):
            with spans.span("engine.init_cache"):
                if self.mesh is not None:
                    cache = init_mesh_cache(self.model, b, self.max_len,
                                            self.mesh)
                else:
                    cache = self.model.init_cache(b, self.max_len,
                                                  tokens.device)
            nxt, cache, last = self._prefill(
                self.params, {**(extra or {}), "tokens": tokens}, cache)
            if logits:
                return _whole(nxt), cache, _whole(last)
            return _whole(nxt), cache

    @torch.no_grad()
    def decode(self, cache: Dict[str, torch.Tensor], cur: torch.Tensor,
               length: int, steps: int) -> torch.Tensor:
        """``steps`` greedy steps from token ``cur`` [B,1] at position
        ``length``; returns their tokens [B, steps]."""
        if length + steps > self.max_len:
            raise ValueError(f"{length} + {steps} decode steps exceed "
                             f"max_len {self.max_len}")
        cur = _whole(cur)
        lengths = torch.full((cur.shape[0],), length, dtype=torch.int32,
                             device=cur.device)
        out = []
        for _ in range(steps):
            cur, cache = self._decode(self.params, cache, cur, lengths)
            lengths = lengths + 1
            out.append(cur)
        return torch.cat([_whole(t) for t in out], dim=1) if out \
            else cur[:, :0]

    @torch.no_grad()
    def generate(self, tokens: torch.Tensor, gen: int,
                 extra: Optional[Dict[str, torch.Tensor]] = None
                 ) -> torch.Tensor:
        """``gen`` tokens per request: the prefill's, then ``gen - 1``
        decode steps. ``extra`` joins the prefill's batch only, as in the
        JAX Engine. Returns [B, gen] int32."""
        nxt, cache = self.prefill(tokens, extra)
        rest = self.decode(cache, nxt, tokens.shape[1], gen - 1)
        return torch.cat([nxt, rest], dim=1)


def _whole(t):
    """A ``spmd.Sharded`` value as one tensor (on its first shard's
    device); a tensor as it is."""
    return t.full() if isinstance(t, spmd.Sharded) else t


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--production-mesh", action="store_true")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run on the host")
    device = torch.device(args.device)
    arch = canon(args.arch)
    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    model = build_smoke(cfg) if args.smoke else build_model(cfg)
    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh(
            devices=[device] * 2 if device.type == "cpu" else None)
    with use_sharding(mesh):
        return _serve(args, cfg, model, device)


def _serve(args, cfg, model, device):
    # on a mesh the weights are drawn straight onto it
    params = model.init(torch.Generator(device).manual_seed(0), device,
                        mesh=serving_mesh(model))
    eng = Engine(model, params, args.batch, args.prompt_len + args.gen)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    extra = {}
    if cfg.enc_dec:
        extra["frames"] = torch.zeros(
            (args.batch, cfg.encoder_seq, cfg.d_model), device=device)
    if cfg.frontend == "vision":
        extra["vision_embeds"] = torch.zeros(
            (args.batch, cfg.frontend_tokens, cfg.d_model), device=device)
    t0 = time.perf_counter()
    out = eng.generate(tokens, args.gen, extra)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"generated {tuple(out.shape)} on {device} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print("sample:", out[0][:12].tolist())
    return out


if __name__ == "__main__":
    main()
