"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels of ``src/repro_torch/csrc`` with nvcc (sm_90a) into
``build/repro_torch/``, holds every kernel against its plain PyTorch
version on the card at the shapes the main path gives it and at the other
inputs the Pallas entry points take (ragged matmul and flash shapes, the
Jacobi stencil in bf16 and f16, SSD chunks past 256 rows and heads whose
A is positive; the SSD kernel's time split by its launches), then drives
the port's main path through the tasking runtime:

  * the Fig. 3 double DGEMM at n = 4096 float32 (two ``matmul`` launches);
  * the over-decomposed Jacobi3D proxy on a 768^3 float32 domain, 8 chunks
    of 384^3, 10 iterations (80 ``jacobi3d_faces`` launches), which must
    equal the plain PyTorch ``run_reference`` on the card bit for bit; then
    the same under ``trace_graphs``, its sweeps from the fourth on replayed
    as one CUDA graph, equal to both bit for bit, with its steady sweeps'
    time and device idle share beside the interpreted run's;
  * dense-LM serving of yi-9b at full width and depth (48 layers, bf16
    weights from a seed): the ``Engine`` prefills 4 prompts of 2048 tokens
    (48 ``flash_attention`` launches) and decodes 32 steps (48
    ``decode_attention`` launches a step, the cache read in place); the
    prefill must match the plain attention path, the greedy tokens the
    argmax of a full forward, and ``tasked_decode_loop`` through the runtime the
    Engine's tokens and KV cache, interpreted and replayed as CUDA graphs
    (ms per step of each, the device idle share of 4 replayed steps);
  * Mamba-2 serving of mamba2-370m at full width and depth (48 SSD layers,
    bf16 weights from a seed): the ``Engine`` prefills 8 prompts of 4096
    tokens (48 ``ssd_chunk`` launches, 16 chunks each) and decodes 32
    steps with the constant-size recurrent state; the same checks as
    yi-9b's, on the conv and state caches;
  * the distributed Jacobi3D proxy (``run_cluster``) at 768^3 over four
    ranks of the message engine that share the card, 10 iterations (40
    ``jacobi3d_faces`` launches), equal to ``run_reference`` bit for bit,
    with each rank's DIRECT and staged bytes; and ``Rank.send`` latency
    between two ranks at 8 B, 64 KB and 64 MB over both paths;
  * resilience on that cluster: ``CollectiveGroup.allreduce`` of tensors on
    the card at 8 B, 64 KB and 64 MB a member, bit for bit its oracle;
    ``run_cluster`` with its global residual every 5 iterations (40
    launches, residuals against float64 ones of the reference's iterates);
    ``run_cluster_elastic`` in 8 slabs, 4 iterations (32 launches a run),
    unfaulted, with a rank killed and revived from a checkpoint, killed
    with replicas, and frozen, each equal to ``run_reference`` bit for
    bit, and the card's allocation back where it was after them;
  * the SPMD path: ``run_spmd`` at 768^3 over a mesh of four shards that
    share the card, each on its own stream, in the overlapped and the
    bulk-synchronous (MPI+CUDA) schedule, each equal to ``run_reference``
    bit for bit with 40 ``jacobi3d_faces`` launches, their ms an
    iteration beside ``run_cluster``'s; ``seq_sharded_decode`` at a gemma3
    global layer's decode shapes against plain decode, and the SPMD
    collectives bit for bit against host oracles;
  * gemma3-27b serving at full width and depth (62 layers: 52 local of
    window 1024, 10 global; bf16 weights from a seed, 56.8 GB): 2 prompts
    of 4096 tokens (10 ``flash_attention`` launches, one a global layer;
    the local layers take the plain window path, as in the JAX package)
    and 32 decode steps whose local caches wrap their rings; the checks of
    yi-9b's phase, the float32-weight prefill at one period (6 layers);
  * recurrentgemma-9b serving at full width and depth (38 layers: 12
    periods of RG-LRU, RG-LRU, local (window 2048), 2 RG-LRU remainder
    layers; 19.3 GB bf16): 4 prompts of 4096 and 32 decode steps whose
    local layers read their rings through the decode kernel (12
    ``decode_attention`` launches a step) and launch nothing else (the
    RG-LRU recurrence and the window path are plain torch, as in the JAX
    package); greedy decode
    against a full forward in bf16 and float32 (full depth), the tasked
    loop as before, and one RG-LRU layer's prefill scan over 64 positions
    against 64 decode steps in float32 within 1e-4;
  * pixtral-12b serving at full width and depth (40 global layers, 24.5
    GB bf16): 4 prompts of 2048 whose first 256 positions carry seeded
    vision embeddings (40 ``flash_attention`` launches a prefill, none in
    decode, where each layer launches ``decode_attention``) and 32 decode
    steps; yi-9b's checks, the full forward fed the
    same embeddings, the float32 ones at full depth;
  * MoE serving of olmoe-1b-7b at full width and depth (16 layers of 64
    experts, top-8; 13.8 GB bf16) and of llama4-scout-17b-16e at full
    width with 8 of its 48 layers (16 experts, top-1, a shared expert;
    39.4 GB bf16, float32 checks at 4 layers): 4 prompts of 2048 (16 and
    8 ``flash_attention`` launches a prefill; in decode one
    ``decode_attention`` a layer a step) and 32 steps, every MoE layer
    through ``moe_ep``'s one-card path (no mesh): the routed experts
    (``moe_routed``: one launch of each of ``moe_plan``, ``moe_experts``
    and ``moe_combine`` a layer a prefill and a step, where the JAX
    Engine's 1x1 mesh runs the dense oracle); yi-9b's checks, a check between
    two paths taking one path's expert choices in the other where
    rounding reorders near-tied experts (the flips printed); the MoE
    layers' routing, expert products and combine traced by name; then
    one full-width MoE layer through ``moe_ep`` over four shards sharing
    the card against the dense oracle, without and with dropped
    assignments, in bf16 and float32;
  * phase 19, run inside phase 14 on its weights and prompts: the same
    llama4-scout (8 layers, bf16) served by the Engine under
    ``use_sharding`` of a (1, 4) mesh of four shards of the card, tensor-
    and expert-parallel: the weights moved onto it leaf by leaf (the card
    never holds two copies), each shard holding its spec's share (4
    experts, 10 query heads, 2 kv heads, 50,512 vocabulary rows), 32
    ``flash_attention`` launches a prefill (8 layers x 4 shards, at the
    shard's heads q [4, 2048, 2, 5, 128]) and in decode
    ``decode_attention`` only (8 layers x 4 shards a step); the
    prefill's last logits within 5e-2 relative L2 of phase 14's, where
    phase 14 drops the assignments ``moe_ep``'s capacity drops and the
    mesh takes its routes (the routes that differ unpinned printed by
    layer); greedy tokens against a full forward on the
    weights moved back to one device (the same pins and drops); prefill
    ms, decode ms a step, rendezvous a step, each shard's bytes and the
    card's peak; the allocation back after;
  * whisper-large-v3 (encoder-decoder) at full width and depth (32
    encoder and 32 decoder layers, 3.29 GB bf16): 8 requests of 1500
    seeded frames (the audio frontend a stub, as in the JAX package) and
    decoder prompts of 128 tokens from ``data.pipeline.SyntheticLM``, 32
    decode steps; no kernel launch but the decoder self-attention's
    ``decode_attention`` in decode (32 a step; every other attention call
    is the plain blockwise path, as in the JAX package); yi-9b's greedy
    and tasked
    checks, the bf16 prefill on bf16 operands against its products
    upcast, the float32 prefill and decode logits against a full
    forward, the encoder's time, one encoder attention call beside SDPA,
    the prefill's device time by part and the decode step's floor.
    Every serving phase starts with the card nearly empty and must give
    its memory back;
  * training (phases 16-18, no kernel on the path, as in the JAX
    package): yi-9b at full width with 12 of its 48 layers (bf16, batch
    4 x 2048 from ``SyntheticLM``, remat "dots"): each gradient leaf
    against a float32 recomputation, od=4 against od=1, then 6 AdamW
    steps of ``make_train_step`` on one repeated batch whose loss must
    fall every step with no kernel launch (ms a step, tokens/s, a traced
    step's busy share and kernels by kind, peak memory); a checkpoint
    resume at one layer bit for bit the uninterrupted run under
    deterministic algorithms; ``compressed_pmean`` over four shards of
    the card against the stacked form, and ``run_elastic`` 4 -> 2 shards
    against an uninterrupted 2-shard run;
  * phase 20, training on a mesh: the same 12-layer yi-9b drawn straight
    onto a (1, 4) production mesh of four shards of the card (each
    shard's share of the state as its specs give it) and trained
    tensor-parallel, each step one ``shard_map`` whose shards run the
    forward and backward on their blocks: the first step's loss and
    every gradient leaf against the one-card step on the same weights and
    batch, then steps on one repeated batch whose loss must fall, with
    no kernel launch (ms and rendezvous a step, a traced step's busy
    share, peak memory), under a watchdog that fails the phase instead
    of hanging; the allocation back after;
  * phase 21, run inside phases 11 and 15 on their weights and prompts:
    recurrentgemma-9b and whisper-large-v3 served over the same (1, 4)
    mesh of the card's shards, tensor-parallel (the RG-LRU channels, the
    heads, the MLP and, where it divides, the vocabulary), 16 decode
    steps each: each shard's share and every block against its spec, no
    kernel launch but ``decode_attention`` (a self-attention layer a step
    on each shard), the prefill's last logits within 5e-2 relative L2 of
    the one-card Engine's, a second greedy run equal to the first, the
    greedy tokens against a full forward on the weights gathered back;
    prefill ms, decode ms a step, rendezvous, peak; the allocation back;
  * phase 22, phase 20's checks under its watchdog for recurrentgemma-9b
    at full width cut to 6 of its 38 layers (4 x 2048) and
    whisper-large-v3 at full depth (8 x 448 over 1500 seeded frames);
  * phase 23, the dry-run against the card: yi-9b's decode_32k (4
    layers, one shard), train_4k (1 layer, 32 microbatches), prefill_32k
    (1 layer, batch 16 of 32: flash) and decode_32k at the opt level (1
    layer, the cache's slots over the model axis of eight shards of the
    card), olmoe-1b-7b's decode_32k (1 layer, four shards) and
    mamba2-370m's prefill_32k (1 layer: ssd_chunk), and yi-9b's
    train_4k on the multi-pod mesh (2, 1, 1) under the compress_pod
    variant (1 layer, batch 4, the int8 error-feedback reduction over
    pod), each at full width and its cell's own sequence, lowered on meta
    shards in a child process that sees no card (started with phase 1,
    so that it runs beside the earlier phases) and run once on the card
    under the same counter (``repro_torch.opcount``): the counts must be
    equal (FLOPs, bytes, collective bytes by kind, operators and kernel
    launches by name; the prefill cells launched their kernels), the
    arguments' bytes the placed state's, the predicted peak within 10%
    and the predicted temporaries within 2% of the card's for the
    one-shard cells, the step no faster than its roofline bound (time
    over bound printed);
  * phase 24, the multi-pod mesh: yi-9b at full width, 1 layer in
    float32, drawn straight onto a (pod, data, model) = (2, 2, 2) mesh
    of eight shards of the card with ZeRO-1 (the moments and master
    split over data) and residuals over pod, trained 2 steps with
    ``compress_pod_grads`` (each pod's gradient averaged inside the pod,
    then int8 blocks of 256 along the whole leaf's last axis, error
    feedback, all-gathered over pod): the losses, gradient norms,
    parameters, moments, master and residuals against the same seeded
    weights on one card, each pod's gradient through
    ``compressed_mean_stacked_tree`` then AdamW; ms a step, rendezvous,
    the int8 payload and residual bytes a shard, the card's peak, no
    kernel launch, the allocation back.
    Beside phase 2, ``window_attention`` on bf16
    operands against its products on float32 copies at a gemma3 and a
    recurrentgemma local layer's prefill shapes, both timed; phase 2's
    flash rows also run at olmoe's and llama4-scout's head layouts, the
    latter whole and at one shard of phase 19's mesh.

Launch counters are zeroed just before each main-path run and read just
after. The second-to-last line is a JSON object with one entry per kernel of
the main path; the last line is the device summary. Exits non-zero, and
prints no result, on any failure or where there is no CUDA device.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import json
import os
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

import numpy as np
import torch

SEED = 0
JACOBI_N, JACOBI_OD, JACOBI_ITERS = 768, 8, 10
DGEMM_N = 4096
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = "yi-9b", 4, 2048, 32
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_STEPS = "mamba2-370m", 8, 4096, 32
# phase 10: prompts of 4096 against gemma3's window of 1024, so the band
# cuts rows and the decode ring wraps; the float32-weight prefill check runs
# at one period (6 layers): 62 layers in float32 (113 GB) do not fit
GEMMA_ARCH, GEMMA_BATCH, GEMMA_PROMPT, GEMMA_STEPS = "gemma3-27b", 2, 4096, 32
GEMMA_F32_LAYERS = 6
# phase 11: recurrentgemma-9b, prompts of 4096 against its window of 2048
# (the band cuts rows, the rings wrap), float32 checks at full depth (38
# layers, 38.5 GB); the RG-LRU check runs one layer's prefill scan over
# this many positions against as many decode steps, within the JAX test's
# 1e-4 (float32: the scan and the steps sum in other orders)
RG_ARCH, RG_BATCH, RG_PROMPT, RG_STEPS = "recurrentgemma-9b", 4, 4096, 32
RGLRU_SEQ_STEPS, RGLRU_SEQ_TOL = 64, 1e-4
# phase 12: pixtral-12b, prompts of 2048 whose first 256 positions carry
# seeded vision embeddings at the scale of the embedding rows (0.02);
# float32 checks at full depth (40 layers, 49.0 GB)
PIX_ARCH, PIX_BATCH, PIX_PROMPT, PIX_STEPS = "pixtral-12b", 4, 2048, 32
VISION_SCALE = 0.02
# phase 13: olmoe-1b-7b at full width and depth (16 layers of 64 experts,
# top-8; 13.84 GB bf16), float32 checks at full depth (27.7 GB). Phase 14:
# llama4-scout-17b-16e at full width with 8 of its 48 layers (16 experts,
# top-1, a shared expert; 39.4 GB bf16: 48 layers are 215.5 GB, more than
# a card holds), float32 checks at 4 layers (43.5 GB). One card serves
# through moe_ep's one-card path (no mesh): the routed experts in bf16, the
# dense oracle with the float32 weights, as the JAX Engine's 1x1 mesh runs.
MOE_ARCH, SCOUT_ARCH = "olmoe-1b-7b", "llama4-scout-17b-16e"
SCOUT_LAYERS, SCOUT_F32_LAYERS = 8, 4
# phase 19: phase 14's model over a (1, MESH_SHARDS) mesh of shards of the
# card; its prefill logits against phase 14's, relative L2 (bf16: the
# row-parallel products sum four partial products where one card sums one,
# PREFILL_REL_TOL's reason), the shares each shard must hold
MESH_SHARDS = 4
MESH_LOGITS_TOL = 5e-2
MESH_SHARES = {"experts": 4, "q_heads": 10, "kv_heads": 2,
               "vocab_rows": 50512}
# phase 21: phase 11's recurrentgemma-9b and phase 15's whisper-large-v3
# over the same mesh, on their phases' weights and prompts, each decoding
# MESH_SERVE_STEPS steps; phase 19's logits tolerance and greedy checks,
# and what shard 0 holds: recurrentgemma's lru channels, query heads and
# vocabulary split four ways, its one kv head whole; whisper's heads and
# MLP split, its 51,866 vocabulary rows whole (51,866 % 4 = 2)
MESH_SERVE_STEPS = 16
MESH_SERVE_SHARES = {
    "recurrentgemma-9b": {"lru_channels": 1024, "q_heads": 4,
                          "kv_heads": 1, "mlp_columns": 3072,
                          "vocab_rows": 64000},
    "whisper-large-v3": {"q_heads": 5, "kv_heads": 5, "mlp_columns": 1280,
                         "vocab_rows": 51866}}
# the leaf (the last keys of its path) and dim each share is read from
SHARE_LEAVES = {"experts": (("moe", "wi"), 1),
                "lru_channels": (("rglru", "in_x"), -1),
                "q_heads": (("wq",), -2), "kv_heads": (("wk",), -2),
                "mlp_columns": (("mlp", "wi"), -1),
                "vocab_rows": (("embed",), 0)}
# phase 15: whisper-large-v3 at full width and depth (32 encoder and 32
# decoder layers; 3.29 GB bf16, 6.57 GB float32 with the learned positions),
# 8 requests of 1500 seeded frames at the scale tests/test_arch_smoke.py
# draws them (0.1) and decoder prompts of 128 tokens from
# data.pipeline.SyntheticLM, 32 decode steps (160 positions, inside
# Whisper's 448-token decoder context). No kernel is on its path, as in the
# JAX package. Checks: the bf16 prefill on bf16 operands within 2e-2
# relative L2 of the same prefill with the products upcast (flash's bf16
# bound: the float32 sum order can flip a bf16 rounding of p); float32
# prefill and decode logits within 1e-4 of the full forward (the same
# products in other shapes and sum orders)
WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS = \
    "whisper-large-v3", 8, 128, 32
FRAME_SCALE = 0.1
WHISPER_UPCAST_TOL, WHISPER_LOGITS_TOL = 2e-2, 1e-4
# phases 16-18: training. Phase 16 (T1) trains yi-9b at full width (d_model
# 4096, 32 query and 4 KV heads of 128, d_ff 11008, vocab 64000 untied) cut
# to TRAIN_LAYERS of its 48 layers (its state at 16 B a parameter: 48 layers
# are 141 GB), bf16 weights from a seed, DEFAULT_FLAGS (remat "dots", loss
# chunks of 1024) on batches of 4 x 2048 from SyntheticLM: TRAIN_STEPS steps
# on one repeated batch, whose loss must fall every step. Checks: each bf16
# gradient leaf's cosine with a float32 recomputation at least
# TRAIN_COS_MIN (bf16 rounds each product's output and the weights); od=4
# against od=1 on one batch, ce within 1e-2 (bf16 gradients summed in
# another grouping), the gradient norm within 1e-3 relative (its magnitude:
# a missing /od or a dropped microbatch moves it by tens of per cent), the
# first moments within 2e-2 relative L2 (its direction, a few bf16 ulps),
# and at most 1e-3 of the updated parameters more than 2 bf16 ulps apart
# (Adam's first step is about lr x sign(g), so an element whose gradient is
# within bf16 noise of 0 may step either way; a sign error or a dropped
# microbatch flips a large share) (od_check). Phase 17 (T2): resume at 1
# layer, bit for bit under deterministic algorithms. Phase 18 (T3):
# compressed_pmean over 4 shards of the card against the stacked form
# (1e-6: both sum the same float32 values, in the same order), run_elastic
# 4 -> 2 shards against 2 (rtol 1e-4, the JAX test's: the world size
# changes the order of the float32 sums).
TRAIN_ARCH = "yi-9b"
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 12, 4, 2048, 6
TRAIN_OPT = {"lr_peak": 1e-4, "warmup_steps": 2, "total_steps": 100,
             "weight_decay": 0.01}
TRAIN_COS_MIN = 0.99
TRAIN_OD, TRAIN_OD_CE_TOL, TRAIN_OD_M_TOL = 4, 1e-2, 2e-2
TRAIN_OD_GN_TOL, TRAIN_OD_SHARE_MAX = 1e-3, 1e-3
RESUME_LAYERS, RESUME_STEPS, RESUME_AT = 1, 6, 3
# phase 20: phase 16's model and batch trained over a (1, 4) production
# mesh of shards of the card (tensor-parallel), MESH_TRAIN_STEPS steps on
# the repeated batch; its first loss within MESH_TRAIN_LOSS_RTOL of the
# one-card step's (bf16: the mesh adds partial sums in float32 and rounds
# them once, one card rounds each product; the two differ by about 1e-6),
# each gradient leaf's cosine with the one-card step's at least
# TRAIN_COS_MIN (its direction) and its norm within MESH_TRAIN_NORM_RTOL of
# it (its scale: a loss seeded with 1 in place of 1 / its replicas, or a
# replicated leaf's gradient summed twice or not at all, keeps the
# direction and moves the norm by a factor of 2 or more), and so the
# step's grad_norm; the phase fails, and the script exits, if it has not
# ended after MESH_TRAIN_WATCHDOG_S (a collective left waiting in a
# backward would otherwise hang the run)
MESH_TRAIN_SHARDS, MESH_TRAIN_STEPS = 4, 4
MESH_TRAIN_LOSS_RTOL, MESH_TRAIN_NORM_RTOL = 1e-4, 1e-2
MESH_TRAIN_WATCHDOG_S = 600
# phase 22: phase 20's checks for recurrentgemma-9b at full width cut to
# two periods (6 of 38 layers: 3.3 B parameters, 46 GB of state at 14 B a
# parameter; its 38 layers' 135 GB train on four cards,
# tools/mesh_train_cards.py) on 4 x 2048, and whisper-large-v3 at full
# width and depth (1.6 B parameters) on 8 x 448 decoder tokens over 1500
# seeded frames. Each cell: arch -> (layers, None for the config's depth;
# batch; sequence)
MESH_TRAIN_CELLS = {TRAIN_ARCH: (TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ),
                    RG_ARCH: (6, 4, 2048), WHISPER_ARCH: (None, 8, 448)}
COMPRESS_SHARDS, COMPRESS_TOL = 4, 1e-6
ELASTIC_TRAIN_RTOL = 1e-4
# phase 24: yi-9b at full width, MULTIPOD_LAYERS layer(s), trained over a
# (pod, data, model) = MULTIPOD_MESH mesh of shards of the card with
# compress_pod_grads on and ZeRO-1 placed, MULTIPOD_STEPS steps on
# SyntheticLM's batches of MULTIPOD_BATCH x MULTIPOD_SEQ, against the same
# seeded weights on one card without a mesh: each pod's gradient (of its
# half of the batch) through compressed_mean_stacked_tree (the oracle of
# phase 18), then AdamW. In float32: in bf16 the two paths' gradients
# differ by rounding, and an int8 rounding flips wherever that moves a
# scaled value across a half step, so that the residuals could not be
# compared element by element. At 1 layer the state is 0.70 B parameters
# (the two embeddings 0.52 B): on the card about 11 GB of parameters (four
# replicas of each model shard), 17 GB of moments and master (two pods,
# halved by ZeRO-1), 11 GB of residuals (two data replicas) and 11 GB of
# float32 gradients (my arithmetic); 2 layers would pass 60 GB. Held:
# the loss of each step within MULTIPOD_LOSS_RTOL and its gradient norm
# within MULTIPOD_NORM_RTOL. After the first step each residual element
# in units of its 256-block's scale in the reference: at most
# MULTIPOD_OFF_SHARE of them off by more than MULTIPOD_RES_BLOCK_TOL and
# not a tie, and none farther than MULTIPOD_RES_WORST from agreement or a
# tie (a scaled value within noise of a half step rounds either way in
# the two paths, and the two residuals are then each other's negatives).
# After each step each leaf's change of the parameters and master from
# the drawn weights within MULTIPOD_PARAM_RTOL relative L2, its m and v
# within MULTIPOD_MOMENT_RTOL; after the last each residual leaf within
# MULTIPOD_RES_RTOL. A tie moves Adam's update of its element, which
# moves the next step's gradients and ties: the later checks bound that
# drift. Each limit lies between the readings of the sound step and of
# faults planted in the mesh's compressed mean, at this size on an H100
# (tools/phase24_faults.py; PERF.md): sound, 2.4e-6 of the elements off
# and not ties, the worst at 0.088 (unembed; every other leaf 2.2e-3),
# parameters 4.0e-3, moments 7.4e-4, residuals 0.13; each shard
# quantizing with its own blocks (wi, wg) 4.1e-2 and 1.45, parameters
# 6.8e-2, moments 8.1e-3; JAX's blocks with each part's own maximum
# 1.4e-3 and 0.50, parameters 1.3e-2; the carried residual not added,
# residuals 1.39 and parameters 0.51 after step 2; the pods' residuals
# swapped 0.62 and 220
MULTIPOD_MESH = (2, 2, 2)
MULTIPOD_LAYERS, MULTIPOD_BATCH, MULTIPOD_SEQ, MULTIPOD_STEPS = 1, 8, 512, 2
MULTIPOD_LOSS_RTOL, MULTIPOD_NORM_RTOL = 1e-5, 1e-4
MULTIPOD_RES_BLOCK_TOL, MULTIPOD_OFF_SHARE, MULTIPOD_RES_WORST = \
    1e-2, 1e-5, 0.25
MULTIPOD_PARAM_RTOL, MULTIPOD_MOMENT_RTOL, MULTIPOD_RES_RTOL = \
    7e-3, 3e-3, 0.4
MULTIPOD_WATCHDOG_S = 600
# phase 25: sequence parallelism (the rule act_seq -> model, written out in
# the Megatron form: each shard holds its slice of the sequence between the
# layers, gathers it before a column-parallel product, reduce-scatters
# after a row-parallel one) on a (1, SP_SHARDS) production mesh of shards
# of the card: yi-9b at full width cut to SP_LAYERS layers, bf16 weights
# from SEED, DEFAULT_FLAGS (the flash kernel in prefill). A prefill of
# SP_BATCH x SP_SEQ tokens without and with the rule: each one's last
# logits within MESH_LOGITS_TOL (relative L2) of one card's prefill on the
# same weights, the two within SP_AGREE_RTOL of each other (bf16: the
# reduce-scatter sums the same float32 partials as the psum, but the
# products run on S / 4 rows where they ran on S), SP_LAYERS x SP_SHARDS
# flash launches either way, reduce-scatter bytes with the rule and no
# all-reduce of a [B, S, D] activation. One train step's gradients on
# SyntheticLM's batch without and with the rule: the first loss within
# SP_LOSS_RTOL, each leaf's cosine at least TRAIN_COS_MIN and its norm
# within MESH_TRAIN_NORM_RTOL, as phase 20's; then SP_TRAIN_STEPS timed
# steps each way (the first of them a warm-up). Under a watchdog.
SP_SHARDS, SP_LAYERS, SP_BATCH, SP_SEQ = 4, 4, 4, 2048
SP_AGREE_RTOL, SP_LOSS_RTOL = 1e-2, 1e-4
SP_TRAIN_STEPS = 3
SP_WATCHDOG_S = 300
# phase 23: the dry-run (launch.dryrun) against the card. Each cell at full
# width and its own sequence, depth cut by ``probe`` (periods): (label,
# arch, shape, shards of the card, probe, over_decompose, batch (None: the
# shape's), opt level, variant of launch.dryrun.VARIANTS: compress_pod
# lowers on the multi-pod mesh). (b) trains yi-9b's 256 x 4096 batch in 32
# microbatches: at 8 (JAX's od8) the dry-run predicts 9.8 GB of state and
# 145 GB of temporaries, which no card holds; at 32, 39 GB. The prefill
# cells take the kernels: (d) mamba2-370m's ssd_chunk at the shape's batch
# (32 x 32768: 68 GB predicted), (e) yi-9b's flash at batch 16 of the
# shape's 32 (104 GB predicted at 32, 54 at 16). (f) is the opt level's
# decode with the cache's slots split over the model axis of (1, 8) shards
# (yi-9b's 4 kv heads do not divide 8). The counts on meta must equal the
# card's exactly, and each cell of DRYRUN_KERNELS must launch its kernel;
# for the cells of DRYRUN_PEAK_CHECKED the predicted peak (every shard's
# arguments + the counter's peak of every shard's live bytes together,
# ``opcount.Counter.peak_all``: on one shard its own) must lie within
# DRYRUN_PEAK_TOL of the card's max_memory_allocated over the step (less
# cuBLAS's workspaces, which the step allocates and the counter does not
# see), and the predicted temporaries within DRYRUN_TEMP_TOL of that peak
# less the shards' arguments on the card (2%: the readings on an H100 were
# -0.65% for (a) and -0.09% for (b) before (a)'s decode took the decode
# kernel, whose 17 MB of temporaries left the 32 MiB workspace at -66%),
# and the step's time must not beat its
# roofline bound at the card's row of launch.roofline.PEAKS. (c)'s and
# (f)'s shards share the card and their temporaries overlap in ways the
# counter does not follow: printed only. (g) is yi-9b's train_4k over (pod, data, model) =
# (2, 1, 1) shards of the card with the compress_pod variant (the int8
# error-feedback reduction over pod, the vocabulary replicated), od 1 (JAX
# compresses a step of one microbatch only) and a batch of 4 for the
# shape's 256 (each pod's shard holds a whole 1-layer state and its
# residuals, 12.6 GB, and the two shards' temporaries add up on one card).
# (h) and (i) are the opt level's prefills, sequence-parallel over (1, 4)
# shards of the card (the rule act_seq -> model): yi-9b's through flash at
# batch 8, mamba2-370m's through ssd_chunk at batch 4 (each shard runs the
# replicated SSD layer whole: a shard's temporaries are about (d)'s at an
# eighth of its batch). Their shards share the card and take turns in the
# same order on meta and on the card, so the counter's peak of all shards'
# bytes together predicts the card's.
DRYRUN_CELLS = (("a", "yi_9b", "decode_32k", 1, 4, 1, None, "baseline",
                 "baseline"),
                ("b", "yi_9b", "train_4k", 1, 1, 32, None, "baseline",
                 "baseline"),
                ("c", "olmoe_1b_7b", "decode_32k", 4, 1, 1, None,
                 "baseline", "baseline"),
                ("d", "mamba2_370m", "prefill_32k", 1, 1, 1, None,
                 "baseline", "baseline"),
                ("e", "yi_9b", "prefill_32k", 1, 1, 1, 16, "baseline",
                 "baseline"),
                ("f", "yi_9b", "decode_32k", 8, 1, 1, None, "opt",
                 "baseline"),
                ("g", "yi_9b", "train_4k", 2, 1, 1, 4, "baseline",
                 "compress_pod"),
                ("h", "yi_9b", "prefill_32k", 4, 1, 1, 8, "opt",
                 "baseline"),
                ("i", "mamba2_370m", "prefill_32k", 4, 1, 1, 4, "opt",
                 "baseline"))
DRYRUN_PEAK_TOL = 0.10
DRYRUN_TEMP_TOL = 0.02
DRYRUN_PEAK_CHECKED = ("a", "b", "d", "e", "h", "i")
DRYRUN_KERNELS = {"d": "ssd_chunk", "e": "flash_attention",
                  "h": "flash_attention", "i": "ssd_chunk"}
# the EP check after each: one full-width MoE layer's moe_ep over a (1, 4)
# mesh of shards sharing the card, on x [4, 2048, D] (seq-sharded, 512
# positions a shard), at capacity factors E/k (no drops), 1.25 (the
# default) and 1.0, against the dense oracle with the assignments the
# capacity rule drops zeroed: float32 max abs 1e-4 (the same products in
# other shapes and sum orders), bf16 relative L2 2e-2 (the combine rounds
# to bf16 in another order); aux float32 within 1e-6
EP_SHARDS = 4
EP_TOL = {"f32": 1e-4, "bf16": 2e-2}
EP_AUX_TOL = 1e-6
# window_attention on bf16 operands against the same function with its
# products on float32 copies (the CPU's arm), at a gemma3-27b local
# layer's prefill (q [2, 4096, 16, 2, 128], window 1024) and a
# recurrentgemma-9b one's (q [4, 4096, 1, 16, 256], window 2048): 2e-2,
# flash's bf16 bound, for its reason (the float32 sum order can flip a
# bf16 rounding of p)
WINDOW_TOL = 2e-2
# phase 9: run_spmd over 4 shards sharing the card, and steady iterations
# timed after a warm-up one
SPMD_SHARDS, SPMD_TIMED = 4, 10
# seq_sharded_decode at a gemma3 global layer's decode shapes (batch 2,
# capacity 4096 + 32, 16 KV heads of 2 query heads, D 128), each request's
# valid slots ending inside a shard; against decode_attention: float32
# 1e-5 (JAX's test; the logsumexp combine reorders float32 sums), bf16
# 2e-2 (the partials round unnormalised p to bf16 where the plain path
# rounds normalised p, a few bf16 ulps)
SEQ_DECODE_LENGTHS = (2000, 3100)
SEQ_DECODE_TOL = {"f32": 1e-5, "bf16": 2e-2}
# the card's allocation before a serving phase loads its weights: what the
# earlier phases left (the resilience phase leaves about 352 MB)
MEMORY_BEFORE_SERVE = 2 << 30
# phase 8, resilience: allreduce sizes per member (8 B and 64 KB take the
# binomial tree at the default cutover, 64 MB the ring), the residual's
# cadence, and the elastic runs (8 slabs of 96 x 768 x 768 over 4 ranks)
COLL_BYTES, COLL_REPS = (8, 64 << 10, 64 << 20), 5
RESIDUAL_ITERS, RESIDUAL_EVERY = 10, 5
ELASTIC_SLABS, ELASTIC_ITERS = 8, 4
# Heartbeats every 0.05 s and a straggler factor of 25: a rank whose beats
# stop for 1.25 s is a straggler. The kill runs' timeout must lie between
# the unfaulted run's longest gap and that (a killed rank must be declared
# dead before it is taken for a straggler, whose chunks could never leave
# it); the freeze lasts twice the straggler gap, under a timeout twice that.
HB_INTERVAL, STRAGGLER_FACTOR = 0.05, 25.0
# the residual against a float64 one of the reference's iterates: both
# float64 sums of the same squares, in other orders
RESIDUAL_RTOL = 1e-10
# device memory left allocated after the resilience phase's clusters close
MEMORY_SLACK = 64 << 20
# ssd_chunk shapes (bc, q, h, p, n) checked in phase 2: the mamba2 prefill's
# (8 requests x 16 chunks), the mamba2 smoke config's, the three of
# tests/test_kernels.py, a ragged chunk (a prompt shorter than 256), and
# shapes past the first design's limits (q 512, p 128, n 256; ragged q, p
# and n)
SSD_MAIN = (SSM_BATCH * SSM_PROMPT // 256, 256, 32, 64, 128)
SSD_SHAPES = (SSD_MAIN, (4, 16, 4, 32, 16), (2, 16, 4, 8, 16),
              (1, 32, 2, 16, 8), (4, 8, 8, 4, 4), (8, 100, 32, 64, 128),
              (2, 512, 4, 128, 256), (3, 100, 5, 96, 200))
# a model-like ssd_chunk case whose A is positive on every other head: cs
# increases there, so those heads take the kernel's direct form off the
# diagonal
SSD_MIXED = (16, 256, 8, 64, 128)
# matmul shapes (m, k, n) checked in phase 2 in float32 and bf16: the
# DGEMM's; one whose N is not a multiple of the float32 kernel's 128-wide
# tile and whose K (48) ends inside the bf16 kernel's first 64-deep step;
# and one with M, N and K distinct whose tiles overhang the bf16 kernel's
# 128 x 256 output tile on both sides (a transposed or misdescribed B
# operand cannot pass it)
MATMUL_SHAPES = ((DGEMM_N,) * 3, (192, 48, 320), (320, 1040, 192))
# shapes the Pallas kernel takes as one block (dims up to 128) that are not
# multiples of the card tiles: the SGEMM's edge-safe loads, and in bf16 the
# FMA arm where K = 12 gives rows TMA cannot describe
MATMUL_RAGGED = ((100, 64, 64), (32, 16, 32), (96, 12, 40))
# flash_attention_gqa shapes (b, s, t, kh, g, d, causal) checked in phase 2
# in bf16 and float32 beside the main ones: head dims below, between and at
# the D <= 128 kernels' two compiled widths (8 and 12 load element by
# element in bf16), the one-pass kernels' (160 and 192 in three 64-column
# boxes, 256 in four) and the column-group kernels' (130, whose rows are
# not 16-byte multiples, and 264, past 256), S != T with and without the
# mask, one and eight query heads a KV head
FLASH_SHAPES = tuple((2, s, t, 2, g, d, causal)
                     for d in (8, 12, 64, 128, 130, 160, 192, 256, 264)
                     for s, t, causal in ((128, 192, True), (192, 128, False))
                     for g in (1, 8)) + tuple(
    # S and T the Pallas kernel takes as one block, not multiples of 64
    (2, s, t, 2, 4, 64, causal)
    for s, t, causal in ((32, 32, True), (96, 96, True), (96, 128, False)))
# Jacobi shapes (interior x, y, z) checked in bf16 and f16 beside the main
# ones: a small ragged one (both entry points) and the proxy's chunk
JACOBI_HALF_SHAPES = ((70, 33, 65), (JACOBI_N // 2,) * 3)
# Tolerances, each against a plain PyTorch version on the card:
#  - flash kernel output: 2e-2 absolute and relative in bf16. Kernel and
#    plain walk the same 64-wide kv tiles; only the float32 sum order
#    inside a dot product differs, which can flip the bf16 rounding of p or
#    of the output: a few bf16 ulps (2^-8 = 3.9e-3 relative) on outputs
#    below 2. In float32, 1e-4: the same sums in another order, on
#    outputs below 1 (float32 ulps there are below 1.2e-7).
#  - prefill hidden state, kernel on vs off (plain blockwise path, 512
#    blocks), relative L2 error. In bf16, 5e-2: the paths round p to bf16
#    after different running maxima (64- against 512-wide blocks), and 48
#    random layers grow that to about 2e-2. So the same prefill also runs
#    with float32 weights, where the kernel must sit within 1e-4 of the
#    plain path (rounding of the sum order only).
#  - greedy decode vs argmax of a full forward: at least 90% agreement.
#    Random weights give near-ties among 64000 (gemma3: 262144) logits,
#    which bf16 noise between the decode and the full-forward attention
#    paths can flip. A decoded token agrees where its logit in the full
#    forward equals the best one: the logits are bf16, so the best can be
#    an exact tie of several tokens, of which argmax takes the first.
FLASH_TOL = {"f32": 1e-4, "bf16": 2e-2}
PREFILL_REL_TOL = {"bf16": 5e-2, "f32": 1e-4}
#  - ssd_chunk output: largest difference at most 1e-4 of the output's
#    largest magnitude. Kernel and plain version share cs (a float64 scan
#    rounded to float32); only the float32 sum order of the products
#    differs.
#  - mamba2 prefill hidden state, ssd kernel on vs off (the einsum path),
#    relative L2: 1e-4 with float32 weights (sum order of the intra-chunk
#    products only). In bf16, 5e-2: both paths compute the scan in float32
#    but round its output to bf16, so a sum-order difference can flip a
#    bf16 rounding that 48 random layers then carry forward.
SSD_TOL = 1e-4
#  - decode_attention output (bf16) against its plain version on the card:
#    1e-2. The two run the same split arithmetic; the float32 sums go in
#    another order, which can move the output by one bf16 rounding (2^-8
#    of values up to ~4) and flip a rounding of p.
DECODE_TOL = 1e-2
# (G, D) of every configuration's self-attention decode on the card
# (yi-9b, phi4-mini, pixtral-12b, llama4-scout, gemma3-27b, codeqwen and
# olmoe, whisper-large-v3, recurrentgemma-9b), checked at a ragged shape
DECODE_HEADS = ((8, 128), (3, 128), (4, 128), (5, 128), (2, 128), (1, 128),
                (1, 64), (16, 256))
# the benchmark's decode cell: 64 requests, 2,048 + 128 slots, yi-9b heads
DECODE_MAIN = (64, 2176, 4, 8, 128)
# the routed experts (``moe_experts``) as (T, D, F, E, k): one MoE layer of
# the benchmark's MoE cell (OLMoE-1B-7B-0924, 4 x 2048 tokens), the same
# layer in decode (64 tokens), llama4-scout's prefill layer (top-1 of 16,
# the widest products) and ragged shapes: widths that are not multiples of
# the 64-column boxes, T*k < E, a tile of 64 rows
MOE_MAIN = (8192, 2048, 1024, 64, 8)
MOE_DECODE = (64, 2048, 1024, 64, 8)
MOE_SCOUT = (8192, 5120, 8192, 16, 1)
MOE_RAGGED = ((37, 72, 40, 8, 2), (3, 64, 32, 16, 2), (640, 136, 200, 4, 1))
#  - moe_experts: relative L2 error of the layer's output, 1e-2 against
#    the plain version (both round h and y to bf16 once; only the float32
#    sum order of the products differs, which can flip a rounding of h) and
#    2e-2 against moe_dense (which also rounds the gate and up products to
#    bf16 before the silu and the product, and sums the combine over all E
#    experts' weights, most of them zero, in a product of its own order)
MOE_TOL = {"plain": 1e-2, "dense": 2e-2}
SSM_PREFILL_REL_TOL = {"bf16": 5e-2, "f32": 1e-4}
GREEDY_MIN_AGREEMENT = 0.9
GREEDY_MAX_SHORTFALL = 0.25

class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def peaks(name: str):
    """The card's row of the shared table of published peaks
    (``launch.roofline.PEAKS``): its name fragment and (fp32 FLOP/s, bf16
    FLOP/s, HBM bytes/s)."""
    from repro_torch.launch.roofline import peaks as table
    try:
        frag, r = table(name)
    except KeyError as e:
        raise SmokeFailure(str(e)) from None
    return frag, (r.fp32, r.bf16, r.hbm)


@functools.lru_cache(maxsize=None)
def kernel_variants():
    """``tools/kernel_variants.py``, which builds text-substitution variants
    of a kernel source (the earlier designs timed beside the committed
    ones)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        "kernel_variants.py")
    spec = importlib.util.spec_from_file_location("kernel_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the flash kernels by their names in ptxas's output (mangled)
FLASH_KERNELS = {"flash_wgmmaILi3E": "one_pass_bf16_3_boxes",
                 "flash_wgmmaILi4E": "one_pass_bf16_4_boxes",
                 "flash_f32_full": "one_pass_f32",
                 "flash_mma_wide": "column_groups_bf16",
                 "flash_f32_wide": "column_groups_f32",
                 "flash_mmaILi64E": "mma_d64", "flash_mmaILi128E": "mma_d128",
                 "flash_f32ILi64E": "f32_d64", "flash_f32ILi128E": "f32_d128"}
# what ptxas says where it serialises a kernel's wgmma products (C7515,
# C7520, ...); the message names the function
SERIALISED = "wgmma.mma_async instructions are serialized"


def ptxas_kernels(out: str) -> dict:
    """Registers, spill bytes and wgmma serialisation of each flash kernel
    in one library's ``-Xptxas -v`` output."""
    found, cur = {}, None

    def entry(key):
        return found.setdefault(key, {
            "registers": None, "spill_stores": None, "spill_loads": None,
            "wgmma_serialised": False})

    for ln in out.splitlines():
        key = next((v for k, v in FLASH_KERNELS.items()
                    if k in ln.replace("_kernel", "")), None)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                           ln)
        regs = re.search(r"Used (\d+) registers", ln)
        if SERIALISED in ln:
            entry(key or "unattributed")["wgmma_serialised"] = True
        elif "Compiling entry function" in ln:
            cur = entry(key) if key else None
        elif cur is not None and spills:
            cur["spill_stores"], cur["spill_loads"] = map(int, spills.groups())
        elif cur is not None and regs:
            cur["registers"] = int(regs.group(1))
    return found


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def replay_ms(fn, reps: int = 50) -> float:
    """Mean device time of one replay of ``fn`` captured as a CUDA graph
    (no host time between its launches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, reps)
    del graph
    return ms


def bound(nbytes: float, nops: float, op_rate: float, mem_rate: float):
    """Least time (ms) for the work (a kernel's ``cost(...)``: its bytes
    and operations), and which of the two bounds it."""
    t_bytes, t_ops = nbytes / mem_rate * 1e3, nops / op_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stencil_weight(device) -> torch.Tensor:
    """conv3d weight of the 7-point stencil: 1/6 on the six face
    neighbours (the library yardstick for the Jacobi kernels)."""
    w = torch.zeros((1, 1, 3, 3, 3), device=device)
    for idx in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                (1, 1, 2)):
        w[(0, 0) + idx] = 1.0 / 6.0
    return w


def sweep_trace(run_tasked, Runtime, RuntimeConfig, u0,
                traced: bool = False) -> dict:
    """A traced run of the Jacobi main path (``traced``: under
    ``trace_graphs``): where its sweeps' time goes on the device. The
    sweeps span from the first stencil kernel's start to the last one's
    end; inside it, the device is busy for the union of all its kernels
    and copies. The steady sweeps are sweeps 5 to 10, which a traced run
    replays from its captured graph: their time is the interval between
    the first stencil kernels of sweeps 5 and 10, over 5."""
    from torch.profiler import ProfilerActivity, profile
    rt = Runtime(RuntimeConfig(trace_graphs=traced))
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_tasked(u0, JACOBI_ITERS, rt, over_decomposition=JACOBI_OD)
            wall_s = time.perf_counter() - t0
    finally:
        rt.shutdown()
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    stencil = sorted((a, b) for n, a, b in dev if "jacobi3d_faces" in n)
    if len(stencil) != JACOBI_OD * JACOBI_ITERS:
        return {"wall_s": wall_s, "device_trace": "not measured",
                "stencil_kernels_traced": len(stencil)}
    lo, hi = stencil[0][0], max(b for _, b in stencil)
    busy = _busy_us(dev, lo, hi)
    span_ms = (hi - lo) / 1e3
    s_lo, s_hi = stencil[4 * JACOBI_OD][0], stencil[9 * JACOBI_OD][0]
    s_busy = _busy_us(dev, s_lo, s_hi)
    return {"wall_s": wall_s, "sweeps_span_ms": span_ms,
            "ms_per_sweep": span_ms / (JACOBI_ITERS - 1),
            "steady_ms_per_sweep": (s_hi - s_lo) / 1e3 / 5,
            "steady_device_idle_share": 1.0 - s_busy / (s_hi - s_lo),
            "stencil_kernel_ms": sum(b - a for a, b in stencil) / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (hi - lo),
            "by_name_ms": {k: round(v, 3) for k, v in sorted(
                _by_name(dev, lo, hi).items(), key=lambda kv: -kv[1])[:6]}}


def _busy_us(dev, lo, hi) -> float:
    """Length of the union of the device intervals, clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for _, a, b in sorted(dev, key=lambda x: x[1]):
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy, end = busy + b - a, b
    return busy


def _by_name(dev, lo, hi) -> dict:
    out: dict = {}
    for n, a, b in dev:
        if b > lo and a < hi:
            key = "jacobi3d_faces" if "jacobi3d_faces" in n else n[:40]
            out[key] = out.get(key, 0.0) + (b - a) / 1e3
    return out


def kernel_checks(ops, gen, fp32, bf16, mem_rate, earlier_flash) -> dict:
    """Phase 2: each kernel against its plain version at main-path shapes.
    Returns the per-kernel numbers for the JSON line. ``earlier_flash`` is
    the library of the earlier head-dim-256 flash design."""
    from repro_torch.kernels import jacobi3d as JC
    from repro_torch.kernels import matmul as MM
    F = torch.nn.functional
    dev = torch.device("cuda")
    res = {}

    # jacobi3d (padded contract) on a 770^3 slab: must equal the plain
    # version, and both must equal a true float32 division of the sum
    n = JACOBI_N
    u_pad = torch.randn((n + 2,) * 3, generator=gen, device=dev)
    got = ops.jacobi3d(u_pad)
    plain = ops.jacobi3d_plain(u_pad)
    s = u_pad[:-2, 1:-1, 1:-1] + u_pad[2:, 1:-1, 1:-1]
    for sl in ((slice(1, -1), slice(None, -2), slice(1, -1)),
               (slice(1, -1), slice(2, None), slice(1, -1)),
               (slice(1, -1), slice(1, -1), slice(None, -2)),
               (slice(1, -1), slice(1, -1), slice(2, None))):
        s += u_pad[sl]
    true_div = (s.double() / 6.0).float()   # correctly rounded s / 6
    del s
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    check(torch.equal(got, plain), f"jacobi3d != plain (max err {err})")
    plain_true = bool(torch.equal(plain, true_div))
    del true_div, plain
    w = stencil_weight(dev)
    lib_out = F.conv3d(u_pad[None, None], w)[0, 0]
    lib_err = (lib_out - got).abs().max().item()
    del lib_out, got
    work = JC.cost(u_pad)
    b_ms, b_by = bound(work.bytes, work.flops, fp32, mem_rate)
    res["jacobi3d"] = dict(
        shape=[n + 2] * 3, max_abs_err=err, tol=0.0,
        ms=time_ms(lambda: ops.jacobi3d(u_pad), 10),
        plain_ms=time_ms(lambda: ops.jacobi3d_plain(u_pad), 3),
        library_ms=time_ms(lambda: F.conv3d(u_pad[None, None], w), 3),
        library_max_abs_err=lib_err, plain_is_true_division=plain_true,
        bound_ms=b_ms, bound_by=b_by)
    del u_pad

    # jacobi3d_faces on one 384^3 chunk with random face halos
    c = n // 2
    u = torch.randn((c,) * 3, generator=gen, device=dev)
    faces = [torch.randn(shape, generator=gen, device=dev)
             for shape in ((c, c),) * 6]
    got = ops.jacobi3d_faces(u, *faces)
    plain = ops.jacobi3d_faces_plain(u, *faces)
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    check(torch.equal(got, plain), f"jacobi3d_faces != plain (max err {err})")
    up = F.pad(u, (1,) * 6)
    work = JC.faces_cost(u, *faces)
    b_ms, b_by = bound(work.bytes, work.flops, fp32, mem_rate)
    res["jacobi3d_faces"] = dict(
        shape=[c] * 3, max_abs_err=err, tol=0.0,
        ms=time_ms(lambda: ops.jacobi3d_faces(u, *faces), 20),
        plain_ms=time_ms(lambda: ops.jacobi3d_faces_plain(u, *faces), 5),
        library_ms=time_ms(lambda: F.conv3d(up[None, None], w), 5),
        bound_ms=b_ms, bound_by=b_by)
    del u, faces, up, got, plain

    # matmul at MATMUL_SHAPES, float32 (the main path) and bf16; timed at
    # the DGEMM's 4096^3, the bf16 arm (0.2 ms) over 50 calls so that no
    # one call's host time sets the mean
    for dtype, tol, rate, key, reps in (
            (torch.float32, 1e-3, fp32, "matmul", 5),
            (torch.bfloat16, 2e-2, bf16, "matmul_bf16", 50)):
        errs = {}
        for m, k, n in MATMUL_SHAPES:
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            got = ops.matmul(a, b).float()
            want = ops.matmul_plain(a, b).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
                  f"{key} {(m, k, n)} outside {tol} of plain (max err {err})")
            errs[f"{m}x{k}x{n}"] = err
            if (m, k, n) == MATMUL_SHAPES[0]:
                main = (a, b)
            del a, b, got, want
        a, b = main
        m = DGEMM_N
        work = MM.cost(a, b)
        b_ms, b_by = bound(work.bytes, work.flops, rate, mem_rate)
        res[key] = dict(
            shape=[m, m, m], dtype=str(dtype),
            max_abs_err=errs[f"{m}x{m}x{m}"], tol=tol,
            max_abs_err_by_shape=dict(errs),
            ms=time_ms(functools.partial(ops.matmul, a, b), reps),
            plain_ms=time_ms(functools.partial(ops.matmul_plain, a, b), 5),
            library_ms=time_ms(functools.partial(torch.matmul, a, b), reps),
            bound_ms=b_ms, bound_by=b_by)
        for m, k, n in MATMUL_RAGGED:
            a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            b = torch.randn((k, n), generator=gen, device=dev).to(dtype)
            before = ops.LAUNCHES["matmul"]
            got = ops.matmul(a, b).float()
            check(ops.LAUNCHES["matmul"] == before + 1,
                  f"{key} {(m, k, n)} did not launch the kernel")
            want = ops.matmul_plain(a, b).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
                  f"{key} {(m, k, n)} outside {tol} of plain (max err {err})")
            res[key]["max_abs_err_by_shape"][f"{m}x{k}x{n}"] = err
            del a, b, got, want
        del main

    res["jacobi_half_types"] = jacobi_half_checks(ops, gen)
    res.update(flash_checks(ops, gen, fp32, bf16, mem_rate, earlier_flash))
    res["decode_attention"] = decode_checks(ops, gen, bf16, mem_rate)
    res.update(moe_checks(ops, gen, bf16, mem_rate))
    res["ssd_chunk"] = ssd_checks(ops, gen, fp32, mem_rate)
    return res


def jacobi_half_checks(ops, gen) -> dict:
    """Both Jacobi entry points in bf16 and f16 at JACOBI_HALF_SHAPES: equal
    to their plain versions bit for bit, one launch each."""
    dev = torch.device("cuda")
    out = {}
    for dtype in (torch.bfloat16, torch.float16):
        for shape in JACOBI_HALF_SHAPES:
            x, y, z = shape
            u_pad = torch.randn(tuple(n + 2 for n in shape), generator=gen,
                                device=dev).to(dtype)
            u = u_pad[1:-1, 1:-1, 1:-1].contiguous()
            faces = [torch.randn(f, generator=gen, device=dev).to(dtype)
                     for f in ((y, z), (y, z), (x, z), (x, z), (x, y),
                               (x, y))]
            before = dict(ops.LAUNCHES)
            got = ops.jacobi3d(u_pad)
            got_f = ops.jacobi3d_faces(u, *faces)
            check(ops.LAUNCHES["jacobi3d"] == before["jacobi3d"] + 1
                  and ops.LAUNCHES["jacobi3d_faces"]
                  == before["jacobi3d_faces"] + 1,
                  f"jacobi {dtype} {shape} did not launch the kernels")
            for what, a, b in (
                    ("jacobi3d", got, ops.jacobi3d_plain(u_pad)),
                    ("jacobi3d_faces", got_f,
                     ops.jacobi3d_faces_plain(u, *faces))):
                torch.cuda.synchronize()
                diff = int((a != b).sum().item())
                check(a.dtype == dtype and diff == 0,
                      f"{what} {dtype} {shape}: {diff} points differ from "
                      f"plain")
                out[f"{what}/{str(dtype)[6:]}/{'x'.join(map(str, shape))}"] \
                    = "equal"
            del u_pad, u, faces, got, got_f
    return out


def flash_checks(ops, gen, fp32, bf16, mem_rate, earlier) -> dict:
    """flash_attention at the serve prefill's shapes: the GQA entry in bf16
    (the main path, q [4, 2048, 4, 8, 128]) and the Pallas contract in
    float32 at [128, 2048, 128], both causal, then both at D = 256 and
    both at recurrentgemma-9b's heads, q [4, 2048, 1, 16, 256] (the
    one-pass kernels, each timed beside the earlier column-group design
    built from ``earlier``, the library of the same source with the
    one-pass dispatch off), and the bf16 entry at gemma3-27b's global
    layers, q [2, 4096, 16, 2, 128], and pixtral-12b's, q [4, 2048, 8, 4,
    128], olmoe-1b-7b's, q [4, 2048, 16, 1, 128], and llama4-scout's, q
    [4, 2048, 8, 5, 128], whole and at one shard of phase 19's (1, 4)
    mesh, q [4, 2048, 2, 5, 128]; each arm also through the GQA entry at
    FLASH_SHAPES, one launch a call. The library yardstick is
    scaled_dot_product_attention on the same, broadcast, heads."""
    from repro_torch.kernels import flash_attention as FA
    F = torch.nn.functional
    dev = torch.device("cuda")
    edge_errs = {"bf16": {}, "f32": {}}
    for b_, s_, t_, kh_, g_, d_, causal in FLASH_SHAPES:
        q = torch.randn((b_, s_, kh_, g_, d_), generator=gen, device=dev)
        k, v = (torch.randn((b_, t_, kh_, d_), generator=gen, device=dev)
                for _ in range(2))
        for arm, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            qq, kk, vv = (x.to(dtype) for x in (q, k, v))
            before = ops.LAUNCHES["flash_attention"]
            got = ops.flash_attention_gqa(qq, kk, vv, causal=causal).float()
            check(ops.LAUNCHES["flash_attention"] == before + 1,
                  f"flash {arm} at {(b_, s_, t_, kh_, g_, d_)} did not "
                  f"launch the kernel once")
            want = ops.flash_attention_plain(qq, kk, vv,
                                             causal=causal).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            key = f"s{s_}t{t_}g{g_}d{d_}{'c' if causal else ''}"
            tol = FLASH_TOL[arm]
            check(bool(torch.isfinite(got).all()),
                  f"flash {arm} {key}: non-finite")
            check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
                  f"flash {arm} {key} outside {tol} of plain (max err {err})")
            edge_errs[arm][key] = err
    res = {}
    cases = []
    # the main shapes (yi-9b's heads, D = 128), then the same at D = 256
    # (the one-pass kernels), the float32 arm through the Pallas contract
    # [B*H, S, D]; then recurrentgemma-9b's heads (MQA: 16 query heads on
    # one KV head, D = 256) in both arms through the GQA entry; then, in
    # bf16, gemma3-27b's global layers (phase 10's prefill: 2 prompts of
    # 4096, 16 KV heads of 2 query heads, D = 128), pixtral-12b's (phase
    # 12's: 4 prompts of 2048, 8 KV heads of 4 query heads), olmoe-1b-7b's
    # (phase 13's: 16 KV heads of one query head) and llama4-scout's
    # (phase 14's: 8 KV heads of 5 query heads).
    for b, s, kh, g, d, sfx in (
            (SERVE_BATCH, SERVE_PROMPT, 4, 8, 128, ""),
            (SERVE_BATCH, SERVE_PROMPT, 4, 8, 256, "_d256"),
            (SERVE_BATCH, SERVE_PROMPT, 1, 16, 256, "_d256_kh1g16"),
            (GEMMA_BATCH, GEMMA_PROMPT, 16, 2, 128, "_gemma3"),
            (PIX_BATCH, PIX_PROMPT, 8, 4, 128, "_pixtral"),
            (SERVE_BATCH, SERVE_PROMPT, 16, 1, 128, "_olmoe"),
            (SERVE_BATCH, SERVE_PROMPT, 8, 5, 128, "_llama4"),
            (SERVE_BATCH, SERVE_PROMPT, 2, 5, 128, "_llama4_shard")):
        bh = b * kh * g
        q = torch.randn((b, s, kh, g, d), generator=gen, device=dev)
        k = torch.randn((b, s, kh, d), generator=gen, device=dev)
        v = torch.randn((b, s, kh, d), generator=gen, device=dev)
        cases.append(
            ("flash_attention" + sfx, torch.bfloat16, bf16, FLASH_TOL["bf16"],
             (q, k, v), ops.flash_attention_gqa, ops.flash_attention_plain))
        if sfx in ("_gemma3", "_pixtral", "_olmoe", "_llama4",
                   "_llama4_shard"):
            continue
        if kh == 1:
            f32_case = ((q, k, v), ops.flash_attention_gqa,
                        ops.flash_attention_plain)
        else:
            f32_case = (
                (q.permute(0, 2, 3, 1, 4).reshape(bh, s, d),
                 k.permute(0, 2, 1, 3)[:, :, None].expand(b, kh, g, s, d)
                 .reshape(bh, s, d),
                 v.permute(0, 2, 1, 3)[:, :, None].expand(b, kh, g, s, d)
                 .reshape(bh, s, d)),
                ops.flash_attention,
                lambda a, b, c: ops.flash_attention_plain(
                    a[:, :, None, None], b[:, :, None],
                    c[:, :, None])[:, :, 0, 0])
        cases.append(
            ("flash_attention_f32" + sfx, torch.float32, fp32,
             FLASH_TOL["f32"], *f32_case))
        del f32_case
    del q, k, v
    for key, dtype, rate, tol, args, kernel, plain in cases:
        args = tuple(x.to(dtype).contiguous() for x in args)
        got = kernel(*args).float()
        want = plain(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{key}: non-finite output")
        check(bool(torch.allclose(got, want, rtol=tol, atol=tol)),
              f"{key} outside {tol} of plain (max err {err})")
        del got, want
        # SDPA on [B, H, S, D] with K and V broadcast to every query head
        d = args[0].shape[-1]
        if args[0].dim() == 5:
            b, s, kh, g = args[0].shape[:4]
            qs = args[0].reshape(b, s, kh * g, d).transpose(1, 2)
            ks, vs = (x.transpose(1, 2).repeat_interleave(g, dim=1)
                      for x in args[1:])
        else:
            qs, ks, vs = (x[None] for x in args)
        qs, ks, vs = (x.contiguous() for x in (qs, ks, vs))
        # causal work: S(S+1)/2 scored pairs per head, 4*D flops each;
        # q, k and v read once, the output written once
        work = FA.cost(args[0], args[1], causal=True)
        b_ms, b_by = bound(work.bytes, work.flops, rate, mem_rate)
        res[key] = dict(
            shape=list(args[0].shape), dtype=str(dtype), max_abs_err=err,
            tol=tol, ms=time_ms(functools.partial(kernel, *args), 5),
            plain_ms=time_ms(functools.partial(plain, *args), 2, warmup=1),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), 5),
            bound_ms=b_ms, bound_by=b_by)
        if "_d256" in key:
            # the earlier design on the same inputs: checked, then timed in
            # turns with the kernel (earlier, kernel, kernel, earlier)
            call_earlier = kernel_variants().flash_call
            old = call_earlier(earlier, *args).float()
            want = plain(*args).float()
            torch.cuda.synchronize()
            old_err = (old - want).abs().max().item()
            check(bool(torch.allclose(old, want, rtol=tol, atol=tol)),
                  f"{key}: the column-group design outside {tol} of plain "
                  f"(max err {old_err})")
            del old, want
            turns = []
            for fn in (earlier, None, None, earlier):
                call = (functools.partial(kernel, *args) if fn is None else
                        functools.partial(call_earlier, fn, *args))
                turns.append(time_ms(call, 5))
            res[key].update(
                column_group_design_ms=(turns[0] + turns[3]) / 2,
                column_group_design_max_abs_err=old_err,
                turns_ms={"column_groups": [turns[0], turns[3]],
                          "one_pass": [turns[1], turns[2]]})
        del qs, ks, vs, args
    res["flash_attention"]["max_abs_err_by_shape"] = edge_errs["bf16"]
    res["flash_attention_f32"]["max_abs_err_by_shape"] = edge_errs["f32"]
    return res


def decode_checks(ops, gen, bf16, mem_rate) -> dict:
    """decode_attention, the kernel that replaces no Pallas kernel: at
    each of DECODE_HEADS (6 requests, 2 kv heads, 1,000 slots, lengths
    from 1 to 1,000) against its plain version, with NaN past each length
    leaving the output unchanged; then at DECODE_MAIN (yi-9b's decode in
    the benchmark's cell, every slot valid) checked and timed beside its
    plain version, the plain path it replaces
    (``models.attention.decode_attention``: the cache copied, every slot
    scored) and SDPA with ``enable_gqa`` (the yardstick)."""
    from repro_torch.kernels import decode_attention as KD
    from repro_torch.models import attention as A
    F = torch.nn.functional
    dev = torch.device("cuda")

    def operands(b, t, kh, g, d):
        return [torch.randn(sh, generator=gen, device=dev).bfloat16()
                for sh in ((b, kh, g, d), (b, t, kh, d), (b, t, kh, d))]

    errs = {}
    for g, d in DECODE_HEADS:
        q, k, v = operands(6, 1000, 2, g, d)
        n = torch.tensor([1, 1000, 517, 64, 65, 999], dtype=torch.int32,
                         device=dev)
        before = ops.LAUNCHES["decode_attention"]
        got = ops.decode_attention(q, k, v, n).float()
        check(ops.LAUNCHES["decode_attention"] == before + 1,
              f"decode_attention g{g} d{d} did not launch the kernel once")
        want = ops.decode_attention_plain(q, k, v, n).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(torch.allclose(got, want, rtol=DECODE_TOL,
                                  atol=DECODE_TOL)),
              f"decode_attention g{g} d{d} outside {DECODE_TOL} of plain "
              f"(max err {err})")
        for i, ni in enumerate(n.tolist()):
            k[i, ni:] = float("nan")
            v[i, ni:] = float("nan")
        check(torch.equal(ops.decode_attention(q, k, v, n).float(), got),
              f"decode_attention g{g} d{d}: NaN past the lengths changed "
              f"the output")
        errs[f"g{g}d{d}"] = err
        del q, k, v, got, want
    b, t, kh, g, d = DECODE_MAIN
    q, k, v = operands(b, t, kh, g, d)
    n = torch.full((b,), t, dtype=torch.int32, device=dev)
    valid = torch.ones((b, t), dtype=torch.bool, device=dev)
    got = ops.decode_attention(q, k, v, n).float()
    want = ops.decode_attention_plain(q, k, v, n).float()
    path = A.decode_attention(q, k, v, valid=valid).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check(bool(torch.allclose(got, want, rtol=DECODE_TOL, atol=DECODE_TOL)),
          f"decode_attention {DECODE_MAIN} outside {DECODE_TOL} of plain "
          f"(max err {err})")
    qs = q.reshape(b, kh * g, 1, d)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    work = KD.cost(q, k)
    b_ms, b_by = bound(work.bytes, work.flops, bf16, mem_rate)
    return dict(
        shape=[b, kh, g, d], cache=[b, t, kh, d], dtype="torch.bfloat16",
        max_abs_err=err, tol=DECODE_TOL, max_abs_err_by_head=errs,
        max_abs_err_vs_plain_path=(got - path).abs().max().item(),
        splits=list(KD.split_plan(b, kh, t)),
        ms=time_ms(functools.partial(ops.decode_attention, q, k, v, n), 20),
        plain_ms=time_ms(functools.partial(ops.decode_attention_plain, q, k,
                                           v, n), 2, warmup=1),
        plain_path_ms=time_ms(lambda: A.decode_attention(q, k, v,
                                                         valid=valid), 10),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True), 20),
        bound_ms=b_ms, bound_by=b_by)


def moe_checks(ops, gen, bf16, mem_rate) -> dict:
    """The routed experts, the kernels that replace no Pallas kernel: at
    each routing shape the plan's kernels equal to its plain version, and
    the layer (``moe_routed``: the plan, the kernels, the combine) against
    the plain version (``moe_experts_plain``, ``moe_combine_plain``) and
    against ``moe_dense``; every assignment to
    one expert; a CUDA graph captured on one routing and replayed on
    another, against eager. At MOE_MAIN, MOE_DECODE and MOE_SCOUT the
    kernels' time beside the plain version's, the layer's beside
    ``moe_dense``'s, and the products of the library's grouped GEMM
    (``torch._grouped_mm`` where this PyTorch has it, else a ``torch.bmm``
    over segments padded to the largest) as the yardstick."""
    from repro_torch.configs import MoEConfig
    from repro_torch.kernels import moe_experts as KM
    from repro_torch.models import moe as M
    F = torch.nn.functional
    dev = torch.device("cuda")

    def layer(t, d, f, e, k):
        mcfg = MoEConfig(num_experts=e, top_k=k, d_ff_expert=f)
        p = M.moe_init(gen, d, mcfg, True, dtype=torch.bfloat16, device=dev)
        x = torch.randn((1, t, d), generator=gen, device=dev).bfloat16()
        return mcfg, p, x

    def rel(a, b):
        a, b = a.float(), b.float()
        return ((a - b).norm() / b.norm()).item()

    def compare(what, mcfg, p, x):
        before = ops.LAUNCHES["moe_experts"]
        got, aux = M.moe_routed(p, x, mcfg, True)
        check(ops.LAUNCHES["moe_experts"] == before + 1,
              f"{what}: moe_routed did not launch the kernels once")
        xf = x[0]
        w, idx, _ = M._route(p["router"], xf, mcfg)
        rows, tiles = KM.routed_plan(idx, mcfg.num_experts)
        want = KM.routed_plan_plain(idx, mcfg.num_experts)
        check(torch.equal(rows, want[0]) and torch.equal(tiles, want[1]),
              f"{what}: the plan's kernels differ from its plain version")
        plain = KM.moe_combine_plain(KM.moe_experts_plain(
            xf, rows, tiles, p["wg"], p["wi"], p["wo"]), rows, w)
        dense, daux = M.moe_dense(p, x, mcfg, True)
        torch.cuda.synchronize()
        errs = {"plain": rel(got[0], plain), "dense": rel(got, dense)}
        for key, tol in MOE_TOL.items():
            check(errs[key] <= tol, f"{what}: relative L2 error {errs[key]} "
                  f"against {key}, above {tol}")
        check(torch.equal(aux, daux), f"{what}: aux loss differs")
        return errs

    res, errs = {}, {}
    for shape in MOE_RAGGED + (MOE_DECODE,):
        errs["x".join(map(str, shape))] = compare(shape, *layer(*shape))
    # every assignment to expert 3: one segment, the other experts idle
    mcfg, p, x = layer(*MOE_RAGGED[2])
    p["router"].zero_()
    p["router"][:, 3] = 1.0
    x = x.abs() + 0.1
    errs["one_expert"] = compare("one expert", mcfg, p, x)
    del p, x

    # a graph captured on one routing replays right on another
    mcfg, p, x = layer(*MOE_DECODE)
    static = x.clone()
    M.moe_routed(p, static, mcfg, True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = M.moe_routed(p, static, mcfg, True)
    x2 = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
    static.copy_(x2)
    graph.replay()
    want, _ = M.moe_routed(p, x2, mcfg, True)
    torch.cuda.synchronize()
    check(torch.equal(out, want), "moe_routed: a replayed graph differs "
          "from eager on a new routing")
    del p, x, x2, static, out, want, graph

    for key, shape in (("moe_experts", MOE_MAIN),
                       ("moe_experts_decode", MOE_DECODE),
                       ("moe_experts_scout", MOE_SCOUT)):
        t, d, f, e, k = shape
        mcfg, p, x = layer(*shape)
        err = compare(shape, mcfg, p, x)
        xf = x[0]
        w, idx, _ = M._route(p["router"], xf, mcfg)
        rows, tiles = KM.routed_plan(idx, e)
        ws = (p["wg"], p["wi"], p["wo"])
        y = KM.moe_experts(xf, rows, tiles, *ws)
        counts = torch.bincount(idx.reshape(-1), minlength=e)
        order = torch.argsort(idx.reshape(-1), stable=True)
        xs = xf.repeat_interleave(k, dim=0)[order]
        offs = counts.cumsum(0).to(torch.int32)

        def grouped_products():
            g = torch._grouped_mm(xs, p["wg"], offs=offs)
            u = torch._grouped_mm(xs, p["wi"], offs=offs)
            return torch._grouped_mm(F.silu(g) * u, p["wo"], offs=offs)

        def padded_products():
            g = torch.bmm(xb, p["wg"])
            return torch.bmm(F.silu(g) * torch.bmm(xb, p["wi"]), p["wo"])

        try:
            grouped_products()
            library, lib_products = "torch._grouped_mm", grouped_products
        except (AttributeError, RuntimeError) as exc:
            library = f"torch.bmm over padded segments ({exc!r:.80})"
            cap = int(counts.max())
            sorted_e = idx.reshape(-1)[order]
            pos = torch.arange(t * k, device=dev) - (offs - counts)[sorted_e]
            xb = torch.zeros((e, cap, d), dtype=xf.dtype, device=dev)
            xb[sorted_e, pos] = xs
            lib_products = padded_products
        work = KM.cost(xf, rows, p["wg"])
        b_ms, b_by = bound(work.bytes, work.flops, bf16, mem_rate)
        res[key] = dict(
            shape=[t, d, f, e, k], dtype="torch.bfloat16", row_tile=
            KM.row_tile(t * k, e), tiles=tiles.numel(),
            spare_tiles=int((tiles < 0).sum()),
            max_abs_err=(y[rows.long()].float() - KM.moe_experts_plain(
                xf, rows, tiles, *ws)[rows.long()].float()).abs().max()
            .item(),
            rel_l2_err=err, tol=MOE_TOL,
            ms=time_ms(lambda: KM.moe_experts(xf, rows, tiles, *ws), 20),
            plain_ms=time_ms(lambda: KM.moe_experts_plain(
                xf, rows, tiles, *ws), 2, warmup=1),
            library=library,
            library_ms=time_ms(lib_products, 20),
            plan_ms=time_ms(lambda: KM.routed_plan(idx, e), 20),
            plain_plan_ms=time_ms(lambda: KM.routed_plan_plain(idx, e), 5),
            combine_ms=time_ms(lambda: KM.moe_combine(y, rows, w), 20),
            layer_ms=time_ms(lambda: M.moe_routed(p, x, mcfg, True), 10),
            dense_layer_ms=time_ms(lambda: M.moe_dense(p, x, mcfg, True),
                                   3, warmup=1),
            bound_ms=b_ms, bound_by=b_by)
        res[key]["errs_by_shape"] = errs if key == "moe_experts" else {}
        if key == "moe_experts_decode":
            # a decode step's layer as the replayed task graphs run it
            res[key]["replayed_layer_ms"] = replay_ms(
                lambda: M.moe_routed(p, x, mcfg, True))
            res[key]["replayed_dense_layer_ms"] = replay_ms(
                lambda: M.moe_dense(p, x, mcfg, True))
        del p, x, xs, y, lib_products, grouped_products, padded_products
        gc.collect()
        torch.cuda.empty_cache()
    return res


def window_checks(gen, bf16) -> dict:
    """``window_attention`` on bf16 operands (the products' float32
    results from ``aten::bmm.dtype``) against the same function with its
    products on float32 copies (``bmm_f32_upcast``, the CPU's arm), at a
    gemma3-27b local layer's prefill and a recurrentgemma-9b one's; both
    timed by CUDA events. ``flops``: the banded products it issues (each
    query block against 2w keys, the masked half included)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    dev = torch.device("cuda")
    res = {}
    for key, arch, b, s in (("gemma3", GEMMA_ARCH, GEMMA_BATCH, GEMMA_PROMPT),
                            ("recurrentgemma", RG_ARCH, RG_BATCH, RG_PROMPT)):
        cfg = get_config(arch)
        kh, d, w = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.window
        g = cfg.n_heads // kh
        q = torch.randn((b, s, kh, g, d), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((b, s, kh, d), generator=gen, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        pos = torch.arange(s, device=dev)

        def run():
            return A.window_attention(q, k, v, positions=pos, window=w)

        got = run().float()
        with mock.patch.object(A, "bmm_f32", A.bmm_f32_upcast):
            want = run().float()
            upcast_ms = time_ms(run, 3, warmup=1)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"window {key}: non-finite")
        check(bool(torch.allclose(got, want, rtol=WINDOW_TOL,
                                  atol=WINDOW_TOL)),
              f"window {key} on bf16 operands outside {WINDOW_TOL} of the "
              f"upcast products (max err {err})")
        del got, want
        flops = 8 * b * (s // w) * kh * w * w * g * d
        res[key] = dict(q=[b, s, kh, g, d], window=w, max_abs_err=err,
                        tol=WINDOW_TOL, ms=time_ms(run, 3, warmup=1),
                        upcast_ms=upcast_ms, flops=flops,
                        bf16_ops_bound_ms=flops / bf16 * 1e3)
        del q, k, v
    return res


def ssd_inputs(gen, bc, q, h, p, n, model_like: bool, mixed: bool = False):
    """x, dt, A, B, C on the card. ``model_like`` draws dt and A as the
    mamba2 block makes them (softplus around dt_bias = log(expm1(0.01)),
    A = -linspace(1, 16)); otherwise as tests/test_kernels.py does.
    ``mixed`` (with ``model_like``) makes A positive and small (+0.05) on
    every other head."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    x = torch.randn((bc, q, h, p), generator=gen, device=dev)
    r = torch.randn((bc, q, h), generator=gen, device=dev)
    if model_like:
        dt = F.softplus(r + float(np.log(np.expm1(0.01))))
        A = -torch.linspace(1.0, 16.0, h, device=dev)
        if mixed:
            A[1::2] = 0.05
    else:
        dt = F.softplus(r)
        A = -torch.exp(torch.randn((h,), generator=gen, device=dev))
    B = torch.randn((bc, q, n), generator=gen, device=dev)
    C = torch.randn((bc, q, n), generator=gen, device=dev)
    return x, dt, A, B, C


def ssd_checks(ops, gen, fp32, mem_rate) -> dict:
    """ssd_chunk against its plain version at every shape of SSD_SHAPES,
    with test-style and model-style dt and A; times at the main path's
    shape with model-style inputs. No one PyTorch call computes this
    function, so there is no library time."""
    worst = {}
    cases = [(shape, model_like, False) for shape in SSD_SHAPES
             for model_like in (False, True)] + [(SSD_MIXED, True, True)]
    for shape, model_like, mixed in cases:
        args = ssd_inputs(gen, *shape, model_like, mixed)
        y, st = ops.ssd_chunk(*args)
        wy, wst = ops.ssd_chunk_plain(*args)
        torch.cuda.synchronize()
        for got, want, what in ((y, wy, "y"), (st, wst, "states")):
            check(bool(torch.isfinite(got).all()),
                  f"ssd_chunk {shape}: non-finite {what}")
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            check(err <= SSD_TOL * scale, f"ssd_chunk {shape} {what}: "
                  f"max err {err} above {SSD_TOL} x {scale}")
            key = f"{'x'.join(map(str, shape))}{'/mixed' if mixed else ''}" \
                f"/{what}"
            worst[key] = max(worst.get(key, 0.0), err / scale)
        if shape == SSD_MAIN and model_like:
            main_err = max((y - wy).abs().max().item(),
                           (st - wst).abs().max().item())
        del args, y, st, wy, wst
    from repro_torch.kernels import ssd as SS
    args = ssd_inputs(gen, *SSD_MAIN, True)
    work = SS.cost(*args)
    b_ms, b_by = bound(work.bytes, work.flops, fp32, mem_rate)
    return dict(
        shape=list(SSD_MAIN), dtype="torch.float32", max_abs_err=main_err,
        tol=f"{SSD_TOL} x max|plain|", rel_err_by_shape=worst,
        ms_by_part=ssd_parts(ops, args),
        ms=time_ms(functools.partial(ops.ssd_chunk, *args), 10),
        plain_ms=time_ms(functools.partial(ops.ssd_chunk_plain, *args), 3),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)


def ssd_parts(ops, args, reps: int = 5) -> dict:
    """Device time of one ssd_chunk call split by its kernels (a traced
    run of ``reps`` calls): the y part (the scan, the scores and the two y
    kernels) and the states part, with each kernel's own time."""
    from torch.profiler import ProfilerActivity, profile
    ops.ssd_chunk(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ops.ssd_chunk(*args)
        torch.cuda.synchronize()
    by: dict = {}
    for e in prof.events():
        name = e.name.replace("(anonymous namespace)::", "")
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and name.startswith("ssd_"):
            key = name.split("(")[0]
            by[key] = by.get(key, 0.0) + \
                (e.time_range.end - e.time_range.start) / 1e3 / reps
    if not by:
        return {"device_trace": "not measured"}
    return {"by_kernel": by,
            "states": by.get("ssd_states_kernel", 0.0),
            "y": sum(v for k, v in by.items() if k != "ssd_states_kernel")}


def _trace_summary(prof, lo_name: Optional[str] = None) -> dict:
    """Device time of a traced window: its span, the union of its kernels
    and copies (busy), the idle share, the time of kernels whose name holds
    ``lo_name`` (where given) and the six names that took longest."""
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"device_trace": "not measured"}
    lo, hi = min(a for _, a, _ in dev), max(b for _, _, b in dev)
    busy = _busy_us(dev, lo, hi)
    names: dict = {}
    for n, a, b in dev:
        names[n[:60]] = names.get(n[:60], 0.0) + (b - a) / 1e3
    out = {"span_ms": (hi - lo) / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / (hi - lo),
           "by_name_ms": {k: round(v, 3) for k, v in sorted(
               names.items(), key=lambda kv: -kv[1])[:6]}}
    if lo_name is not None:
        named = sum(b - a for n, a, b in dev if lo_name in n) / 1e3
        out[f"{lo_name}_ms"] = named
        out[f"{lo_name}_share_of_busy"] = named / (busy / 1e3)
    return out


def serve_trace(eng, tokens, kernel: Optional[str], extra: dict) -> dict:
    """A traced prefill and four traced decode steps, after the main run:
    where the device time of each goes (``kernel``: the prefill kernels'
    name fragment, where the phase has a kernel)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        nxt, cache = eng.prefill(tokens, extra)
        torch.cuda.synchronize()
    out = {"prefill": _trace_summary(prof, kernel)}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.decode(cache, nxt, tokens.shape[1], 4)
        torch.cuda.synchronize()
    out["decode_4_steps"] = _trace_summary(prof)
    return out


def ranged_device_ms(prof, prefix: str, labels):
    """The device time (ms) of the kernels launched under the profiler
    ranges named ``prefix + label``, summed by label, and the busy time
    (ms) of the traced window's device events (None where the trace holds
    none)."""
    ms = dict.fromkeys(labels, 0.0)
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        if e.name.startswith(prefix) and e.device_type != cuda:
            total = getattr(e, "device_time_total", None)
            if total is None:
                total = e.cuda_time_total
            ms[e.name[len(prefix):]] += total / 1e3
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == cuda and not e.name.startswith(prefix)]
    if not dev:
        return ms, None
    return ms, _busy_us(dev, min(a for _, a, _ in dev),
                        max(b for _, _, b in dev)) / 1e3


def moe_prefill_parts(eng, tokens, extra) -> dict:
    """A prefill of an MoE model with the program's spans recording
    (``core.spans``): the device ms of every layer's ``moe.route`` (the
    router, top-k and balance loss; on one card the routed path's plan),
    ``moe.experts`` (the expert products, a shared expert's too) and
    ``moe.combine`` spans, summed over the layers, and each one's share of
    the prefill's device ms (CUDA events around it)."""
    from repro_torch.core import spans
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with spans.recording():
        start.record()
        eng.prefill(tokens, extra)
        end.record()
        torch.cuda.synchronize()
    total = start.elapsed_time(end)
    ms = {name: sum(r.device_ms for r in spans.records()
                    if r.name == f"moe.{name}" and r.device_ms is not None)
          for name in ("route", "experts", "combine")}
    return {"prefill_ms": total, "ms": ms,
            "share_of_prefill": {k: v / total for k, v in ms.items()}}


def dense_with_drops(p, slices, mcfg, gated: bool, cf: float):
    """The plain oracle of ``moe_ep`` over sequence shards: ``moe_dense``
    over each shard's token slice with the weight of every assignment the
    capacity rule drops zeroed. An assignment's slot is the number of
    earlier ones (in token, then k order) to the same expert in its slice,
    from a cumulative sum of one-hot rows; slots at or past the capacity
    (``ceil(T * k / E * cf)`` rounded up to a multiple of 4, at least 4)
    drop. Returns the output [B, S, D] and the number of drops."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as M
    e, k = mcfg.num_experts, mcfg.top_k
    outs, dropped = [], 0
    for xs in slices:
        b, s, d = xs.shape
        t = b * s
        xf = xs.reshape(t, d)
        w, idx, _ = M._route(p["router"], xf, mcfg)
        cap = math.ceil(t * k / e * cf)
        cap = max(4, (cap + 3) // 4 * 4)
        flat = idx.reshape(-1)
        slot = (torch.nn.functional.one_hot(flat, e).cumsum(0) - 1).gather(
            1, flat[:, None]).view(t, k)
        keep = slot < cap
        dropped += int((~keep).sum())
        ys = M._expert_ffn(p, xf.expand(e, t, d), gated)
        comb = torch.zeros((t, e), dtype=xs.dtype, device=xs.device)
        comb.scatter_(1, idx, (w * keep).to(xs.dtype))
        out = torch.einsum("te,etd->td", comb, ys)
        if mcfg.d_ff_shared:
            out = out + L.mlp_apply(p["shared"], xf, gated)
        outs.append(out.view(b, s, d))
        del ys
    return torch.cat(outs, dim=1), dropped


@contextlib.contextmanager
def counted_rendezvous():
    """The number of SPMD rendezvous (``spmd._exchange`` calls of shard 0)
    while open."""
    from repro_torch.distributed import spmd
    exchange, count = spmd._exchange, [0]

    def counting(t):
        if spmd._ctx().index == 0:
            count[0] += 1
        return exchange(t)

    spmd._exchange = counting
    try:
        yield count
    finally:
        spmd._exchange = exchange


def ep_check(arch: str) -> dict:
    """One full-width MoE layer of ``arch`` (seeded weights) through
    ``moe_ep`` over a (1, EP_SHARDS) mesh of shards sharing the card, on
    x [4, 2048, D] (sequence-sharded), in bf16 and float32. At capacity
    factor E / k no routing can overflow a buffer: the output must lie
    within ``EP_TOL`` of ``moe_dense`` over each shard's token slice (the
    tokens each shard routes) and the aux loss, the mean of the shards',
    within ``EP_AUX_TOL`` of the mean of those calls' (float32). At the
    default 1.25 the output is held to ``dense_with_drops`` and the share
    of dropped assignments printed, and again at 1.0, where the buffers of
    the more loaded experts overflow. ``moe_dense`` over all tokens (its
    aux is not the shards' mean) and the times of one ``moe_ep`` and one
    ``moe_dense`` call are printed beside it."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.sharding import use_sharding
    cfg = get_config(arch)
    mcfg, gated = cfg.moe, cfg.gated_mlp
    e, k = mcfg.num_experts, mcfg.top_k
    dev = torch.device("cuda")
    mesh = make_smoke_mesh(1, EP_SHARDS, devices=[dev] * EP_SHARDS)
    r = {"x": [SERVE_BATCH, SERVE_PROMPT, cfg.d_model], "shards": EP_SHARDS,
         "experts_per_shard": e // EP_SHARDS}

    def ep(p, x, cf):
        with use_sharding(mesh):
            return M.moe_ep(p, x, mcfg, gated, capacity_factor=cf)

    for arm, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        gen = torch.Generator(device=dev).manual_seed(SEED + 2)
        p = M.moe_init(gen, cfg.d_model, mcfg, gated, dtype=dtype,
                       device=dev)
        x = torch.randn((SERVE_BATCH, SERVE_PROMPT, cfg.d_model),
                        generator=gen, device=dev).to(dtype)
        slices = x.chunk(EP_SHARDS, dim=1)
        per_slice = [M.moe_dense(p, xs, mcfg, gated) for xs in slices]
        want = torch.cat([o for o, _ in per_slice], dim=1).float()
        want_aux = sum(a for _, a in per_slice) / EP_SHARDS
        full, full_aux = M.moe_dense(p, x, mcfg, gated)
        a = {"dense_all_tokens": {
            "aux": full_aux.item(),
            "max_abs_vs_per_slice": (full.float() - want).abs().max().item()}}
        del per_slice, full
        for name, cf in (("no_drops", e / k), ("default", 1.25),
                         ("tight", 1.0)):
            with counted_rendezvous() as count:
                got, aux = ep(p, x, cf)
            oracle, dropped = dense_with_drops(p, slices, mcfg, gated, cf)
            got, oracle = got.float(), oracle.float()
            torch.cuda.synchronize()
            err = (got - oracle).abs().max().item()
            rel = ((got - oracle).norm() / oracle.norm()).item()
            c = {"capacity_factor": cf, "dropped": dropped,
                 "dropped_share": dropped / (x.shape[0] * x.shape[1] * k),
                 "max_abs_vs_oracle": err, "rel_l2_vs_oracle": rel,
                 "aux": aux.item(), "rendezvous_per_call": count[0]}
            what = f"{arch} moe_ep {arm} at capacity factor {cf}"
            check(bool(torch.isfinite(got).all()), f"{what}: non-finite")
            if arm == "f32":
                check(err <= EP_TOL["f32"], f"{what}: {err} (max abs) from "
                      f"the dense oracle, above {EP_TOL['f32']}")
            else:
                check(rel <= EP_TOL["bf16"], f"{what}: {rel} (relative L2) "
                      f"from the dense oracle, above {EP_TOL['bf16']}")
            if name == "no_drops":
                check(dropped == 0, f"{what}: the oracle dropped {dropped}")
                c["max_abs_vs_moe_dense"] = (got - want).abs().max().item()
                c["aux_vs_moe_dense"] = abs(aux.item() - want_aux.item())
                if arm == "f32":
                    check(c["max_abs_vs_moe_dense"] <= EP_TOL["f32"],
                          f"{what}: {c['max_abs_vs_moe_dense']} from "
                          f"moe_dense")
                    check(c["aux_vs_moe_dense"] <= EP_AUX_TOL,
                          f"{what}: aux {aux.item()} against moe_dense's "
                          f"{want_aux.item()}")
            elif name == "default":
                t0 = time.perf_counter()
                for _ in range(3):
                    ep(p, x, cf)
                torch.cuda.synchronize()
                c["ep_wall_ms"] = (time.perf_counter() - t0) * 1e3 / 3
                c["ep_ms"] = time_ms(lambda: ep(p, x, cf), 3, warmup=1)
                c["dense_ms"] = time_ms(
                    lambda: M.moe_dense(p, x, mcfg, gated), 3, warmup=1)
            a[name] = c
            del got, oracle, aux
        r[arm] = a
        del p, x, slices, want
        gc.collect()
        torch.cuda.empty_cache()
    del mesh
    gc.collect()
    torch.cuda.empty_cache()
    return r


# A serving phase: the model, batch, prompt tokens and decode steps; the
# kernel flag, the kernel's LAUNCHES key, the layer kind that launches it
# and its name in a trace (all None for a model whose path launches no
# kernel: every counter must then stay 0); the prefill tolerances against
# the plain path; the depth served in bf16 and the depth of the
# float32-weight checks (None for the full depth).
ServeSpec = collections.namedtuple(
    "ServeSpec", "arch batch prompt steps flag kernel kernel_kind trace_name "
    "tols layers f32_layers")
SERVE_SPECS = {
    5: ServeSpec(SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS,
                 "use_flash_kernel", "flash_attention", "global_attn",
                 "flash_mma", PREFILL_REL_TOL, None, None),
    6: ServeSpec(SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_STEPS, "use_ssd_kernel",
                 "ssd_chunk", "ssd", "ssd_",                # ssd_y + states
                 SSM_PREFILL_REL_TOL, None, None),
    10: ServeSpec(GEMMA_ARCH, GEMMA_BATCH, GEMMA_PROMPT, GEMMA_STEPS,
                  "use_flash_kernel", "flash_attention", "global_attn",
                  "flash_mma", PREFILL_REL_TOL, None, GEMMA_F32_LAYERS),
    11: ServeSpec(RG_ARCH, RG_BATCH, RG_PROMPT, RG_STEPS, None, None, None,
                  None, None, None, None),
    12: ServeSpec(PIX_ARCH, PIX_BATCH, PIX_PROMPT, PIX_STEPS,
                  "use_flash_kernel", "flash_attention", "global_attn",
                  "flash_mma", PREFILL_REL_TOL, None, None),
    13: ServeSpec(MOE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS,
                  "use_flash_kernel", "flash_attention", "global_attn",
                  "flash_mma", PREFILL_REL_TOL, None, None),
    14: ServeSpec(SCOUT_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS,
                  "use_flash_kernel", "flash_attention", "global_attn",
                  "flash_mma", PREFILL_REL_TOL, SCOUT_LAYERS,
                  SCOUT_F32_LAYERS),
    15: ServeSpec(WHISPER_ARCH, WHISPER_BATCH, WHISPER_PROMPT, WHISPER_STEPS,
                  None, None, None, None, None, None, None),
}


def allocated_without_workspaces() -> int:
    """``torch.cuda.memory_allocated()`` after freeing cuBLAS's workspaces:
    cuBLAS keeps one, allocated through the caching allocator, for every
    stream it has run on (the runtimes' streams among them)."""
    torch._C._cuda_clearCublasWorkspaces()     # in torch's CUDA builds
    return torch.cuda.memory_allocated()


def clone_tree(tree: dict) -> dict:
    """A copy of a nested dict of tensors."""
    return {k: clone_tree(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def serve_phase(ops, Runtime, RuntimeConfig, phase: int) -> dict:
    """Phase 5 (yi-9b), 6 (mamba2-370m), 10 (gemma3-27b), 11
    (recurrentgemma-9b), 12 (pixtral-12b, its prompts' first 256
    positions vision embeddings), 13 (olmoe-1b-7b), 14 (llama4-scout,
    8 of its 48 layers) or 15 (whisper-large-v3, frames into the encoder,
    prompts from ``SyntheticLM``) at full width through the Engine (the
    main path), then the checks and the tasked decode loop from the same
    prefill state. The card must hold less than ``MEMORY_BEFORE_SERVE``
    before the weights load, and the allocation must come back within
    ``MEMORY_SLACK`` of that after."""
    import dataclasses
    from repro_torch.configs import RGLRU, get_config
    from repro_torch.launch.serve import Engine
    from repro_torch.models import build_model
    from repro_torch.serve import flatten, tasked_decode_loop
    (arch, b, s, steps, flag, kernel, kernel_kind, trace_name, tols,
     layers, f32_layers) = SERVE_SPECS[phase]
    dev = torch.device("cuda")
    gc.collect()
    mem0 = allocated_without_workspaces()
    check(mem0 < MEMORY_BEFORE_SERVE, f"phase {phase}: {mem0} B still "
          f"allocated on the card before the weights load")
    cfg = get_config(arch)
    config_layers = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    # the layers whose kind launches the kernel, once each in a prefill
    n_kernel = layers_of(arch, kernel_kind, cfg.n_layers)
    model = build_model(cfg)
    check((flag is None or getattr(model.flags, flag))
          and model.flags.param_dtype == torch.bfloat16,
          f"serve flags {model.flags}: want bf16 and {flag}")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    r = {"arch": cfg.name, "layers": cfg.n_layers,
         "config_layers": config_layers,
         "f32_layers": f32_layers or cfg.n_layers, "batch": b, "prompt": s,
         "decode_steps": steps, "init_s": time.perf_counter() - t0,
         "weights_gb": sum(p.numel() * p.element_size()
                           for p in params.parameters()) / 1e9}
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    extra = {}
    if cfg.enc_dec:
        from repro_torch.data import DataConfig, SyntheticLM
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=s,
                                      global_batch=b, seed=SEED))
        tokens = torch.from_numpy(data.batch(0)["tokens"]).to(dev)
        extra["frames"] = FRAME_SCALE * torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), device=dev, generator=gen)
        r["frames"] = cfg.encoder_seq
    else:
        tokens = torch.randint(0, cfg.vocab, (b, s), device=dev,
                               generator=gen)
    if cfg.frontend == "vision":
        extra["vision_embeds"] = VISION_SCALE * torch.randn(
            (b, cfg.frontend_tokens, cfg.d_model), device=dev, generator=gen)
        r["vision_positions"] = cfg.frontend_tokens
    eng = Engine(model, params, b, s + steps)
    nxt, cache = eng.prefill(tokens, extra)       # warm-up, not counted
    eng.decode(cache, nxt, s, 2)
    del nxt, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r["allocated_before_gb"] = torch.cuda.memory_allocated() / 1e9

    # -- the main path: prefill + decode, counters around it --
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    nxt, cache = eng.prefill(tokens, extra)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r["launches_in_prefill"] = dict(ops.LAUNCHES)
    start_cache = clone_tree(cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rest = eng.decode(cache, nxt, s, steps)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    r["launches"] = dict(ops.LAUNCHES)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    cache_bytes = {k: v.numel() * v.element_size()
                   for k, v in flatten(cache)}
    r["cache_gb"] = sum(cache_bytes.values()) / 1e9
    r["prefill_ms"] = (t1 - t0) * 1e3
    r["prefill_tok_s"] = b * s / (t1 - t0)
    if cfg.enc_dec:
        r["prefill_frames_s"] = b * cfg.encoder_seq / (t1 - t0)
    r["decode_ms_per_step"] = (t3 - t2) * 1e3 / steps
    r["decode_tok_s"] = b * steps / (t3 - t2)
    out = torch.cat([nxt, rest], dim=1)                   # [B, steps + 1]
    # every self-attention layer's decode reads its bf16 cache through the
    # decode kernel, once a step; every MoE layer runs the routed experts'
    # three wrappers once a prefill and once a step; nothing else launches
    # in decode
    n_decode = steps * attention_layers(arch, cfg.n_layers)
    n_moe = attention_layers(arch, cfg.n_layers) if cfg.moe else 0
    moe_kernels = ("moe_plan", "moe_experts", "moe_combine")
    others = {k: v for k, v in r["launches"].items()
              if k not in (kernel, "decode_attention") + moe_kernels}
    check(not any(others.values())
          and r["launches"]["decode_attention"] == n_decode
          and r["launches_in_prefill"]["decode_attention"] == 0
          and all(r["launches"][m] == n_moe * (steps + 1)
                  and r["launches_in_prefill"][m] == n_moe
                  for m in moe_kernels),
          f"{cfg.name} launched {r['launches']} "
          f"({r['launches_in_prefill']} in the prefill), not "
          f"decode_attention {n_decode} times, all in decode, the routed "
          f"experts {n_moe} times a prefill and a step, and "
          f"{kernel or 'no other kernel'}")
    if kernel is not None:
        check(r["launches"][kernel] == n_kernel
              and r["launches_in_prefill"][kernel] == n_kernel,
              f"serve launched {kernel} {r['launches'][kernel]} times "
              f"({r['launches_in_prefill'][kernel]} in the prefill), not "
              f"{n_kernel} (all in the prefill)")
    check(out.shape == (b, steps + 1) and bool(
        ((out >= 0) & (out < cfg.vocab)).all()), "tokens out of range")

    # -- the same decode as hetero tasks, from the same prefill state:
    # interpreted, then replayed as CUDA graphs (trace_graphs) --
    for traced in (False, True):
        key = "tasked_traced" if traced else "tasked"
        r[key] = tasked_decode(Runtime, RuntimeConfig, tasked_decode_loop,
                               model, params, start_cache, nxt, s, steps,
                               cache, out, traced)
    r["tasked_decode_ms_per_step"] = r["tasked"]["ms_per_step"]
    r["tasked_traced"]["trace_4_replayed_steps"] = traced_decode_trace(
        Runtime, RuntimeConfig, tasked_decode_loop, model, params,
        start_cache, nxt, s)
    # the runtimes' objects (and their lineage records) hold the weights
    del start_cache
    gc.collect()
    r["tasked_equals_engine"] = True

    # -- prefill through the kernel vs the plain path on the card --
    r["prefill_kernel_vs_plain"] = {}
    if flag is not None:
        r["prefill_kernel_vs_plain"]["bf16"] = prefill_vs_plain(
            model, params, tokens, extra, tols["bf16"], flag)

    # -- greedy decode vs argmax of a full forward over prompt + tokens --
    # (an MoE model's: with the experts of a rerun of the same prefill and
    # decode, whose tokens must be the main run's)
    routes = None
    if cfg.moe is not None:
        with routed() as rec:
            again = eng.generate(tokens, steps + 1, extra)
        check(torch.equal(again, out), f"{cfg.name}: a second greedy run "
              f"gave other tokens")
        routes = rec["idx"]
        del rec, again
    r["greedy_vs_full_forward"] = greedy_vs_full_forward(
        model, params, tokens, extra, out, routes)
    del cache, routes
    r["trace"] = serve_trace(eng, tokens, trace_name, extra)
    if cfg.enc_dec:
        r.update(encdec_bf16_checks(eng, tokens, extra, r, cache_bytes))
    if cfg.moe is not None:
        r["trace"]["prefill_moe_parts"] = moe_prefill_parts(eng, tokens,
                                                            extra)
    if arch == SCOUT_ARCH:
        # phase 19 takes these weights over (and frees them)
        r["mesh"] = mesh_phase(ops, model, eng, params, tokens, extra,
                               steps)
    elif arch in MESH_SERVE_SHARES:
        # and phase 21 those of phases 11 and 15
        r["mesh"] = mesh_serve_phase(ops, model, eng, params, tokens, extra)
    if trace_name is not None:
        share = r["trace"]["prefill"].get(f"{trace_name}_share_of_busy",
                                          0.0)
        check(share > 0, f"no {trace_name!r} kernel time in the traced "
              f"prefill ({r['trace']['prefill']})")
    # the same checks with float32 weights (at ``f32_layers`` where the
    # full depth does not fit): the bf16 ones go
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = cfg if f32_layers is None else dataclasses.replace(
        cfg, n_layers=f32_layers)
    model32 = build_model(cfg32, dataclasses.replace(
        model.flags, param_dtype=torch.float32))
    params32 = model32.init(torch.Generator(device=dev).manual_seed(SEED),
                            dev)
    if flag is not None:
        r["prefill_kernel_vs_plain"]["f32"] = prefill_vs_plain(
            model32, params32, tokens, extra, tols["f32"], flag)
        r["prefill_kernel_vs_plain"]["f32"]["layers"] = cfg32.n_layers
    # and greedy decode with them, where bf16 noise cannot flip a token
    with routed() as rec:
        out32 = Engine(model32, params32, b, s + steps).generate(
            tokens, steps + 1, extra)
    r["greedy_vs_full_forward"]["f32"] = greedy_vs_full_forward(
        model32, params32, tokens, extra, out32,
        rec["idx"] if cfg.moe is not None else None)
    del rec
    r["greedy_vs_full_forward"]["f32"]["layers"] = cfg32.n_layers
    if RGLRU in cfg.layer_pattern:
        r["rglru"] = rglru_checks(model32, params32, b, s)
    if cfg.enc_dec:
        r["f32_logits_vs_full_forward"] = logits_vs_full_forward(
            model32, params32, tokens, extra, steps)
    del params32, model32, tokens, out32, extra
    gc.collect()
    torch.cuda.empty_cache()
    raw = torch.cuda.memory_allocated()
    mem1 = allocated_without_workspaces()
    r.update(allocated_at_start_mb=mem0 / 2**20,
             allocated_at_end_mb=mem1 / 2**20,
             allocated_at_end_with_cublas_workspaces_mb=raw / 2**20)
    check(abs(mem1 - mem0) <= MEMORY_SLACK, f"phase {phase}: device memory "
          f"allocated {mem0} B before and {mem1} B after")
    return r


def encdec_bf16_checks(eng, tokens, extra, r: dict, cache_bytes) -> dict:
    """Phase 15's bf16 checks and times, after the main run: the prefill
    on bf16 operands against the same prefill with its products upcast;
    the encoder's time alone (host clock, synchronised, after the main
    run's warm-up); one encoder attention call at the prefill's shapes on
    bf16 operands and upcast, beside SDPA; the prefill's device time by
    part; and the decode step's floor from the bytes it must read."""
    from repro_torch.models import encdec as ED
    from repro_torch.serve import flatten
    model, params = eng.model, eng.params
    cfg = model.cfg
    b = tokens.shape[0]
    out = {"prefill_bf16_operands_vs_upcast": prefill_vs_upcast(
        model, params, tokens, extra, WHISPER_UPCAST_TOL)}
    frames = extra["frames"]
    t = frames.shape[1]
    padded = torch.nn.functional.pad(frames, (0, 0, 0, (-t) % 128))
    enc_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ED.encode(params, padded, cfg, model.flags)
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    out["encoder_ms"] = enc_ms
    out["encoder_frames_s"] = b * t / (min(enc_ms) / 1e3)
    out["encoder_attention_call"] = encoder_attention_call(
        cfg, b, padded.shape[1])
    out["prefill_parts"] = encdec_prefill_parts(eng, tokens, extra)
    # a decode step reads the decoder's and the unembedding's weights, the
    # whole self cache (masked past each length) and the whole cross cache
    tree = params.tree()
    weight_bytes = sum(v.numel() * v.element_size() for k, v in
                       flatten(tree) if k.startswith("decoder.")
                       or k == "unembed")
    step_bytes = weight_bytes + sum(cache_bytes.values())
    _, (_, _, mem_rate) = peaks(torch.cuda.get_device_name(0))
    out["decode_floor"] = {
        "weight_bytes": weight_bytes, "cache_bytes": cache_bytes,
        "bytes_per_step": step_bytes,
        "floor_ms_per_step": step_bytes / mem_rate * 1e3}
    return out


def prefill_vs_upcast(model, params, tokens, extra, tol: float) -> dict:
    """The prefill's final hidden state with the attention products on the
    operands' own dtype (``attention.bmm_f32``, the card's arm) against the
    same prefill with the operands cast to float32 first
    (``bmm_f32_upcast``, the CPU's arm), in relative L2."""
    from unittest import mock

    from repro_torch.models import attention as A
    batch = {**extra, "tokens": tokens}
    x, _ = model.apply(params, batch, mode="prefill")
    with mock.patch.object(A, "bmm_f32", A.bmm_f32_upcast):
        want, _ = model.apply(params, batch, mode="prefill")
    x, want = x.float(), want.float()
    check(bool(torch.isfinite(x).all()), "non-finite prefill hidden state")
    rel = ((x - want).norm() / want.norm()).item()
    check(rel <= tol, f"{model.cfg.name}: the prefill on bf16 operands is "
          f"{rel} (relative L2) from the upcast one, above {tol}")
    return {"rel_l2": rel, "max_abs": (x - want).abs().max().item(),
            "tol_rel_l2": tol}


def encoder_attention_call(cfg, b: int, t: int) -> dict:
    """One encoder self-attention call (``attention.flash_attention``,
    bidirectional, at the prefill's shapes: q [b, t, KH, G, D]) on bf16
    operands against the same call with the products upcast, both timed
    by CUDA events, beside ``scaled_dot_product_attention`` on the same
    inputs (a library call the port does not use)."""
    from unittest import mock

    from repro_torch.models import attention as A
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    kh, d = cfg.n_kv_heads, cfg.resolved_head_dim
    g = cfg.n_heads // kh
    q = torch.randn((b, t, kh, g, d), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((b, t, kh, d), generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))

    def run():
        return A.flash_attention(q, k, v, causal=False)

    got = run().float()
    with mock.patch.object(A, "bmm_f32", A.bmm_f32_upcast):
        want = run().float()
        upcast_ms = time_ms(run, 3, warmup=1)
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), "encoder attention: non-finite")
    check(bool(torch.allclose(got, want, rtol=WINDOW_TOL, atol=WINDOW_TOL)),
          f"encoder attention on bf16 operands outside {WINDOW_TOL} of the "
          f"upcast products (max err {err})")
    del got, want
    sdpa_q = q.view(b, t, kh * g, d).transpose(1, 2)
    sdpa_k, sdpa_v = (a.transpose(1, 2) for a in (k, v))
    sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        sdpa_q, sdpa_k, sdpa_v), 3, warmup=1) if g == 1 else None
    flops = 4 * b * t * t * kh * g * d
    _, (_, bf16, _) = peaks(torch.cuda.get_device_name(0))
    r = dict(q=[b, t, kh, g, d], max_abs_err=err, tol=WINDOW_TOL,
             ms=time_ms(run, 3, warmup=1), upcast_ms=upcast_ms,
             sdpa_ms=sdpa_ms, flops=flops,
             bf16_ops_bound_ms=flops / bf16 * 1e3)
    del q, k, v, sdpa_q, sdpa_k, sdpa_v
    return r


def encdec_prefill_parts(eng, tokens, extra) -> dict:
    """A traced prefill of the encoder-decoder with profiler ranges around
    the encoder (``encdec.encode``), the blockwise attention
    (``attention.flash_attention``: in the encoder, or the decoder's self
    and cross), the encoder's MLPs (``layers.mlp_apply`` inside the
    encoder) and the cross K/V projections (``encdec._cross_kv``): the
    device time of the kernels launched under each and its share of the
    prefill's busy time. ``encoder_other`` is the encoder's q, k, v and o
    products, norms and residuals; ``decoder`` is the rest of the
    prefill."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention as A
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    inside = {"encoder": False}

    def ranged(fn, label_of):
        def call(*args, **kw):
            with record_function(f"encdec.{label_of()}"):
                return fn(*args, **kw)
        return call

    def encode(*args, **kw):
        inside["encoder"] = True
        try:
            with record_function("encdec.encoder"):
                return saved[(ED, "encode")](*args, **kw)
        finally:
            inside["encoder"] = False

    saved = {(ED, "encode"): ED.encode, (A, "flash_attention"):
             A.flash_attention, (L, "mlp_apply"): L.mlp_apply,
             (ED, "_cross_kv"): ED._cross_kv}
    patches = {
        (ED, "encode"): encode,
        (A, "flash_attention"): ranged(A.flash_attention, lambda: (
            "encoder_attention" if inside["encoder"]
            else "decoder_attention")),
        (L, "mlp_apply"): ranged(L.mlp_apply, lambda: (
            "encoder_mlp" if inside["encoder"] else "decoder_mlp")),
        (ED, "_cross_kv"): ranged(ED._cross_kv, lambda: "cross_kv")}
    try:
        for (mod, name), fn in patches.items():
            setattr(mod, name, fn)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.prefill(tokens, extra)
            torch.cuda.synchronize()
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    ms, busy = ranged_device_ms(prof, "encdec.", (
        "encoder", "encoder_attention", "encoder_mlp", "cross_kv",
        "decoder_attention", "decoder_mlp"))
    if busy is None or not ms["encoder"]:
        return {"device_trace": "not measured"}
    ms["encoder_other"] = ms["encoder"] - ms["encoder_attention"] - \
        ms["encoder_mlp"]
    ms["decoder"] = busy - ms["encoder"] - ms["cross_kv"]
    return {"busy_ms": busy, "ms": ms,
            "share_of_busy": {k: v / busy for k, v in ms.items()}}


def logits_vs_full_forward(model, params, tokens, extra, steps: int) -> dict:
    """Phase 15's float32 check: the Engine's prefill and ``steps`` decode
    steps, taken step by step as ``Engine.prefill`` and ``Engine.decode``
    take them (a capacity cache written in place, the greedy token fed
    back), give logits within ``WHISPER_LOGITS_TOL`` of one full forward
    (``mode="train"``) over the prompt and the tokens fed, at the same
    positions; their greedy tokens must be ``Engine.generate``'s."""
    from repro_torch.launch.serve import Engine
    b, s = tokens.shape
    cache = model.init_cache(b, s + steps, tokens.device)
    x, cache = model.apply(params, {**extra, "tokens": tokens},
                           mode="prefill", cache=cache)
    logits = [model.unembed(params, x[:, -1:]).float()]
    del x
    cur, fed = logits[0].argmax(dim=-1).to(torch.int32), []
    lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    for _ in range(steps):
        fed.append(cur)
        x, cache = model.apply(params, {"tokens": cur, "lengths": lengths},
                               mode="decode", cache=cache)
        step_logits = model.unembed(params, x).float()
        logits.append(step_logits)
        cur = step_logits.argmax(dim=-1).to(torch.int32)
        lengths = lengths + 1
    del cache
    got = torch.cat(logits, dim=1)                      # [B, steps + 1, V]
    out = Engine(model, params, b, s + steps).generate(tokens, steps + 1,
                                                       extra)
    check(torch.equal(got.argmax(dim=-1).to(torch.int32), out),
          "phase 15: the logits' greedy tokens are not the Engine's")
    full = torch.cat([tokens] + fed, dim=1)
    hidden, _, _ = model.apply(params, {**extra, "tokens": full}, mode="train")
    want = model.unembed(params, hidden[:, s - 1:]).float()
    del hidden
    err = (got - want).abs().max().item()
    check(bool(torch.isfinite(got).all()), "phase 15: non-finite logits")
    check(bool(torch.allclose(got, want, rtol=WHISPER_LOGITS_TOL,
                              atol=WHISPER_LOGITS_TOL)),
          f"{model.cfg.name} (float32): prefill and decode logits outside "
          f"{WHISPER_LOGITS_TOL} of the full forward (max err {err})")
    return {"positions": steps + 1, "max_abs_err": err,
            "prefill_max_abs_err": (got[:, 0] - want[:, 0]).abs().max()
            .item(), "tol": WHISPER_LOGITS_TOL,
            "logit_scale": want.abs().max().item()}


def rglru_checks(model32, params32, b: int, s: int) -> dict:
    """Phase 11's RG-LRU checks with the float32 weights at full width: the
    first RG-LRU layer's prefill over ``RGLRU_SEQ_STEPS`` positions against
    as many decode steps of it (outputs and final state within
    ``RGLRU_SEQ_TOL``, as the JAX package's test holds its scan); and the
    time of the prefill's recurrence (``linear_scan`` over [b, s, width]
    float32, by CUDA events, less the two input copies the timing loop
    makes)."""
    from repro_torch.models import rglru as R
    cfg = model32.cfg
    dev = torch.device("cuda")
    lp = {k: v[0] for k, v in params32.tree()["periods"]["0"]["rglru"]
          .items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    u = torch.randn((b, RGLRU_SEQ_STEPS, cfg.d_model), generator=gen,
                    device=dev)
    full, fc = R.rglru_layer(lp, u, rcfg=cfg.rglru, mode="prefill")
    cache = R.init_rglru_cache(b, cfg.d_model, cfg.rglru,
                               dtype=torch.float32, device=dev)
    steps = []
    for t in range(RGLRU_SEQ_STEPS):
        y, cache = R.rglru_layer(lp, u[:, t:t + 1], rcfg=cfg.rglru,
                                 mode="decode", cache=cache)
        steps.append(y)
    seq = torch.cat(steps, dim=1)
    err = (seq - full).abs().max().item()
    state_err = (cache["state"] - fc["state"]).abs().max().item()
    check(bool(torch.isfinite(full).all()), "RG-LRU prefill: non-finite")
    check(bool(torch.allclose(seq, full, rtol=RGLRU_SEQ_TOL,
                              atol=RGLRU_SEQ_TOL))
          and bool(torch.allclose(cache["state"], fc["state"],
                                  rtol=RGLRU_SEQ_TOL, atol=RGLRU_SEQ_TOL)),
          f"RG-LRU scan against {RGLRU_SEQ_STEPS} decode steps outside "
          f"{RGLRU_SEQ_TOL} (max err {err}, state {state_err})")
    del full, fc, cache, steps, seq, u
    width = cfg.rglru.lru_width or cfg.d_model
    a = torch.exp(-0.1 * torch.rand((b, s, width), generator=gen,
                                    device=dev))
    bt = torch.randn((b, s, width), generator=gen, device=dev)
    copies = time_ms(lambda: (a.clone(), bt.clone()), 5)
    scan = time_ms(lambda: R.linear_scan(a.clone(), bt.clone()), 5)
    del a, bt
    return {"scan_vs_decode_steps": RGLRU_SEQ_STEPS,
            "scan_vs_decode_max_abs_err": err,
            "scan_vs_decode_state_max_abs_err": state_err,
            "tol": RGLRU_SEQ_TOL, "scan_shape": [b, s, width],
            "scan_ms": scan - copies, "scan_input_copies_ms": copies}


def greedy_vs_full_forward(model, params, tokens, extra, out,
                           routes: Optional[list] = None,
                           keep_of=None) -> dict:
    """The Engine's greedy tokens ``out`` [B, steps + 1] after ``tokens``
    [B, S] (with the prefill's ``extra`` inputs) against the logits of one
    forward over prompt + tokens (with the same ``extra``): at
    least ``GREEDY_MIN_AGREEMENT`` of them agree (their logit is the
    forward's best) and none lies more than ``GREEDY_MAX_SHORTFALL``
    below it. For an MoE model ``routes`` holds the expert choices of a
    prefill and ``steps`` decode steps that gave ``out`` (``routed``):
    the checked forward takes them (``full_forward_pins``), and the
    forward on its own routing is reported beside it with the positions
    whose top-k set differs. ``keep_of`` (``routed``'s) drops, in both
    forwards, the assignments a mesh's ``moe_ep`` drops (phase 19)."""
    import dataclasses
    from repro_torch.configs import GLOBAL_ATTN
    from repro_torch.models import build_model
    cfg, s = model.cfg, tokens.shape[1]
    full = torch.cat([tokens, out[:, :-1]], dim=1)
    n = full.shape[1]
    fwd_flags = model.flags
    r = {}
    if GLOBAL_ATTN in cfg.layer_pattern and not cfg.enc_dec:
        # the attention layer takes the kernel only at S % 128 == 0, as the
        # JAX package's takes the Pallas one: the plain path, in
        # the largest block that divides prompt + steps (an
        # encoder-decoder's prompt + steps fit one block of 512)
        blk = max(d for d in range(1, 513) if n % d == 0)
        fwd_flags = dataclasses.replace(fwd_flags, use_flash_kernel=False,
                                        flash_block=blk)
        r["full_forward_block"] = blk
    fwd = build_model(cfg, fwd_flags)

    def logits_of():
        hidden, _, _ = fwd.apply(params, {**extra, "tokens": full},
                              mode="train")
        return fwd.unembed(params, hidden[:, s - 1:]).float()  # [B,steps+1,V]

    if routes is not None:
        with routed(keep_of=keep_of):
            r["own_routing"] = agreement(logits_of(), out)
        pins = full_forward_pins(routes, cfg.n_layers, full.shape[0], s,
                                 n - s)
        with routed(pins, keep_of) as rec:
            logits = logits_of()
        r["routing"] = {"rows_differing_in_top_k": rec["flips"],
                        "rows": rec["rows"],
                        "decode_rows_differing_in_top_k": sum(
                            int(rec["flips_by_call"][i].view(
                                full.shape[0], n)[:, s:].sum())
                            for i in range(cfg.n_layers))}
        del pins
    else:
        logits = logits_of()
    r.update(agreement(logits, out))
    del logits
    what = f"{cfg.name} ({model.flags.param_dtype})"
    agree = r["agreement"]
    check(agree >= GREEDY_MIN_AGREEMENT, f"{what}: greedy decode agrees with "
          f"the full forward on {agree:.4f} of tokens, below "
          f"{GREEDY_MIN_AGREEMENT}")
    check(r["max_logit_shortfall"] <= GREEDY_MAX_SHORTFALL,
          f"{what}: a decoded token's logit lies {r['max_logit_shortfall']} "
          f"below the full forward's best, more than {GREEDY_MAX_SHORTFALL}")
    return r


def agreement(logits: torch.Tensor, out: torch.Tensor) -> dict:
    """How the greedy tokens ``out`` [B, n] sit in ``logits`` [B, n, V]:
    the share whose logit is the best (exact ties counted), the share that
    is the first argmax, and how far below the best the others lie."""
    top2 = logits.topk(2, dim=-1).values
    # how far below the full forward's best logit each decoded token lies
    # (0 where the two agree)
    shortfall = top2[..., 0] - logits.gather(-1, out.long()[..., None])[..., 0]
    first = logits.argmax(dim=-1) == out
    return {
        "agreement": (shortfall == 0).float().mean().item(),
        "threshold": GREEDY_MIN_AGREEMENT,
        "argmax_agreement": first.float().mean().item(),
        "tied_at_best": int(((shortfall == 0) & ~first).sum().item()),
        "shortfalls_where_not_first": shortfall[~first].tolist(),
        "max_logit_shortfall": shortfall.max().item(),
        "shortfall_tol": GREEDY_MAX_SHORTFALL,
        "median_top2_gap": (top2[..., 0] - top2[..., 1]).median().item()}


@contextlib.contextmanager
def routed(pins: Optional[list] = None, keep_of=None):
    """While open, every MoE routing call (``models.moe._route``) is
    recorded in call order: the dict yielded lists each call's expert
    indices under ``idx``. With ``pins`` (index tensors in the same call
    order) each call takes its pinned experts in place of its own top-k,
    weighted by its own probabilities renormalised over them, and
    ``flips`` counts the rows whose own top-k set differs from the pinned
    one (``flips_by_call``: which rows, per call). Bf16 rounding that
    differs between two paths moves a router logit by about 1e-3, enough
    to reorder two near-tied experts; a check between the paths pins one
    to the other's experts so that it measures the paths, not the
    flip. ``keep_of(idx)`` (a bool mask of a call's experts, pinned or
    its own) zeroes the weight of each assignment it marks False: the
    ones a mesh's ``moe_ep`` drops, so that the dense path computes
    ``dense_with_drops``."""
    from repro_torch.models import moe as M
    route = M._route
    rec = {"idx": [], "flips": 0, "rows": 0, "flips_by_call": []}

    def call(router_w, x, mcfg):
        w, idx, aux = route(router_w, x, mcfg)
        if pins is not None:
            pin = pins[len(rec["idx"])]
            differs = (idx.sort(-1).values != pin.sort(-1).values).any(-1)
            rec["flips_by_call"].append(differs)
            rec["flips"] += int(differs.sum())
            rec["rows"] += idx.shape[0]
            w = torch.softmax(x.float() @ router_w, dim=-1).gather(-1, pin)
            w, idx = w / w.sum(-1, keepdim=True).clamp_min(1e-9), pin
        if keep_of is not None:
            w = w * keep_of(idx)
        rec["idx"].append(idx)
        return w, idx, aux

    M._route = call
    try:
        yield rec
    finally:
        M._route = route


def capacity_keep(idx: torch.Tensor, gid: torch.Tensor, mcfg,
                  cf: float = 1.25) -> torch.Tensor:
    """Which assignments ``idx`` [T, k] ``moe_ep``'s capacity rule keeps
    when the tokens of each group ``gid`` [T] (one shard's routing call)
    are routed together: those whose slot (earlier assignments in the
    group, in token then k order, to the same expert) lies below the
    capacity of the group's size (``dense_with_drops``'s rule)."""
    from repro_torch.models import moe as M
    keep = torch.empty(idx.shape, dtype=torch.bool, device=idx.device)
    for g in gid.unique().tolist():
        rows = (gid == g).nonzero()[:, 0]
        flat = idx[rows].reshape(-1)
        slot = (torch.nn.functional.one_hot(flat, mcfg.num_experts)
                .cumsum(0) - 1).gather(1, flat[:, None]).view(len(rows), -1)
        keep[rows] = slot < M.capacity(len(rows), mcfg, cf)
    return keep


def routing_groups(b: int, s: int, tp: int, steps: int, device
                   ) -> torch.Tensor:
    """The routing call each row of a [B, S + steps] forward (b-major)
    belongs to in a prefill of S and ``steps`` decode steps over ``tp``
    model shards: slice ``t // (S / tp)`` of the prompt, then one call a
    step (every shard routes all B tokens of a step)."""
    t = torch.arange(s + steps, device=device)
    g = torch.where(t < s, t // (s // tp), tp + t - s)
    return g.repeat(b)


@contextlib.contextmanager
def mesh_routes(b: int, s: int, tp: int, pins: Optional[list] = None):
    """``routed`` for a model served over a mesh of ``tp`` model shards:
    each shard's routing calls (in its own thread) recorded in its own
    list, and with ``pins`` (a one-device prefill's calls, [B*S, k] each)
    each shard's prefill call takes its slice of S of them. ``flips``
    counts, per shard and call, the rows whose own top-k set differs from
    the pinned one."""
    from repro_torch.distributed import spmd
    from repro_torch.models import moe as M
    route = M._route
    rec = {"by_shard": [[] for _ in range(tp)],
           "flips": [[] for _ in range(tp)]}

    def call(router_w, x, mcfg):
        w, idx, aux = route(router_w, x, mcfg)
        m = spmd.axis_index("model")
        mine = rec["by_shard"][m]
        if pins is not None:
            sl = s // tp
            pin = pins[len(mine)].view(b, s, -1)[:, m * sl:(m + 1) * sl] \
                .reshape(idx.shape).to(idx.device)
            rec["flips"][m].append(int((idx.sort(-1).values
                                        != pin.sort(-1).values).any(-1)
                                       .sum()))
            w = torch.softmax(x.float() @ router_w, dim=-1).gather(-1, pin)
            w, idx = w / w.sum(-1, keepdim=True).clamp_min(1e-9), pin
        mine.append(idx)
        return w, idx, aux

    M._route = call
    try:
        yield rec
    finally:
        M._route = route


def mesh_call_routes(rec: dict, n_layers: int, b: int, s: int,
                     steps: int) -> list:
    """``mesh_routes``' record of a prefill and ``steps`` decode steps as
    one device's calls (``routed``'s ``idx``): each prefill call the
    shards' slices joined along S, each decode call shard 0's (every
    shard routes all tokens of a step, the same way)."""
    shards = rec["by_shard"]
    tp = len(shards)
    check(all(len(x) == n_layers * (1 + steps) for x in shards),
          f"mesh routing calls {[len(x) for x in shards]}, not "
          f"{n_layers} x {1 + steps} a shard")
    dev = shards[0][0].device
    out = [torch.cat([shards[m][i].view(b, s // tp, -1).to(dev)
                      for m in range(tp)], dim=1).reshape(b * s, -1)
           for i in range(n_layers)]
    for i in range(n_layers, n_layers * (1 + steps)):
        check(all(torch.equal(shards[m][i].to(dev), shards[0][i])
                  for m in range(tp)), "decode routing differs by shard")
        out.append(shards[0][i])
    return out


def take_tree(module) -> dict:
    """A ``ParamTree``'s weights as a nested dict, taken out of it: the
    module holds none of them afterwards."""
    out = {}
    for k in list(module._parameters):
        out[k] = module._parameters.pop(k).detach()
    for k, m in list(module._modules.items()):
        out[k] = take_tree(m)
    return out


def gather_tree(tree: dict) -> dict:
    """A nested dict of ``Sharded`` gathered onto one device leaf by
    leaf, each placed leaf dropped from ``tree`` as it goes."""
    out = {}
    for k in list(tree):
        v = tree.pop(k)
        out[k] = gather_tree(v) if isinstance(v, dict) else v.full()
        del v
    return out


def mesh_phase(ops, model, eng, params, tokens, extra, steps: int) -> dict:
    """Phase 19: phase 14's llama4-scout (8 layers, bf16; ``eng`` its
    one-device Engine on ``params``) served over a (1, MESH_SHARDS) mesh
    of shards of the card, tensor- and expert-parallel.

    The reference first: phase 14's prefill with the assignments
    ``moe_ep`` drops on the mesh (capacity 1.25 over each shard's slice of
    the prompt) zeroed layer by layer, as its own routes give them, and
    those routes recorded; then again pinned to them: its last logits.
    Both sides then route hidden states with the same drops, so a route
    that differs (counted per layer) comes from rounding alone. The weights then move onto the mesh leaf by leaf
    (``spmd.place``, consuming the one-device tree) and each shard's share
    is checked. The main path: the mesh Engine's prefill and 32 decode
    steps, the counters zeroed before and read after (``flash_attention``
    once a layer and shard in the prefill, nothing in decode). The
    prefill's logits, pinned to the reference's routes, within
    MESH_LOGITS_TOL of the reference's. The main run's tokens again with
    the mesh's routes recorded; the weights gathered back to one device
    and the greedy tokens held to a full forward with those routes and
    drops. The allocation must come back to what it was less the weights
    the phase took over."""
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_smoke_mesh, param_specs
    from repro_torch.launch.serve import Engine
    from repro_torch.models.sharding import use_sharding
    t_phase = time.perf_counter()
    cfg, mcfg = model.cfg, model.cfg.moe
    b, s = tokens.shape
    tp, dev = MESH_SHARDS, tokens.device
    gc.collect()
    mem0 = allocated_without_workspaces()
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    r = {"mesh": {"data": 1, "model": tp}, "devices": f"{tp} shards of "
         f"{dev}", "layers": cfg.n_layers, "batch": b, "prompt": s,
         "decode_steps": steps}

    # -- the reference: phase 14's prefill with the mesh's drops, pinned --
    keep = functools.partial(capacity_keep,
                             gid=routing_groups(b, s, tp, 0, dev), mcfg=mcfg)
    with routed(keep_of=keep) as rec:
        eng.prefill(tokens, extra)
    pins = rec["idx"]
    r["dropped_in_prefill"] = sum(int((~keep(p)).sum()) for p in pins)
    with routed(pins, keep):
        want = eng.prefill(tokens, extra, logits=True)[2]
    want = want.float()
    del rec

    # -- the weights onto the mesh, leaf by leaf --
    mesh = make_smoke_mesh(1, tp, devices=[dev] * tp)
    tree = take_tree(params)
    t0 = time.perf_counter()
    placed = spmd.place(tree, param_specs(tree, model.axes(), mesh),
                        consume=True)
    torch.cuda.synchronize()
    r["place_s"] = time.perf_counter() - t0
    del tree
    r.update(placed_shares(placed, mesh, MESH_SHARES))
    check(r["shard_shares"] == MESH_SHARES, f"phase 19: a shard holds "
          f"{r['shard_shares']}, not {MESH_SHARES}")
    r["weights_gb"] = weights / 1e9
    r["allocated_after_place_gb"] = torch.cuda.memory_allocated() / 1e9

    with use_sharding(mesh):
        meng = Engine(model, placed, b, s + steps)
        check(meng.params is placed or all(
            a is c for (_, a), (_, c) in zip(_sharded_leaves(meng.params),
                                             _sharded_leaves(placed))),
              "phase 19: the Engine placed the placed weights again")
        with counted_rendezvous() as count:          # warm-up, not counted
            nxt, cache = meng.prefill(tokens, extra)
        r["rendezvous_per_prefill"] = count[0]
        with counted_rendezvous() as count:
            meng.decode(cache, nxt, s, 2)
        r["rendezvous_per_decode_step"] = count[0] / 2
        del nxt, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # -- the main path: prefill + decode, counters around it --
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        nxt, cache = meng.prefill(tokens, extra)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r["launches_in_prefill"] = dict(ops.LAUNCHES)
        rest = meng.decode(cache, nxt, s, steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        r["launches"] = dict(ops.LAUNCHES)
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["cache_gb_per_shard"] = sum(
            t.shards[0].numel() * t.shards[0].element_size()
            for _, t in _sharded_leaves(cache)) / 1e9
        r["prefill_ms"] = (t1 - t0) * 1e3
        r["prefill_tok_s"] = b * s / (t1 - t0)
        r["decode_ms_per_step"] = (t2 - t1) * 1e3 / steps
        r["decode_tok_s"] = b * steps / (t2 - t1)
        out = torch.cat([nxt, rest], dim=1)
        del cache, rest
        n_flash = cfg.n_layers * tp
        n_decode = steps * attention_layers(cfg.name, cfg.n_layers) * tp
        check(r["launches_in_prefill"]["flash_attention"] == n_flash
              == r["launches"]["flash_attention"]
              and r["launches"]["decode_attention"] == n_decode
              and r["launches_in_prefill"]["decode_attention"] == 0
              and sum(r["launches"].values()) == n_flash + n_decode,
              f"phase 19 launched {r['launches']} ({r['launches_in_prefill']}"
              f" in the prefill), not flash_attention {n_flash} times, all "
              f"in the prefill, and decode_attention {n_decode} in decode")
        check(out.shape == (b, steps + 1) and bool(
            ((out >= 0) & (out < cfg.vocab)).all()), "phase 19: tokens out "
              "of range")

        # -- the prefill's logits against phase 14's --
        with mesh_routes(b, s, tp, pins) as mrec:
            got = meng.prefill(tokens, extra, logits=True)[2]
        got = got.float()
        rel = ((got - want).norm() / want.norm()).item()
        flips = [sum(mrec["flips"][m][i] for m in range(tp))
                 for i in range(cfg.n_layers)]
        r["prefill_logits_vs_phase14"] = {
            "rel_l2": rel, "tol": MESH_LOGITS_TOL,
            "rows_whose_own_top_k_differs_from_the_pins": sum(flips),
            "of_rows": b * s * cfg.n_layers,
            "differing_rows_by_layer": flips,
            "argmax_equal": (got.argmax(-1) == want.argmax(-1)).float()
            .mean().item()}
        check(bool(torch.isfinite(got).all()), "phase 19: non-finite logits")
        check(rel <= MESH_LOGITS_TOL, f"phase 19: prefill logits {rel} "
              f"(relative L2) from phase 14's, above {MESH_LOGITS_TOL}")
        own = meng.prefill(tokens, extra, logits=True)[2]
        r["prefill_logits_vs_phase14"]["rel_l2_unpinned"] = (
            (own.float() - want).norm() / want.norm()).item()
        del got, own, want, mrec

        # -- the main run's tokens again, the mesh's routes recorded --
        with mesh_routes(b, s, tp) as mrec:
            again = meng.generate(tokens, steps + 1, extra)
        check(torch.equal(again, out), "phase 19: a second greedy run gave "
              "other tokens")
        routes = mesh_call_routes(mrec, cfg.n_layers, b, s, steps)
        del meng, mrec, again

    # -- greedy against a full forward, the weights back on one device --
    back = gather_tree(placed)
    del placed, mesh
    keep = functools.partial(
        capacity_keep, gid=routing_groups(b, s, tp, steps, dev), mcfg=mcfg)
    pins_full = full_forward_pins(routes, cfg.n_layers, b, s, steps)
    r["dropped_in_served_run"] = sum(int((~keep(p)).sum())
                                     for p in pins_full)
    r["greedy_vs_full_forward"] = greedy_vs_full_forward(
        model, back, tokens, extra, out, routes, keep)
    del back, routes, pins_full, out
    gc.collect()
    torch.cuda.empty_cache()
    mem1 = allocated_without_workspaces()
    r.update(allocated_at_start_mb=mem0 / 2**20,
             allocated_at_end_mb=mem1 / 2**20,
             weights_taken_over_mb=weights / 2**20)
    check(abs(mem1 - (mem0 - weights)) <= MEMORY_SLACK,
          f"phase 19: {mem1} B allocated after, {mem0} B before with "
          f"{weights} B of weights taken over")
    r["phase_s"] = time.perf_counter() - t_phase
    return r


def placed_shares(placed: dict, mesh, want: dict) -> dict:
    """What shard 0 of a placed model holds (``want``'s keys, each read
    off the first leaf ``SHARE_LEAVES`` names), each shard's bytes of
    weights, and whether every block has the shape its spec gives."""
    from repro_torch.distributed import spmd
    leaves = list(_sharded_leaves(placed))

    def dim(name):
        suffix, d = SHARE_LEAVES[name]
        return next(t.shards[0].shape[d] for path, t in leaves
                    if path[-len(suffix):] == suffix)
    return {"shard_shares": {k: dim(k) for k in want},
            "shard_weights_gb": [sum(
                t.shards[i].numel() * t.shards[i].element_size()
                for _, t in leaves) / 1e9 for i in range(mesh.size)],
            "blocks_as_specs": all(
                tuple(b.shape) == spmd.NamedSharding(mesh, t.spec)
                .shard_shape(t.shape) for _, t in leaves for b in t.shards)}


def mesh_serve_phase(ops, model, eng, params, tokens, extra) -> dict:
    """Phase 21: phase 11's recurrentgemma-9b or phase 15's whisper-large-v3
    (bf16; ``eng`` its one-device Engine on ``params``) served over a (1,
    MESH_SHARDS) mesh of shards of the card, tensor-parallel (the RG-LRU
    channels, the heads, the MLP and, where it divides, the vocabulary).

    The reference first: the one-device prefill's last logits. The weights
    then move onto the mesh leaf by leaf (``spmd.place``, consuming the
    one-device tree) and each shard's share is checked against
    ``MESH_SERVE_SHARES`` and every block against its spec. The main path:
    the mesh Engine's prefill and ``MESH_SERVE_STEPS`` decode steps, the
    counters zeroed before and read after (the decode kernel's launches
    only, as on one card); the prefill's logits within ``MESH_LOGITS_TOL`` of the
    reference's; a second greedy run equal to the first; the weights
    gathered back to one device and the greedy tokens held to a full
    forward (``greedy_vs_full_forward``). The allocation must come back
    to what it was less the weights the phase took over."""
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_smoke_mesh, param_specs
    from repro_torch.launch.serve import Engine
    from repro_torch.models.sharding import split_axes, use_sharding
    t_phase = time.perf_counter()
    cfg = model.cfg
    b, s = tokens.shape
    tp, dev, steps = MESH_SHARDS, tokens.device, MESH_SERVE_STEPS
    gc.collect()
    mem0 = allocated_without_workspaces()
    weights = sum(p.numel() * p.element_size() for p in params.parameters())
    r = {"arch": cfg.name, "mesh": {"data": 1, "model": tp},
         "devices": f"{tp} shards of {dev}", "layers": cfg.n_layers,
         "batch": b, "prompt": s, "decode_steps": steps,
         "host_threads": threading.active_count()}
    want = eng.prefill(tokens, extra, logits=True)[2].float()

    # -- the weights onto the mesh, leaf by leaf --
    mesh = make_smoke_mesh(1, tp, devices=[dev] * tp)
    tree = take_tree(params)
    t0 = time.perf_counter()
    placed = spmd.place(tree, param_specs(tree, model.axes(), mesh),
                        consume=True)
    torch.cuda.synchronize()
    r["place_s"] = time.perf_counter() - t0
    del tree
    shares = MESH_SERVE_SHARES[cfg.name]
    r.update(placed_shares(placed, mesh, shares))
    r["split_axes"] = sorted(split_axes(model.axes(), placed))
    r["weights_gb"] = weights / 1e9
    check(r["shard_shares"] == shares, f"phase 21 ({cfg.name}): a shard "
          f"holds {r['shard_shares']}, not {shares}")
    check(r["blocks_as_specs"], f"phase 21 ({cfg.name}): a block's shape "
          f"is not the one its spec gives")

    with use_sharding(mesh):
        meng = Engine(model, placed, b, s + steps)
        with counted_rendezvous() as count:          # warm-up, not counted
            nxt, cache = meng.prefill(tokens, extra)
        r["rendezvous_per_prefill"] = count[0]
        with counted_rendezvous() as count:
            meng.decode(cache, nxt, s, 2)
        r["rendezvous_per_decode_step"] = count[0] / 2
        del nxt, cache
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # -- the main path: prefill + decode, counters around it --
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        nxt, cache = meng.prefill(tokens, extra)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rest = meng.decode(cache, nxt, s, steps)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        r["launches"] = dict(ops.LAUNCHES)
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["cache_gb_per_shard"] = sum(
            t.shards[0].numel() * t.shards[0].element_size()
            for _, t in _sharded_leaves(cache)) / 1e9
        r["prefill_ms"] = (t1 - t0) * 1e3
        r["prefill_tok_s"] = b * s / (t1 - t0)
        r["decode_ms_per_step"] = (t2 - t1) * 1e3 / steps
        r["decode_tok_s"] = b * steps / (t2 - t1)
        out = torch.cat([nxt, rest], dim=1)
        del cache, rest
        n_decode = steps * attention_layers(cfg.name, cfg.n_layers) * tp
        check(r["launches"]["decode_attention"] == n_decode
              and sum(r["launches"].values()) == n_decode,
              f"phase 21 ({cfg.name}) launched hand-written kernels "
              f"{r['launches']}, not decode_attention {n_decode} times (a "
              f"self-attention layer a step on each shard)")
        check(out.shape == (b, steps + 1) and bool(
            ((out >= 0) & (out < cfg.vocab)).all()), f"phase 21 "
              f"({cfg.name}): tokens out of range")

        # -- the prefill's logits against the one device's --
        got = meng.prefill(tokens, extra, logits=True)[2].float()
        rel = ((got - want).norm() / want.norm()).item()
        r["prefill_logits_vs_one_card"] = {
            "rel_l2": rel, "tol": MESH_LOGITS_TOL,
            "argmax_equal": (got.argmax(-1) == want.argmax(-1)).float()
            .mean().item()}
        check(bool(torch.isfinite(got).all()), f"phase 21 ({cfg.name}): "
              f"non-finite logits")
        check(rel <= MESH_LOGITS_TOL, f"phase 21 ({cfg.name}): prefill "
              f"logits {rel} (relative L2) from one card's, above "
              f"{MESH_LOGITS_TOL}")
        del got, want
        again = meng.generate(tokens, steps + 1, extra)
        check(torch.equal(again, out), f"phase 21 ({cfg.name}): a second "
              f"greedy run gave other tokens")
        del meng, again

    # -- greedy against a full forward, the weights back on one device --
    back = gather_tree(placed)
    del placed, mesh
    r["greedy_vs_full_forward"] = greedy_vs_full_forward(
        model, back, tokens, extra, out)
    del back, out
    gc.collect()
    torch.cuda.empty_cache()
    mem1 = allocated_without_workspaces()
    r.update(allocated_at_start_mb=mem0 / 2**20,
             allocated_at_end_mb=mem1 / 2**20,
             weights_taken_over_mb=weights / 2**20)
    check(abs(mem1 - (mem0 - weights)) <= MEMORY_SLACK,
          f"phase 21 ({cfg.name}): {mem1} B allocated after, {mem0} B "
          f"before with {weights} B of weights taken over")
    r["phase_s"] = time.perf_counter() - t_phase
    return r


def _sharded_leaves(tree: dict, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _sharded_leaves(v, path + (k,))
        else:
            yield path + (k,), v


def full_forward_pins(routes: list, n_layers: int, b: int, s: int,
                      steps: int) -> list:
    """The expert choices of a prefill of S positions and ``steps`` decode
    steps (``routes``: the prefill's ``n_layers`` calls, then each step's)
    as one forward over S + steps positions would route them: per layer,
    [B * (S + steps), k]."""
    check(len(routes) == n_layers * (1 + steps),
          f"recorded {len(routes)} routing calls, not {n_layers} x "
          f"{1 + steps}")
    pre, dec = routes[:n_layers], routes[n_layers:]
    return [torch.cat([pre[i].view(b, s, -1)]
                      + [dec[j * n_layers + i].view(b, 1, -1)
                         for j in range(steps)], dim=1).reshape(
                          b * (s + steps), -1) for i in range(n_layers)]


def tasked_decode(Runtime, RuntimeConfig, tasked_decode_loop, model, params,
                  start_cache, nxt, s, steps, cache, out, traced) -> dict:
    """``tasked_decode_loop`` from the prefill state: ms per step, runtime
    counters, and its tokens, lengths and cache checked bit for bit
    against the Engine's (``cache``, ``out``). ``traced`` runs it under
    ``trace_graphs``: the windows after the third replay a CUDA graph."""
    from repro_torch.serve import flatten
    b = nxt.shape[0]
    rt = Runtime(RuntimeConfig(trace_graphs=traced))
    try:
        c = clone_tree(start_cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok_obj, len_obj, c_objs = tasked_decode_loop(
            rt, model, params, c, nxt.clone(),
            torch.full((b,), s, dtype=torch.int32, device=nxt.device), steps,
            timeout=600)
        tok, lens = tok_obj.get(), len_obj.get()
        ms = (time.perf_counter() - t0) * 1e3 / steps
        # the reads above waited for the device: the caches are final
        diff = {k: int((c_objs[k].copies[0] != v).sum().item())
                for k, v in flatten(cache)}
        stats = rt.stats()
    finally:
        rt.shutdown()
    del c, tok_obj, len_obj, c_objs, rt
    r = {"ms_per_step": ms, "runtime_stats": {k: stats[k] for k in (
        "tasks", "transfers_h2d", "transfers_d2h", "transfers_d2d",
        "bytes_h2d", "bytes_d2h", "prefetch_hits", "prefetch_misses",
        "graphs_traced", "graph_replays", "graph_invalidations",
        "replayed_tasks")}}
    what = "traced tasked" if traced else "tasked"
    check(np.array_equal(tok, out[:, -1:].cpu().numpy()),
          f"{what} decode's last tokens {tok.ravel().tolist()} != "
          f"Engine's {out[:, -1].tolist()}")
    check(bool((lens == s + steps).all()), f"{what} lengths {lens}")
    check(not any(diff.values()), f"{what} cache differs from the "
          f"Engine's at {diff} elements")
    if traced:
        check(stats["graph_replays"] > 0 and stats["graph_invalidations"] == 0,
              f"traced tasked decode replayed no graph: {r['runtime_stats']}")
    return r


def traced_decode_trace(Runtime, RuntimeConfig, tasked_decode_loop, model,
                        params, start_cache, nxt, s, n: int = 4) -> dict:
    """Device time of ``n`` replayed decode steps: a traced loop of
    ``replay_after + 1 + n`` steps (interpreted windows, the capture, then
    n more replays) under the profiler. The window runs from the host's
    launch of the n-th last graph replay to the end of the last device
    event."""
    from torch.profiler import ProfilerActivity, profile
    b = nxt.shape[0]
    rt = Runtime(RuntimeConfig(trace_graphs=True))
    try:
        c = clone_tree(start_cache)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tok_obj, _, _ = tasked_decode_loop(
                rt, model, params, c, nxt.clone(),
                torch.full((b,), s, dtype=torch.int32, device=nxt.device),
                rt.cfg.replay_after + 1 + n, timeout=600)
            tok_obj.get()
    finally:
        rt.shutdown()
    del c, tok_obj, rt
    launches = sorted(e.time_range.start for e in prof.events()
                      if e.name == "cudaGraphLaunch")
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(launches) < n or not dev:
        return {"device_trace": "not measured",
                "graph_launches_traced": len(launches)}
    lo, hi = launches[-n], max(e for _, _, e in dev)
    busy = _busy_us(dev, lo, hi)
    # idle between consecutive device events: gaps under 20 us are the
    # device's own launch latency between the graph's kernels, longer ones
    # wait for the host
    short = long_ = 0.0
    end = lo
    inside = sorted((a, b) for _, a, b in dev if b > lo and a < hi)
    for a, b in inside:
        if a > end:
            if a - end < 20.0:
                short += a - end
            else:
                long_ += a - end
        end = max(end, b)
    return {"steps": n, "span_ms": (hi - lo) / 1e3,
            "ms_per_step": (hi - lo) / 1e3 / n,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (hi - lo),
            "kernels_per_step": len(inside) / n,
            "idle_in_gaps_under_20us_ms": short / 1e3,
            "idle_in_longer_gaps_ms": long_ / 1e3}


def traced_jacobi(ops, run_tasked, Runtime, RuntimeConfig, u0, interp,
                  want) -> dict:
    """Phase 4b: ``run_tasked`` under ``trace_graphs`` at the main path's
    size. Sweeps 1-3 run interpreted and compile the window; sweep 4
    captures it as a CUDA graph, and every later sweep replays it. It must
    equal the interpreted run and ``run_reference`` bit for bit and launch
    the stencil as often; then a profiled run gives its steady sweeps."""
    rt = Runtime(RuntimeConfig(trace_graphs=True))
    try:
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        got = run_tasked(u0, JACOBI_ITERS, rt, over_decomposition=JACOBI_OD)
        wall_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        stats = rt.stats()
        replay_after = rt.cfg.replay_after
    finally:
        rt.shutdown()
    n_diff = int(np.count_nonzero(got != interp))
    check(n_diff == 0 and np.array_equal(got, want),
          f"traced run_tasked differs from the interpreted run at {n_diff} "
          f"points (and from run_reference: {not np.array_equal(got, want)})")
    check(stats["graph_replays"] >= JACOBI_ITERS - replay_after - 1,
          f"traced run_tasked replayed {stats['graph_replays']} windows")
    check(launches["jacobi3d_faces"] == JACOBI_OD * JACOBI_ITERS,
          f"traced run_tasked launched jacobi3d_faces "
          f"{launches['jacobi3d_faces']} times, not "
          f"{JACOBI_OD * JACOBI_ITERS}")
    del got, rt
    gc.collect()
    trace = sweep_trace(run_tasked, Runtime, RuntimeConfig, u0, traced=True)
    return {"wall_s": wall_s, "launches": launches,
            "equal_to_interpreted_and_reference": True,
            "runtime_stats": {k: stats[k] for k in (
                "tasks", "graphs_traced", "graph_replays",
                "graph_invalidations", "replayed_tasks")},
            "trace": trace}


def cluster_phase(ops, run_reference, RuntimeConfig, u0) -> dict:
    """Phase 7: ``run_cluster`` over a ``Cluster(4)`` whose ranks share the
    card: slabs of 192 x 768 x 768 scattered and gathered on rendezvous
    streams, halo planes put DIRECT, each update the ``jacobi3d_faces``
    kernel. Run with 0 iterations (scatter and gather alone, which must
    return the domain bit for bit) and with 10, which must equal
    ``run_reference``; the difference of the two walls over 10 is the
    wall time of one iteration."""
    from repro_torch.apps.jacobi3d import run_cluster
    from repro_torch.distributed import Cluster
    n_ranks = 4
    want = run_reference(u0, JACOBI_ITERS, device="cuda")
    out = {"ranks": n_ranks, "shape": list(u0.shape),
           "iterations": JACOBI_ITERS}
    walls = {}
    for iters in (0, JACOBI_ITERS):
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        with Cluster(n_ranks, RuntimeConfig()) as c:
            t0 = time.perf_counter()
            got = run_cluster(u0, iters, c)
            walls[iters] = time.perf_counter() - t0
            stats = [dict(r.stats) for r in c.ranks]
        ref = u0 if iters == 0 else want
        n_diff = int(np.count_nonzero(got != ref))
        check(n_diff == 0, f"run_cluster ({iters} iterations) differs from "
              f"{'the domain' if iters == 0 else 'run_reference'} at "
              f"{n_diff} points")
        check(ops.LAUNCHES["jacobi3d_faces"] == n_ranks * iters,
              f"run_cluster launched jacobi3d_faces "
              f"{ops.LAUNCHES['jacobi3d_faces']} times, not "
              f"{n_ranks * iters}")
        del got
        gc.collect()
    out.update({
        "wall_s": walls[JACOBI_ITERS], "scatter_gather_wall_s": walls[0],
        "ms_per_iteration": (walls[JACOBI_ITERS] - walls[0]) * 1e3
        / JACOBI_ITERS,
        "equal_to_reference": True,
        "per_rank": [{k: s[k] for k in (
            "bytes_d2d", "bytes_staged", "eager", "rendezvous",
            "chunks_out", "chunks_in", "max_window")} for s in stats],
        "rendezvous_streams": sum(s["rendezvous"] for s in stats)})
    del want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def send_latency(RuntimeConfig, reps: int = 5) -> dict:
    """``Rank.send`` latency between two ranks sharing the card: host clock
    from the send to the run of the receiving handler, median of ``reps``
    after two warm-up sends, at 8 B, 64 KB and 64 MB, over the DIRECT path
    (a payload resident on the card, snapshotted and landed on the card)
    and the host path (a host payload, which an eager message leaves in
    the receiver's host memory and a rendezvous stream lands on the card).
    The message engine's own overhead on one card, not an inter-node
    figure."""
    import threading

    from repro_torch.distributed import Cluster, handler
    arrived = threading.Event()

    @handler(name="smoke_ping")
    def _ping(ctx, obj):
        arrived.set()

    out = {}
    with Cluster(2, RuntimeConfig()) as c:
        r0 = c.ranks[0]
        for nbytes in (8, 64 << 10, 64 << 20):
            for path in ("direct", "host"):
                times = []
                for i in range(reps + 2):
                    if path == "direct":
                        obj = r0.runtime.adopt_device_array(
                            torch.ones(nbytes // 4, device="cuda"), 0)
                    else:
                        obj = r0.runtime.hetero_object(
                            np.ones(nbytes // 4, np.float32))
                    before = dict(r0.stats)
                    arrived.clear()
                    t0 = time.perf_counter()
                    r0.send(1, "smoke_ping", obj, path=path)
                    check(arrived.wait(120), f"send of {nbytes} B over "
                          f"{path} never reached its handler")
                    dt = time.perf_counter() - t0
                    c.barrier()
                    if i >= 2:
                        times.append(dt * 1e6)
                rdzv = r0.stats["rendezvous"] > before["rendezvous"]
                d2d = r0.stats["bytes_d2d"] > before["bytes_d2d"]
                out[f"{nbytes}B_{path}"] = {
                    "protocol": "rendezvous" if rdzv else "eager",
                    "path_taken": "direct" if d2d else "host",
                    "median_us": float(np.median(times)),
                    "min_us": float(min(times))}
    return out


def allreduce_times(RuntimeConfig) -> dict:
    """``CollectiveGroup.allreduce`` over a ``Cluster(4)`` whose ranks share
    the card, each member's contribution a tensor on the card, at
    ``COLL_BYTES`` per member in float32 and int32: host clock from the
    call to the numpy results, median of ``COLL_REPS`` after one warm-up.
    Each result must equal ``oracle_allreduce`` bit for bit and each call
    fold bytes into accumulators (``coll_bytes_reduced``)."""
    from repro_torch.distributed import Cluster, CollectiveGroup
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    with Cluster(4, RuntimeConfig()) as c:
        g = CollectiveGroup(c)
        for nbytes in COLL_BYTES:
            for dtype in (torch.float32, torch.int32):
                ins = [(torch.randn(nbytes // 4, generator=gen,
                                    device="cuda") * 1000).to(dtype)
                       for _ in range(4)]
                oracle = g.oracle_allreduce(ins)
                times, reduced = [], []
                for i in range(COLL_REPS + 1):
                    before = sum(r.stats["coll_bytes_reduced"]
                                 for r in c.ranks)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    outs = g.allreduce(ins)
                    dt = (time.perf_counter() - t0) * 1e3
                    n_bad = sum(int(np.count_nonzero(o != w))
                                for o, w in zip(outs, oracle))
                    check(n_bad == 0, f"allreduce of {nbytes} B {dtype} "
                          f"differs from its oracle at {n_bad} elements")
                    reduced.append(sum(r.stats["coll_bytes_reduced"]
                                       for r in c.ranks) - before)
                    check(reduced[-1] > 0, f"allreduce of {nbytes} B "
                          "reduced no bytes")
                    if i:
                        times.append(dt)
                out[f"{nbytes}B_{str(dtype).split('.')[-1]}"] = {
                    "arm": "tree" if nbytes <= g.cutover_bytes else "ring",
                    "median_ms": float(np.median(times)),
                    "min_ms": min(times), "bytes_reduced": reduced[-1],
                    "bit_exact": True}
        out["group"] = g.describe()
    return out


def reference_residuals(ops, u0: np.ndarray, iters: int, every: int):
    """``(iteration, ||u_k - u_(k-1)||_2)`` every ``every`` iterations of the
    plain stencil (``run_reference``'s loop) on the card, each a float64
    sum over the whole domain."""
    u = torch.from_numpy(u0).cuda()
    x, y, z = u.shape
    zeros = {d: torch.zeros(d, dtype=u.dtype, device=u.device)
             for d in ((y, z), (x, z), (x, y))}
    out = []
    for k in range(1, iters + 1):
        new = ops.jacobi3d_faces_plain(
            u, zeros[(y, z)], zeros[(y, z)], zeros[(x, z)], zeros[(x, z)],
            zeros[(x, y)], zeros[(x, y)])
        if k % every == 0:
            out.append((k, math.sqrt(
                torch.sum((new.double() - u.double()) ** 2).item())))
        u = new
    return out


def residual_phase(ops, run_reference, RuntimeConfig, u0) -> dict:
    """``run_cluster(residual_every=RESIDUAL_EVERY)`` at 768^3 over a
    ``Cluster(4)`` on the card: equal to ``run_reference`` bit for bit, one
    stencil launch per rank and iteration, and its residuals within
    ``RESIDUAL_RTOL`` of float64 residuals of the reference's iterates."""
    from repro_torch.apps.jacobi3d import run_cluster
    from repro_torch.distributed import Cluster
    res = []
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    with Cluster(4, RuntimeConfig()) as c:
        t0 = time.perf_counter()
        got = run_cluster(u0, RESIDUAL_ITERS, c,
                          residual_every=RESIDUAL_EVERY, residuals=res)
        wall = time.perf_counter() - t0
    del c
    launches = ops.LAUNCHES["jacobi3d_faces"]
    check(launches == 4 * RESIDUAL_ITERS, f"run_cluster with the residual "
          f"launched jacobi3d_faces {launches} times, not "
          f"{4 * RESIDUAL_ITERS}")
    want = run_reference(u0, RESIDUAL_ITERS, device="cuda")
    n_diff = int(np.count_nonzero(got != want))
    check(n_diff == 0, f"run_cluster with the residual differs from "
          f"run_reference at {n_diff} points")
    del got, want
    ref = reference_residuals(ops, u0, RESIDUAL_ITERS, RESIDUAL_EVERY)
    check([k for k, _ in res] == [k for k, _ in ref],
          f"residual iterations {res} against {ref}")
    rel = [abs(a - b) / b for (_, a), (_, b) in zip(res, ref)]
    check(max(rel) <= RESIDUAL_RTOL, f"residuals {res} differ from the "
          f"float64 reference {ref} by {max(rel)} (relative)")
    return {"ranks": 4, "iterations": RESIDUAL_ITERS,
            "residual_every": RESIDUAL_EVERY, "residuals": res,
            "reference_residuals": ref, "max_rel_err": max(rel),
            "tol_rel": RESIDUAL_RTOL, "wall_s": wall,
            "launches": launches, "equal_to_reference": True}


def elastic_phase(ops, run_reference, RuntimeConfig, u0) -> dict:
    """``run_cluster_elastic`` at 768^3 float32, ``ELASTIC_SLABS`` slabs
    over a ``Cluster(4)`` on the card, ``ELASTIC_ITERS`` iterations:
    unfaulted, under a long heartbeat timeout that lets it measure its
    longest heartbeat gap; a rank killed after iteration 1 and revived
    after 2 with a checkpoint; a rank killed with replicas; a rank frozen.
    Each run equals the unfaulted one bit for bit, which equals
    ``run_reference``, with exactly one stencil launch per slab and
    iteration. An iteration's time is the run's own
    (``report["iteration_s"]``, from its first halo put to its commit and
    fault schedule). The device memory still allocated after the clusters
    close must be within ``MEMORY_SLACK`` of what it was before them."""
    from repro_torch.apps.jacobi3d import run_cluster_elastic
    from repro_torch.distributed import Cluster
    want = run_reference(u0, ELASTIC_ITERS, device="cuda")
    gc.collect()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    straggler_gap = STRAGGLER_FACTOR * HB_INTERVAL
    out = {"slabs": ELASTIC_SLABS, "ranks": 4, "iterations": ELASTIC_ITERS,
           "heartbeat_interval_s": HB_INTERVAL,
           "straggler_factor": STRAGGLER_FACTOR, "runs": {}}

    def run(name, ref, what, **knobs):
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        with Cluster(4, RuntimeConfig()) as c:
            t0 = time.perf_counter()
            got, rep = run_cluster_elastic(
                u0, ELASTIC_ITERS, c, slabs=ELASTIC_SLABS,
                heartbeat_interval_s=HB_INTERVAL,
                straggler_factor=STRAGGLER_FACTOR, **knobs)
            wall = time.perf_counter() - t0
        del c
        launches = ops.LAUNCHES["jacobi3d_faces"]
        n_diff = int(np.count_nonzero(got != ref))
        check(n_diff == 0, f"run_cluster_elastic {name} differs from "
              f"{what} at {n_diff} points")
        check(launches == ELASTIC_SLABS * ELASTIC_ITERS,
              f"run_cluster_elastic {name} launched jacobi3d_faces "
              f"{launches} times, not {ELASTIC_SLABS * ELASTIC_ITERS}")
        e = rep["elastic"]
        out["runs"][name] = {
            "wall_s": wall, "iteration_ms": [t * 1e3 for t in
                                             rep["iteration_s"]],
            "median_ms_per_iteration": float(np.median(
                rep["iteration_s"])) * 1e3,
            "launches": launches, "epochs": rep["epochs"],
            "heartbeat_timeout_s": knobs["heartbeat_timeout_s"],
            **{k: e[k] for k in (
                "heartbeat_gap_max_s", "recoveries", "drains", "grows",
                "dead", "stragglers", "chunks_migrated", "bytes_migrated",
                "recovery_stall_s")},
            "checkpoint": rep.get("checkpoint"),
            "faults": rep.get("faults"), "integrity": rep["integrity"]}
        return got, rep

    try:
        base, rep = run("unfaulted", want, "run_reference",
                        heartbeat_timeout_s=30.0)
        del want
        check(rep["epochs"] == 0, f"the unfaulted elastic run changed the "
              f"world {rep['epochs']} times: {rep['elastic']}")
        gap = rep["elastic"]["heartbeat_gap_max_s"]
        kill_timeout = max(0.5, 3 * gap)
        check(kill_timeout < 0.8 * straggler_gap, f"the longest heartbeat "
              f"gap ({gap} s) leaves no timeout that tells a dead rank "
              f"from a straggler (gap {straggler_gap} s)")
        freeze_s = 2 * straggler_gap
        out.update(kill_timeout_s=kill_timeout, freeze_s=freeze_s,
                   freeze_timeout_s=2 * freeze_s)
        faulted = {
            "kill_revive_ckpt": dict(kill=(2, 1), revive_at=(2, 2),
                                     ckpt_dir=ckpt_dir,
                                     heartbeat_timeout_s=kill_timeout),
            "kill_replicate": dict(kill=(2, 1), replicate=True,
                                   heartbeat_timeout_s=kill_timeout),
            "freeze": dict(freeze=(1, 1, freeze_s),
                           heartbeat_timeout_s=2 * freeze_s)}
        for name, knobs in faulted.items():
            got, rep = run(name, base, "the unfaulted run", **knobs)
            del got
            e = rep["elastic"]
            if name == "freeze":
                check(e["drains"] >= 1 and e["dead"] == [], f"{name}: {e}")
            else:
                check(e["recoveries"] == 1 and e["dead"] == [2]
                      and e["grows"] == int("revive_at" in knobs),
                      f"{name}: {e}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    del base
    gc.collect()
    mem1 = torch.cuda.memory_allocated()
    out.update(peak_device_gb=torch.cuda.max_memory_allocated() / 1e9,
               allocated_before_mb=mem0 / 2**20,
               allocated_after_mb=mem1 / 2**20)
    check(abs(mem1 - mem0) <= MEMORY_SLACK, f"device memory allocated "
          f"{mem0} B before the elastic clusters and {mem1} B after")
    return out


def spmd_phase(ops, run_reference, u0, cluster_ms: float) -> dict:
    """Phase 9: ``run_spmd`` at 768^3 over a mesh of ``SPMD_SHARDS`` shards
    that share the card (slabs of 192 x 768 x 768, each shard on its own
    stream), in both schedules: each run equal to ``run_reference`` bit for
    bit with one ``jacobi3d_faces`` launch a shard and iteration. Then each
    schedule's step timed over ``SPMD_TIMED`` steady iterations after a
    warm-up one (host clock, synchronised), a profiled window of them
    (device busy, idle share, stencil time), beside ``run_cluster``'s ms an
    iteration from phase 7 (``cluster_ms``). Then ``seq_sharded_decode`` at
    a gemma3 global layer's decode shapes and the collectives against host
    oracles."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.apps.jacobi3d import make_spmd_step, run_spmd
    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_smoke_mesh
    dev = torch.device("cuda")
    n = SPMD_SHARDS
    mesh = make_smoke_mesh(n, 1, devices=[dev] * n)
    want = run_reference(u0, JACOBI_ITERS, device="cuda")
    out = {"shards": n, "devices": [str(d) for d in mesh.devices],
           "shape": list(u0.shape), "iterations": JACOBI_ITERS,
           "run_cluster_ms_per_iteration": cluster_ms, "schedules": {}}
    for bulk in (False, True):
        name = "bulk_sync" if bulk else "overlapped"
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        got = run_spmd(u0, JACOBI_ITERS, mesh, bulk_sync=bulk)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        n_diff = int(np.count_nonzero(got != want))
        check(n_diff == 0, f"run_spmd ({name}) differs from run_reference "
              f"at {n_diff} points")
        check(launches["jacobi3d_faces"] == n * JACOBI_ITERS,
              f"run_spmd ({name}) launched jacobi3d_faces "
              f"{launches['jacobi3d_faces']} times, not {n * JACOBI_ITERS}")
        del got
        # steady steps on the card, outside the counted run
        step = make_spmd_step(mesh, bulk_sync=bulk)
        u = spmd.device_put(torch.from_numpy(u0).to(dev), mesh,
                            spmd.P("data"))
        u = step(u)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPMD_TIMED):
            u = step(u)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / SPMD_TIMED
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                u = step(u)
            torch.cuda.synchronize()
        trace = _trace_summary(prof, "jacobi3d_faces")
        del u, step
        out["schedules"][name] = {
            "wall_s": wall, "launches": launches["jacobi3d_faces"],
            "equal_to_reference": True, "ms_per_iteration": ms,
            "trace_5_steps": trace}
    del want
    gc.collect()
    torch.cuda.empty_cache()
    out["seq_sharded_decode"] = seq_decode_check(mesh)
    out["collectives"] = collective_checks(mesh)
    return out


def seq_decode_check(mesh) -> dict:
    """``seq_sharded_decode`` over ``mesh`` at a gemma3 global layer's
    decode shapes against ``decode_attention``, in float32 and bf16, each
    request's valid slots ending inside a shard; times by CUDA events."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.sharding import use_sharding
    cfg = get_config(GEMMA_ARCH)
    dev = torch.device("cuda")
    b, t = GEMMA_BATCH, GEMMA_PROMPT + GEMMA_STEPS
    kh, g, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    q = torch.randn((b, kh, g, d), generator=gen, device=dev)
    k, v = (torch.randn((b, t, kh, d), generator=gen, device=dev)
            for _ in range(2))
    pos = torch.tensor(SEQ_DECODE_LENGTHS, device=dev)
    valid = torch.arange(t, device=dev)[None, :] <= pos[:, None]
    shard_t = t // mesh.shape["data"]
    check(all(p % shard_t not in (0, shard_t - 1)
              for p in SEQ_DECODE_LENGTHS), "valid must end inside a shard")
    out = {"q": [b, kh, g, d], "cache": [b, t, kh, d],
           "shards": mesh.shape["data"], "lengths": SEQ_DECODE_LENGTHS}
    for arm, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = [x.to(dtype) for x in (q, k, v)]
        want = A.decode_attention(*args, valid=valid).float()
        with use_sharding(mesh):
            got = A.seq_sharded_decode(*args, valid=valid, axis="data")
            sharded_ms = time_ms(lambda: A.seq_sharded_decode(
                *args, valid=valid, axis="data"), 5)
        got = got.float()
        err = (got - want).abs().max().item()
        tol = SEQ_DECODE_TOL[arm]
        check(bool(torch.isfinite(got).all()) and bool(torch.allclose(
            got, want, rtol=tol, atol=tol)), f"seq_sharded_decode {arm} "
            f"outside {tol} of decode_attention (max err {err})")
        out[arm] = {"max_abs_err": err, "tol": tol, "sharded_ms": sharded_ms,
                    "plain_ms": time_ms(lambda: A.decode_attention(
                        *args, valid=valid), 5)}
    return out


def collective_checks(mesh) -> dict:
    """``ring_permute`` (both ways), ``halo_exchange_1d``, ``spmd_put`` and
    ``spmd_get`` over ``mesh`` on 4 MB a shard, bit for bit against numpy
    oracles of the host copy."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import spmd
    n = mesh.shape["data"]
    rows = 1024
    x = np.random.default_rng(SEED + 9).standard_normal(
        (n * rows, 1024)).astype(np.float32)
    blocks = [x[i * rows:(i + 1) * rows] for i in range(n)]
    zero = np.zeros_like(blocks[0][:1])
    cases = {
        "ring_permute+1": (lambda a: C.ring_permute(a, "data", 1),
                           [blocks[(i - 1) % n] for i in range(n)]),
        "ring_permute-1": (lambda a: C.ring_permute(a, "data", -1),
                           [blocks[(i + 1) % n] for i in range(n)]),
        "halo_exchange_1d": (
            lambda a: torch.cat(C.halo_exchange_1d(a, "data")),
            [np.concatenate([zero if i == 0 else blocks[i - 1][-1:],
                             zero if i == n - 1 else blocks[i + 1][:1]])
             for i in range(n)]),
        "spmd_put": (lambda a: C.spmd_put(a, "data", 1, n - 1),
                     blocks[:n - 1] + [blocks[1]]),
        "spmd_get": (lambda a: C.spmd_get(a, "data", 2), [blocks[2]] * n),
    }
    xt = torch.from_numpy(x).cuda()
    out = {"bytes_a_shard": blocks[0].nbytes}
    for name, (body, oracle) in cases.items():
        got = spmd.shard_map(body, mesh, spmd.P("data"),
                             spmd.P("data"))(xt).full("cpu").numpy()
        n_diff = int(np.count_nonzero(got != np.concatenate(oracle)))
        check(n_diff == 0, f"{name} differs from its oracle at {n_diff} "
              f"elements")
        out[name] = "bit_exact"
    return out


def layers_of(arch: str, kind: str, n_layers: Optional[int] = None) -> int:
    """The number of ``kind`` layers in ``arch``'s configuration (cut to
    its first ``n_layers`` where given)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return sum(cfg.layer_pattern[i % len(cfg.layer_pattern)] == kind
               for i in range(n_layers or cfg.n_layers))


def attention_layers(arch: str, n_layers: Optional[int] = None) -> int:
    """The self-attention layers of ``arch`` (global and local; an
    encoder-decoder's decoder layers), each one ``decode_attention``
    launch a decode step with a bf16 cache on the card."""
    return layers_of(arch, "global_attn", n_layers) + \
        layers_of(arch, "local_attn", n_layers)


def window_share(arch: str, window_ms: float, prefill_ms: float) -> float:
    """The share of a prefill that its local layers' window path takes:
    their number times one window call's time at the prefill's shapes
    (phase 2's window row), over the prefill's time."""
    return layers_of(arch, "local_attn") * window_ms / prefill_ms


def prefill_vs_plain(model, params, tokens, extra, tol: float,
                     flag: str) -> dict:
    """The prefill's final hidden state through the kernel against the same
    prefill with the kernel ``flag`` off (the plain path). For an MoE
    model the checked plain prefill takes the kernel prefill's experts
    (``routed``); the plain prefill on its own routing is reported beside
    it."""
    import dataclasses
    from repro_torch.models import build_model
    batch = {**extra, "tokens": tokens}
    off = build_model(model.cfg, dataclasses.replace(model.flags,
                                                     **{flag: False}))
    r = {}
    if model.cfg.moe is None:
        x_on, _ = model.apply(params, batch, mode="prefill")
        x_off, _ = off.apply(params, batch, mode="prefill")
    else:
        with routed() as rec:
            x_on, _ = model.apply(params, batch, mode="prefill")
        x_own, _ = off.apply(params, batch, mode="prefill")
        r["own_routing_rel_l2"] = ((x_on.float() - x_own.float()).norm()
                                   / x_own.float().norm()).item()
        del x_own
        with routed(rec["idx"]) as pinned:
            x_off, _ = off.apply(params, batch, mode="prefill")
        r["rows_differing_in_top_k"] = pinned["flips"]
        r["rows"] = pinned["rows"]
        del rec, pinned
    x_on, x_off = x_on.float(), x_off.float()
    check(bool(torch.isfinite(x_on).all()), "non-finite prefill hidden state")
    rel = ((x_on - x_off).norm() / x_off.norm()).item()
    check(rel <= tol, f"prefill hidden state through the kernel is {rel} "
          f"(relative L2) from the plain path, above {tol} "
          f"({model.flags.param_dtype})")
    r.update(rel_l2=rel, max_abs=(x_on - x_off).abs().max().item(),
             tol_rel_l2=tol)
    return r


# ---------------------------------------------------------------------------
# phases 16-18: training (yi-9b at full width)
# ---------------------------------------------------------------------------

def train_model(layers: Optional[int], dtype=torch.bfloat16,
                arch: str = TRAIN_ARCH):
    """``arch`` (yi-9b by default) at full width, cut to ``layers`` layers
    (None: the config's depth), with ``DEFAULT_FLAGS`` in ``dtype`` (remat
    "dots", loss chunks of 1024)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import DEFAULT_FLAGS, build_model
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return build_model(cfg, dataclasses.replace(DEFAULT_FLAGS,
                                                param_dtype=dtype))


def train_batch(cfg, step: int, dev, batch: int = TRAIN_BATCH,
                seq: int = TRAIN_SEQ) -> dict:
    """``SyntheticLM``'s batch ``step`` at [batch, seq] on the card, as
    ``launch.train`` feeds it; an encoder-decoder's frames seeded at
    ``FRAME_SCALE`` (the driver's are zeros)."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.train import batch_on
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=SEED))
    out = batch_on(data, step, cfg, dev)
    if cfg.enc_dec:
        gen = torch.Generator(device=dev).manual_seed(SEED + 1 + step)
        out["frames"] = FRAME_SCALE * torch.randn(
            out["frames"].shape, device=dev, generator=gen)
    return out


def train_opt():
    from repro_torch.train import AdamWConfig
    return AdamWConfig(**TRAIN_OPT)


def fresh_state(model, dev):
    from repro_torch.train import init_train_state
    return init_train_state(model, torch.Generator(device=dev)
                            .manual_seed(SEED), dev)


def _tree_bytes(tree) -> int:
    from repro_torch.train.optimizer import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def train_memory_model(n_params: int, layers: int) -> dict:
    """My arithmetic (GB) of phase 16's state and activations, from the
    shapes: 16 B a parameter (bf16 weight and gradient, float32 master, m
    and v), 4 more for the float32 accumulator at od > 1; under remat
    "dots" a layer keeps its input and its products' outputs without batch
    dims (q, k, v, the output projection, the MLP's three), bf16 over
    B x S tokens; one layer's blockwise attention recomputed in the
    backward (10 causal 512 x 512 tiles of [B*KH, 512*G, 512] float32, ~3
    tensors a tile); one loss chunk's float32 logits, ~4 copies."""
    tok = TRAIN_BATCH * TRAIN_SEQ
    d, f, hd = 4096, 11008, 32 * 128
    kv = 4 * 128
    saved = tok * 2 * (d + hd + 2 * kv + d + 2 * f + d)
    tiles = 10 * 3 * (TRAIN_BATCH * 4) * (512 * 8) * 512 * 4
    logits = 4 * TRAIN_BATCH * 1024 * 64000 * 4
    return {"state_with_grads_gb": 16 * n_params / 1e9,
            "accumulator_gb": 4 * n_params / 1e9,
            "saved_activations_gb": layers * saved / 1e9,
            "recompute_attention_gb": tiles / 1e9,
            "loss_chunk_gb": logits / 1e9}


def grad_cosines(model, params, batch) -> dict:
    """Phase 16's gradients at step 0: each gradient leaf of the bf16
    model against a float32 recomputation on the card (the same weights
    upcast, the same batch): the cosine of the two, flattened, which
    ``train_phase`` holds to ``TRAIN_COS_MIN``."""
    from repro_torch.train import make_grad_fn
    from repro_torch.train.optimizer import tree_flatten, tree_map
    g16, m16 = make_grad_fn(model)(params, batch)
    torch.cuda.synchronize()
    model32 = train_model(model.cfg.n_layers, torch.float32)
    p32 = tree_map(lambda p: p.float(), params)
    g32, m32 = make_grad_fn(model32)(p32, batch)
    del p32
    cos = {}
    for (k, a), (_, b) in zip(tree_flatten(g16), tree_flatten(g32)):
        a = a.float().flatten()
        b = b.flatten()
        cos["/".join(k)] = float(torch.dot(a, b) / (a.norm() * b.norm())
                                 .clamp_min(1e-30))
        del a
    out = {"ce_bf16": float(m16["ce"]), "ce_f32": float(m32["ce"]),
           "min_cosine": min(cos.values()), "cosine": cos,
           "f32_layers": model.cfg.n_layers}
    del g16, g32
    return out


def od_check(model, batch, dev) -> dict:
    """Phase 16's over-decomposition numbers: one step at od=1 and one at
    od=4 from the same fresh state on one batch; ``train_phase`` holds
    ce within ``TRAIN_OD_CE_TOL``, the gradient norm within
    ``TRAIN_OD_GN_TOL`` relative, the first moments after the step (0.1
    x the clipped gradient, float32) within ``TRAIN_OD_M_TOL`` relative
    L2, and the share of updated parameters more than 2 bf16 ulps apart
    to ``TRAIN_OD_SHARE_MAX``."""
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.optimizer import tree_leaves, tree_map
    out = {}
    state = fresh_state(model, dev)
    state, m1 = make_train_step(model, TrainConfig(
        opt=train_opt(), over_decompose=1))(state, batch)
    p1 = state.params
    mom1 = tree_map(lambda m: m.to(torch.bfloat16), state.opt.m)
    del state
    gc.collect()
    state = fresh_state(model, dev)
    torch.cuda.reset_peak_memory_stats()
    state, m4 = make_train_step(model, TrainConfig(
        opt=train_opt(), over_decompose=TRAIN_OD))(state, batch)
    out["od4_step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    num = den = 0.0
    beyond, total = 0, 0
    for a, b, ma, mb in zip(tree_leaves(p1), tree_leaves(state.params),
                            tree_leaves(mom1), tree_leaves(state.opt.m)):
        num += float((ma.float() - mb).square().sum())
        den += float(mb.square().sum())
        a32, b32 = a.float(), b.float()
        ulp = torch.maximum(a32.abs(), b32.abs()) * 2.0 ** -7
        diff = (a32 - b32).abs()
        beyond += int((diff > 2 * ulp).sum())
        total += diff.numel()
        del a32, b32, ulp, diff
    m_rel = (num / max(den, 1e-30)) ** 0.5
    out.update({"ce_od1": float(m1["ce"]), "ce_od4": float(m4["ce"]),
                "share_beyond_2_ulps": beyond / total,
                "first_moment_rel_l2": m_rel,
                "grad_norm_od1": float(m1["grad_norm"]),
                "grad_norm_od4": float(m4["grad_norm"])})
    del state, p1, mom1
    return out


def _kernel_kind(name: str) -> str:
    """A CUDA kernel's kind by its name: the products (cuBLAS's ``nvjet``,
    CUTLASS and gemm kernels), elementwise, reductions, copies."""
    low = name.lower()
    if any(k in low for k in ("nvjet", "gemm", "cutlass", "xmma")):
        return "gemm"
    if "elementwise" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def train_phase(ops, card: str) -> dict:
    """Phase 16 (T1): yi-9b at full width with ``TRAIN_LAYERS`` layers,
    bf16 weights from a seed, trained by ``make_train_step`` on batches of
    [4, 2048] from ``SyntheticLM``: the gradient check against float32,
    od=4 against od=1, then ``TRAIN_STEPS`` steps on one repeated batch
    (every loss finite, step 0's within 0.5 of ln V, falling every step,
    no hand-written kernel launched) with their times, and one more step
    traced, its two halves (gradients, update) timed and its kernels
    summed by kind."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.train import (TrainConfig, adamw_update, make_grad_fn,
                                   make_train_step)
    from repro_torch.train.optimizer import tree_leaves
    dev = torch.device("cuda")
    gc.collect()
    mem0 = allocated_without_workspaces()
    check(mem0 < MEMORY_BEFORE_SERVE, f"phase 16: {mem0} B still "
          f"allocated on the card before the weights load")
    model = train_model(TRAIN_LAYERS)
    cfg = model.cfg
    batch = train_batch(cfg, 0, dev)
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    r = {"arch": cfg.name, "layers": cfg.n_layers,
         "config_layers": get_config(TRAIN_ARCH).n_layers,
         "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": model.flags.remat,
         "loss_chunk": model.flags.loss_chunk, "opt": TRAIN_OPT}
    state = fresh_state(model, dev)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    r["params"] = n_params
    r["memory_model"] = train_memory_model(n_params, cfg.n_layers)
    r["state_gb"] = (_tree_bytes(state.params) + _tree_bytes(state.opt.m)
                     + _tree_bytes(state.opt.v)
                     + _tree_bytes(state.opt.master)) / 1e9
    params = state.params
    del state
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r["gradients"] = grad_cosines(model, params, batch)
    r["gradients"]["s"] = time.perf_counter() - t0
    r["gradients"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    t0 = time.perf_counter()
    r["over_decompose"] = od_check(model, batch, dev)
    r["over_decompose"]["s"] = time.perf_counter() - t0
    gc.collect()

    # -- the timed steps: one repeated batch --
    state = fresh_state(model, dev)
    step = make_train_step(model, TrainConfig(opt=train_opt()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        losses.append(float(met["loss"]))          # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    r["launches"] = dict(ops.LAUNCHES)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["losses"] = losses
    r["grad_norm"] = float(met["grad_norm"])
    r["step_ms"] = ms
    r["ms_per_step"] = float(np.median(ms[1:]))
    r["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / r["ms_per_step"] * 1e3
    # one more step traced, as its two halves (what make_train_step runs
    # at od=1), each timed to a synchronize: the gradients, the update
    grad_fn = make_grad_fn(model)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads, _ = grad_fn(state.params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, _ = adamw_update(train_opt(), state, grads)
        del grads
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    summary = _trace_summary(prof)
    if "device_busy_ms" in summary:
        summary["step_ms"] = (t2 - t0) * 1e3
        summary["gradients_ms"] = (t1 - t0) * 1e3
        summary["adamw_ms"] = (t2 - t1) * 1e3
        summary["busy_share_of_step"] = summary["device_busy_ms"] / (
            summary["step_ms"])
        names: dict = {}
        kinds = dict.fromkeys(("gemm", "elementwise", "reduce", "copy",
                               "other"), 0.0)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms_ = (e.time_range.end - e.time_range.start) / 1e3
                n = e.name[:60]
                names[n] = names.get(n, 0.0) + ms_
                kinds[_kernel_kind(e.name)] += ms_
        summary["by_name_ms"] = {k: round(v, 3) for k, v in sorted(
            names.items(), key=lambda kv: -kv[1])[:10]}
        summary["by_kind_ms"] = kinds
    r["trace"] = summary
    del state, step, batch, prof
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train ({card}): " + json.dumps(r))
    cos, od = r["gradients"], r["over_decompose"]
    check(cos["min_cosine"] >= TRAIN_COS_MIN,
          f"phase 16: a bf16 gradient leaf's cosine with the float32 "
          f"recomputation is {cos['min_cosine']} < {TRAIN_COS_MIN}: "
          f"{sorted(cos['cosine'].items(), key=lambda kv: kv[1])[:3]}")
    check(abs(od["ce_od1"] - od["ce_od4"]) <= TRAIN_OD_CE_TOL,
          f"phase 16: ce at od=4 {od['ce_od4']} vs od=1 {od['ce_od1']}")
    check(od["first_moment_rel_l2"] <= TRAIN_OD_M_TOL,
          f"phase 16: first moments at od=4 vs od=1 differ by "
          f"{od['first_moment_rel_l2']} relative L2 > {TRAIN_OD_M_TOL}")
    check(abs(od["grad_norm_od4"] - od["grad_norm_od1"])
          <= TRAIN_OD_GN_TOL * od["grad_norm_od1"],
          f"phase 16: the gradient norm at od=4 {od['grad_norm_od4']} vs "
          f"od=1 {od['grad_norm_od1']}, relative tolerance "
          f"{TRAIN_OD_GN_TOL}")
    check(od["share_beyond_2_ulps"] <= TRAIN_OD_SHARE_MAX,
          f"phase 16: {od['share_beyond_2_ulps']} of the parameters differ "
          f"between od=4 and od=1 by more than 2 bf16 ulps > "
          f"{TRAIN_OD_SHARE_MAX}")
    check(all(math.isfinite(x) for x in losses),
          f"phase 16: non-finite loss {losses}")
    check(abs(losses[0] - math.log(cfg.vocab)) <= 0.5,
          f"phase 16: step 0's loss {losses[0]} is not within 0.5 of "
          f"ln {cfg.vocab} = {math.log(cfg.vocab)}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"phase 16: the loss on a repeated batch does not fall every "
          f"step: {losses}")
    check(not any(r["launches"].values()),
          f"phase 16: the train steps launched hand-written kernels "
          f"{r['launches']}")
    return r


def resume_phase(card: str) -> dict:
    """Phase 17 (T2): yi-9b at full width with ``RESUME_LAYERS`` layers under
    ``torch.use_deterministic_algorithms(True)``: ``RESUME_STEPS`` steps
    uninterrupted, against a run saved by the ``Checkpointer`` at step
    ``RESUME_AT``, restored into a fresh state (``abstract_train_state`` on
    the meta device, placed on the card) and continued: every loss and
    every parameter bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train import (TrainConfig, abstract_train_state,
                                   make_train_step)
    from repro_torch.train.optimizer import tree_flatten
    dev = torch.device("cuda")
    model = train_model(RESUME_LAYERS)
    step = make_train_step(model, TrainConfig(opt=train_opt()))
    batches = [train_batch(model.cfg, i, dev) for i in range(RESUME_STEPS)]
    prev_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    r = {"layers": RESUME_LAYERS, "steps": RESUME_STEPS,
         "saved_at": RESUME_AT, "deterministic": True}
    try:
        state = fresh_state(model, dev)
        straight = []
        for b in batches:
            state, met = step(state, b)
            straight.append(float(met["loss"]))
        want = [(k, v.clone()) for k, v in tree_flatten(state.params)]
        del state
        gc.collect()
        state = fresh_state(model, dev)
        resumed = []
        for b in batches[:RESUME_AT]:
            state, met = step(state, b)
            resumed.append(float(met["loss"]))
        ck = Checkpointer(ckdir, keep=1, async_save=False)
        t0 = time.perf_counter()
        ck.save(RESUME_AT, state, block=True)
        r["save_s"] = time.perf_counter() - t0
        r["checkpoint_gb"] = sum(
            os.path.getsize(os.path.join(ckdir, f"step_{RESUME_AT}", f))
            for f in os.listdir(os.path.join(ckdir, f"step_{RESUME_AT}"))
        ) / 1e9
        del state
        gc.collect()
        t0 = time.perf_counter()
        state = ck.restore_latest(abstract_train_state(model), dev)
        r["restore_s"] = time.perf_counter() - t0
        for b in batches[RESUME_AT:]:
            state, met = step(state, b)
            resumed.append(float(met["loss"]))
        same = all(torch.equal(a, v) for (_, a), (_, v) in
                   zip(tree_flatten(state.params), want))
        del state, want
    finally:
        torch.use_deterministic_algorithms(False)
        if prev_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = prev_env
        shutil.rmtree(ckdir, ignore_errors=True)
    del batches, step
    gc.collect()
    torch.cuda.empty_cache()
    r.update({"losses_uninterrupted": straight, "losses_resumed": resumed,
              "params_equal": same})
    print(f"train resume ({card}): " + json.dumps(r))
    check(straight == resumed, f"phase 17: the resumed run's losses "
          f"{resumed} are not the uninterrupted run's {straight}")
    check(same, "phase 17: the resumed run's parameters differ from the "
          "uninterrupted run's")
    return r


def compression_elastic_phase(card: str) -> dict:
    """Phase 18 (T3): ``compressed_pmean`` over ``COMPRESS_SHARDS`` mesh
    shards of the card on gradients of one yi-9b layer's shapes against
    ``compressed_mean_stacked`` on the same values (means and residuals
    within ``COMPRESS_TOL``), timed; then ``run_elastic`` on the yi-9b
    smoke config over shards of the card, 4 → 2 at step 4 of 8, against an
    uninterrupted 2-shard run: losses within ``ELASTIC_TRAIN_RTOL``."""
    from repro_torch.distributed import spmd
    from repro_torch.launch.elastic_train import run_elastic
    from repro_torch.train import compression as C
    dev = torch.device("cuda")
    n = COMPRESS_SHARDS
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    shapes = {"wq": (4096, 32, 128), "wi": (4096, 11008), "norm": (4096,)}
    xs = {k: 1e-3 * torch.randn((n,) + s, generator=gen, device=dev)
          for k, s in shapes.items()}
    res = {k: 1e-5 * torch.randn((n,) + s, generator=gen, device=dev)
           for k, s in shapes.items()}
    mesh = spmd.Mesh([dev] * n, (n,), ("pod",))

    def body(*args):
        half = len(args) // 2
        outs = [C.compressed_pmean(x[0], "pod", r[0])
                for x, r in zip(args[:half], args[half:])]
        return tuple(m[None] for m, _ in outs) + \
            tuple(nr[None] for _, nr in outs)

    names = sorted(shapes)
    run = spmd.shard_map(body, mesh, in_specs=(spmd.P("pod"),) * 6,
                         out_specs=(spmd.P("pod"),) * 6)
    args = [xs[k] for k in names] + [res[k] for k in names]
    out = run(*args)
    r = {"shards": n, "shapes": {k: list(shapes[k]) for k in names}}
    worst = 0.0
    for i, k in enumerate(names):
        wm, wr = C.compressed_mean_stacked(xs[k], res[k])
        for s in out[i].shards:
            worst = max(worst, float((s[0] - wm).abs().max()))
        worst = max(worst, float((out[3 + i].full() - wr).abs().max()))
    r["max_abs_err"] = worst
    r["mesh_ms"] = time_ms(lambda: [o.full() for o in run(*args)], 3, 1)
    r["stacked_ms"] = time_ms(lambda: [C.compressed_mean_stacked(
        xs[k], res[k]) for k in names], 3, 1)
    del xs, res, out, args, run, mesh
    gc.collect()
    t0 = time.perf_counter()
    el, worlds = run_elastic(steps=8, fail_at=4, devices=[dev] * 4)
    r["elastic_s"] = time.perf_counter() - t0
    ref, ref_worlds = run_elastic(steps=8, fail_at=8, devices=[dev] * 2)
    err = float(np.max(np.abs(np.array(el) - np.array(ref))
                       / np.abs(np.array(ref))))
    r.update({"elastic_losses": el, "elastic_worlds": worlds,
              "uninterrupted_losses": ref, "max_rel_err": err,
              "rtol": ELASTIC_TRAIN_RTOL})
    gc.collect()
    torch.cuda.empty_cache()
    print(f"train compression and elastic ({card}): " + json.dumps(r))
    check(worst <= COMPRESS_TOL, f"phase 18: compressed_pmean over {n} "
          f"shards vs compressed_mean_stacked: {worst} > {COMPRESS_TOL}")
    check(worlds == [4] * 4 + [2] * 4 and ref_worlds == [2] * 8,
          f"phase 18: worlds {worlds}, {ref_worlds}")
    check(err <= ELASTIC_TRAIN_RTOL, f"phase 18: elastic losses {el} vs "
          f"uninterrupted {ref}: relative {err} > {ELASTIC_TRAIN_RTOL}")
    return r


# ---------------------------------------------------------------------------
# phase 20: training on a mesh of shards of the card
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def watchdog(seconds: float, what: str):
    """While open, a timer that ends the process with a message after
    ``seconds``: a phase that hangs fails instead of holding the run."""
    def expire():
        print(f"chip_smoke: {what} did not end within {seconds:.0f} s",
              file=sys.stderr, flush=True)
        os._exit(3)

    timer = threading.Timer(seconds, expire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def state_shares(state, mesh) -> dict:
    """Each shard's bytes of a placed ``TrainState`` (GB, its residuals
    included) and what the leaves' specs give it: a leaf's bytes over the
    shards of the axes that split it."""
    from repro_torch.train.optimizer import tree_leaves
    o = state.opt
    leaves = (tree_leaves(state.params) + tree_leaves(o.m)
              + tree_leaves(o.v) + tree_leaves(o.master) + [o.step]
              + (tree_leaves(state.ef) if state.ef is not None else []))
    held = [0] * mesh.size
    want = 0
    for x in leaves:
        n = math.prod(mesh.shape[a] for entry in x.spec if entry
                      for a in ((entry,) if isinstance(entry, str)
                                else entry))
        want += math.prod(x.shape) * x.shards[0].element_size() // n
        for i, t in enumerate(x.shards):
            held[i] += t.numel() * t.element_size()
    return {"shard_state_gb": [h / 1e9 for h in held],
            "spec_state_gb": want / 1e9}


def mesh_train_phase(ops, card: str, arch: str = TRAIN_ARCH,
                     phase: int = 20) -> dict:
    """Phase 20: phase 16's yi-9b (full width, ``TRAIN_LAYERS`` layers,
    bf16, remat "dots") on phase 16's batch, trained over
    ``make_production_mesh`` of ``MESH_TRAIN_SHARDS`` shards of the card;
    phase 22: the same for recurrentgemma-9b and whisper-large-v3, each at
    the depth and batch of its ``MESH_TRAIN_CELLS`` entry.
    The one-card gradients first (weights drawn from the seed, then
    freed, the gradients kept on the host); then the state drawn straight
    onto the mesh from the same seed (``init_train_state(..., mesh=)``:
    the same weights), its gradients held to the one card's (each leaf's
    cosine and norm, and the global norm), and
    ``MESH_TRAIN_STEPS`` steps of ``make_train_step`` on the repeated
    batch, timed, their rendezvous counted, one more traced."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_grad_fn, make_mesh_grad_fn,
                                   make_train_step)
    from repro_torch.train.optimizer import (global_norm, tree_flatten,
                                             tree_map)
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = allocated_without_workspaces()
    check(mem0 < MEMORY_BEFORE_SERVE, f"phase {phase}: {mem0} B still "
          f"allocated on the card before the weights load")
    layers, bsz, seq = MESH_TRAIN_CELLS[arch]
    model = train_model(layers, arch=arch)
    cfg = model.cfg
    batch = train_batch(cfg, 0, dev, bsz, seq)
    r = {"arch": cfg.name, "layers": cfg.n_layers, "batch": bsz,
         "seq": seq, "remat": model.flags.remat,
         "shards": MESH_TRAIN_SHARDS, "steps": MESH_TRAIN_STEPS}
    if cfg.enc_dec:
        r.update(encoder_layers=cfg.n_encoder_layers,
                 frames=cfg.encoder_seq)

    # -- the one-card step's gradients, kept on the host --
    params = tree_map(lambda p: p.detach(), model.init(
        torch.Generator(device=dev).manual_seed(SEED), dev).tree())
    g1, m1 = make_grad_fn(model)(params, batch)
    host = [(k, v.to("cpu")) for k, v in tree_flatten(g1)]
    r["one_card_loss"] = float(m1["ce"] + m1["aux"])
    r["one_card_grad_norm"] = float(global_norm(g1))
    del params, g1, m1
    gc.collect()
    torch.cuda.empty_cache()

    # -- the state drawn onto the mesh, its gradients against them --
    mesh = make_production_mesh(devices=[dev] * MESH_TRAIN_SHARDS)
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev)
                             .manual_seed(SEED), dev, mesh=mesh)
    torch.cuda.synchronize()
    r["draw_s"] = time.perf_counter() - t0
    r.update(state_shares(state, mesh))
    gm, mm = make_mesh_grad_fn(model)(state.params, batch)
    r["mesh_loss"] = float(mm["ce"] + mm["aux"])
    r["mesh_grad_norm"] = float(mm["grad_norm"])
    cos, ratio = {}, {}
    for (k, a), (_, b) in zip(host, tree_flatten(gm)):
        a = a.to(dev).float().flatten()
        b = b.full().float().flatten()
        na, nb = a.norm(), b.norm()
        cos["/".join(k)] = float(torch.dot(a, b) / (na * nb)
                                 .clamp_min(1e-30))
        ratio["/".join(k)] = float(nb / na.clamp_min(1e-30))
        del a, b
    r["min_cosine"] = min(cos.values())
    r["cosine"] = cos
    r["norm_ratio"] = ratio
    r["max_norm_ratio_err"] = max(abs(x - 1) for x in ratio.values())
    del gm, mm, host
    gc.collect()

    # -- the timed steps on the repeated batch --
    step = make_train_step(model, TrainConfig(opt=train_opt()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    losses, ms, rdv = [], [], []
    for _ in range(MESH_TRAIN_STEPS):
        with counted_rendezvous() as count:
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        rdv.append(count[0])
        losses.append(float(met["loss"]))
        r.setdefault("first_step_grad_norm", float(met["grad_norm"]))
    r["launches"] = dict(ops.LAUNCHES)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r.update(losses=losses, step_ms=ms, rendezvous_per_step=rdv,
             grad_norm=float(met["grad_norm"]),
             ms_per_step=float(np.median(ms[1:])))
    r["tokens_per_s"] = bsz * seq / r["ms_per_step"] * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    summary = _trace_summary(prof)
    if "device_busy_ms" in summary:
        summary["step_ms"] = (t1 - t0) * 1e3
        summary["busy_share_of_step"] = summary["device_busy_ms"] / (
            summary["step_ms"])
    r["trace"] = summary
    del state, step, batch, prof, met
    gc.collect()
    torch.cuda.empty_cache()
    mem1 = allocated_without_workspaces()
    r.update(allocated_at_start_mb=mem0 / 2**20,
             allocated_at_end_mb=mem1 / 2**20,
             phase_s=time.perf_counter() - t_phase)
    print(f"train {cfg.name} on a (1, {MESH_TRAIN_SHARDS}) mesh, phase "
          f"{phase} ({card}): " + json.dumps(r))
    shares = r["shard_state_gb"]
    check(all(abs(g - shares[0]) < 1e-9 for g in shares)
          and abs(sum(shares) - r["spec_state_gb"] * MESH_TRAIN_SHARDS)
          <= 1e-6 * sum(shares),
          f"phase {phase}: the shards hold {shares} GB of state, their specs "
          f"give {r['spec_state_gb']} GB each")
    check(abs(r["mesh_loss"] - r["one_card_loss"])
          <= MESH_TRAIN_LOSS_RTOL * r["one_card_loss"],
          f"phase {phase}: the mesh's first loss {r['mesh_loss']} vs one "
          f"card's {r['one_card_loss']}, relative tolerance "
          f"{MESH_TRAIN_LOSS_RTOL}")
    check(r["min_cosine"] >= TRAIN_COS_MIN,
          f"phase {phase}: a gradient leaf's cosine with the one-card "
          f"step's is {r['min_cosine']} < {TRAIN_COS_MIN}: "
          f"{sorted(cos.items(), key=lambda kv: kv[1])[:3]}")
    check(r["max_norm_ratio_err"] <= MESH_TRAIN_NORM_RTOL,
          f"phase {phase}: a gradient leaf's norm over the one-card step's is "
          f"not within {MESH_TRAIN_NORM_RTOL} of 1: "
          f"{sorted(ratio.items(), key=lambda kv: -abs(kv[1] - 1))[:3]}")
    for what in ("mesh_grad_norm", "first_step_grad_norm"):
        check(abs(r[what] - r["one_card_grad_norm"])
              <= MESH_TRAIN_NORM_RTOL * r["one_card_grad_norm"],
              f"phase {phase}: {what} {r[what]} vs one card's "
              f"{r['one_card_grad_norm']}, relative tolerance "
              f"{MESH_TRAIN_NORM_RTOL}")
    check(all(math.isfinite(x) for x in losses),
          f"phase {phase}: non-finite loss {losses}")
    check(abs(losses[0] - r["mesh_loss"]) <= 1e-5 * r["mesh_loss"],
          f"phase {phase}: the first step's loss {losses[0]} is not the "
          f"gradients' {r['mesh_loss']}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"phase {phase}: the loss on a repeated batch does not fall every "
          f"step: {losses}")
    check(not any(r["launches"].values()),
          f"phase {phase}: the train steps launched hand-written kernels "
          f"{r['launches']}")
    check(abs(mem1 - mem0) <= MEMORY_SLACK,
          f"phase {phase}: {mem1} B allocated after, {mem0} B before")
    return r


# -- phase 24: the multi-pod mesh: compressed gradients, ZeRO-1 -------------

def compressed_payload(state) -> dict:
    """Shard 0's bytes a step of ``compressed_pmean``'s all-gathers over
    ``pod`` (``compression.payload_bytes``) and of its residual blocks."""
    from repro_torch.train.compression import payload_bytes
    from repro_torch.train.optimizer import tree_leaves
    q, scales = payload_bytes(state.params)
    res = sum(r.shards[0].numel() * 4 for r in tree_leaves(state.ef))
    return {"int8_bytes": q, "scale_bytes": scales,
            "residual_bytes_a_shard": res}


def multipod_reference(model, batches, dev) -> dict:
    """Phase 24's oracle: the seeded state on one card without a mesh,
    ``MULTIPOD_STEPS`` steps, each pod's gradient (of its half of the
    batch) through ``compressed_mean_stacked_tree``, then AdamW: the
    metrics of each step; on the host the drawn parameters, the first
    batch's gradient (uncompressed, the whole batch), the scales of each
    pod's 256-blocks in the first step and the state after each
    step."""
    from repro_torch.train import init_train_state, make_grad_fn
    from repro_torch.train.compression import (compressed_mean_stacked_tree,
                                               quantize_int8)
    from repro_torch.train.optimizer import (adamw_update, global_norm,
                                             tree_map)
    pods = MULTIPOD_MESH[0]
    state = init_train_state(model, torch.Generator(device=dev)
                             .manual_seed(SEED), dev, ef_pods=pods)

    def host(tree):
        return tree_map(lambda t: t.to("cpu", copy=True), tree)
    grad_fn = make_grad_fn(model)
    out = {"params0": host(state.params),
           "grads0": host(grad_fn(state.params, batches[0])[0]),
           "losses": [], "grad_norms": [], "states": []}
    half = MULTIPOD_BATCH // pods
    def block_scales(g, r):
        x = g.float() + r
        return quantize_int8(x[:, None] if x.dim() == 1 else x)[1].cpu()
    for i, batch in enumerate(batches):
        per = [grad_fn(state.params, {k: v[p * half:(p + 1) * half]
                                      for k, v in batch.items()})
               for p in range(pods)]
        out["losses"].append(sum(float(m["ce"] + m["aux"])
                                 for _, m in per) / pods)
        stacked = tree_map(lambda *g: torch.stack(g), *[g for g, _ in per])
        del per
        if i == 0:
            out["scales0"] = tree_map(block_scales, stacked, state.ef)
        mean, state.ef = compressed_mean_stacked_tree(stacked, state.ef)
        del stacked
        out["grad_norms"].append(float(global_norm(mean)))
        state, _ = adamw_update(train_opt(), state, mean)
        del mean
        o = state.opt
        out["states"].append({"params": host(state.params), "m": host(o.m),
                              "v": host(o.v), "master": host(o.master),
                              "ef": host(state.ef)})
    del state, o
    gc.collect()
    torch.cuda.empty_cache()
    return out


def residual_ties(placed, ref, scales, dev) -> dict:
    """Phase 24's first-step check: each residual element of the mesh
    (``placed``, a tree of ``Sharded``) against the reference's (``ref``,
    on the host), in units of its 256-block's scale in the reference
    (``scales``): those off by more than ``MULTIPOD_RES_BLOCK_TOL``, and
    among them those that are not ties (the two residuals not each
    other's negatives within that bound); the largest distance of any
    element from agreement or a tie, over all leaves and a leaf. Pod by
    pod, to hold one pod's slice of a leaf at a time."""
    from repro_torch.train.compression import BLOCK
    from repro_torch.train.optimizer import tree_flatten
    off = not_ties = total = 0
    worst = {}
    for (k, x), (_, w), (_, sc) in zip(tree_flatten(placed),
                                       tree_flatten(ref),
                                       tree_flatten(scales), strict=True):
        full, w = x.full(dev), w.to(dev)
        worst["/".join(k)] = 0.0
        for p in range(full.shape[0]):
            s = sc[p].to(dev).repeat_interleave(BLOCK, -1)
            got = full[p].reshape(s.shape[:-1] + (-1,))
            want = w[p].reshape(got.shape)
            s = s[..., :got.shape[-1]]
            d, t = (got - want).abs(), (got + want).abs()
            bad = d > MULTIPOD_RES_BLOCK_TOL * s
            off += int(bad.sum())
            not_ties += int((bad & (t > MULTIPOD_RES_BLOCK_TOL * s)).sum())
            total += bad.numel()
            pos = s > 0
            if bool(pos.any()):
                worst["/".join(k)] = max(worst["/".join(k)], float(
                    (torch.minimum(d, t)[pos] / s[pos]).max()))
            del s, got, want, d, t, bad, pos
        del full, w
    return {"elements": total, "off": off, "not_ties": not_ties,
            "share_off": off / total, "worst": max(worst.values()),
            "worst_by_leaf": worst}


def state_rel_l2(state, ref: dict, params0: dict, dev) -> dict:
    """The relative L2 distance of each part of the mesh's state from the
    reference's (``ref``: host trees; the parameters and master by their
    change from ``params0``, the drawn weights), all leaves together and
    leaf by leaf."""
    from repro_torch.train.optimizer import tree_flatten
    o = state.opt
    rel, leaf = {}, {}
    for part, tree in (("params", state.params), ("m", o.m), ("v", o.v),
                       ("master", o.master), ("ef", state.ef)):
        num = den = 0.0
        leaf[part] = {}
        for (k, x), (_, w) in zip(tree_flatten(tree),
                                  tree_flatten(ref[part]), strict=True):
            got, want = x.full(dev).float(), w.to(dev).float()
            if part in ("params", "master"):
                p0 = params0[k].to(dev)
                got, want = got - p0, want - p0
                del p0
            n = float((got - want).square().sum())
            d = float(want.square().sum())
            leaf[part]["/".join(k)] = (n / max(d, 1e-30)) ** 0.5
            num, den = num + n, den + d
            del got, want
        rel[part] = (num / max(den, 1e-30)) ** 0.5
    return {"rel_l2": rel, "leaf_rel_l2": leaf}


def grad_rel_l2(grads, ref, dev) -> float:
    """The relative L2 distance of the mesh's uncompressed gradients
    (``Sharded``) from one card's (host), all leaves together."""
    from repro_torch.train.optimizer import tree_flatten
    num = den = 0.0
    for (_, x), (_, w) in zip(tree_flatten(grads), tree_flatten(ref),
                              strict=True):
        got, want = x.full(dev).float(), w.to(dev).float()
        num += float((got - want).square().sum())
        den += float(want.square().sum())
        del got, want
    return (num / max(den, 1e-30)) ** 0.5


def multipod_phase(ops, card: str) -> dict:
    """Phase 24: ``multipod_run``, its line printed, then
    ``multipod_checks``."""
    r = multipod_run(ops, card)
    multipod_checks(r)
    return r


def multipod_run(ops, card: str) -> dict:
    """Phase 24's run: yi-9b at full width, ``MULTIPOD_LAYERS`` layer(s) in
    float32, drawn from the seed straight onto a ``MULTIPOD_MESH`` mesh
    of shards of the card (``init_train_state(..., mesh=, zero=True,
    ef_pods=2)``: ZeRO-1 over ``data``, residuals over ``pod``), trained
    ``MULTIPOD_STEPS`` steps with ``compress_pod_grads``; the loss,
    gradient norm, parameters, moments, master and residuals held to
    ``multipod_reference`` (the constants' comment), ms a step,
    rendezvous, the int8 payload over ``pod`` and the residuals' bytes a
    shard, the card's peak, the kernel launches, the allocation before
    and after; printed as one line."""
    from repro_torch.distributed import spmd
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_mesh_grad_fn, make_train_step)
    from repro_torch.train.optimizer import tree_flatten
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = allocated_without_workspaces()
    check(mem0 < MEMORY_BEFORE_SERVE, f"phase 24: {mem0} B still allocated "
          f"on the card before the weights load")
    model = train_model(MULTIPOD_LAYERS, torch.float32)
    cfg = model.cfg
    batches = [train_batch(cfg, i, dev, MULTIPOD_BATCH, MULTIPOD_SEQ)
               for i in range(MULTIPOD_STEPS)]
    r = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "float32",
         "mesh": dict(zip(("pod", "data", "model"), MULTIPOD_MESH)),
         "batch": MULTIPOD_BATCH, "seq": MULTIPOD_SEQ,
         "steps": MULTIPOD_STEPS, "remat": model.flags.remat}
    t0 = time.perf_counter()
    ref = multipod_reference(model, batches, dev)
    r["reference_s"] = time.perf_counter() - t0

    mesh = spmd.Mesh([dev] * math.prod(MULTIPOD_MESH), MULTIPOD_MESH,
                     ("pod", "data", "model"))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev)
                             .manual_seed(SEED), dev, ef_pods=MULTIPOD_MESH[0],
                             mesh=mesh, zero=True)
    torch.cuda.synchronize()
    r["draw_s"] = time.perf_counter() - t0
    r["params"] = sum(math.prod(x.shape) for _, x in
                      tree_flatten(state.params))
    r.update(compressed_payload(state))
    r.update(state_shares(state, mesh))
    r["state_gb_on_card"] = torch.cuda.memory_allocated() / 1e9
    params0 = dict(tree_flatten(ref["params0"]))
    grads, _ = make_mesh_grad_fn(model)(state.params, batches[0])
    r["uncompressed_grad_rel_l2"] = grad_rel_l2(grads, ref["grads0"], dev)
    del grads
    step = make_train_step(model, TrainConfig(opt=train_opt(),
                                              compress_pod_grads=True))
    for k in ops.LAUNCHES:
        ops.LAUNCHES[k] = 0
    losses, norms, ms, rdv = [], [], [], []
    for i, batch in enumerate(batches):
        with counted_rendezvous() as count:
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        rdv.append(count[0])
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        if i == 0:
            launches = dict(ops.LAUNCHES)
            r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            r["first_step_ties"] = residual_ties(
                state.ef, ref["states"][0]["ef"], ref["scales0"], dev)
        r.setdefault("after_step", []).append(state_rel_l2(
            state, ref["states"][i], params0, dev))
    r["launches"] = launches
    r.update(losses=losses, grad_norms=norms, step_ms=ms,
             rendezvous_per_step=rdv, ms_per_step=ms[-1],
             reference_losses=ref["losses"],
             reference_grad_norms=ref["grad_norms"])
    r["tokens_per_s"] = MULTIPOD_BATCH * MULTIPOD_SEQ / ms[-1] * 1e3
    del state, step, batches, met, ref, params0
    gc.collect()
    torch.cuda.empty_cache()
    mem1 = allocated_without_workspaces()
    r.update(allocated_at_start_mb=mem0 / 2**20,
             allocated_at_end_mb=mem1 / 2**20,
             phase_s=time.perf_counter() - t_phase)
    print(f"train {cfg.name} on a {MULTIPOD_MESH} multi-pod mesh, compressed "
          f"and ZeRO-1, phase 24 ({card}): " + json.dumps(r))
    return r


def multipod_checks(r: dict) -> None:
    """Phase 24's checks of ``multipod_run``'s readings (the constants'
    comment)."""
    losses, norms = r["losses"], r["grad_norms"]
    shares = r["shard_state_gb"]
    check(all(abs(g - shares[0]) < 1e-9 for g in shares)
          and abs(sum(shares) - r["spec_state_gb"] * len(shares))
          <= 1e-6 * sum(shares),
          f"phase 24: the shards hold {shares} GB of state, their specs "
          f"give {r['spec_state_gb']} GB each")
    for got, want in zip(losses, r["reference_losses"]):
        check(math.isfinite(got) and abs(got - want)
              <= MULTIPOD_LOSS_RTOL * abs(want),
              f"phase 24: losses {losses} vs the reference's "
              f"{r['reference_losses']}, relative {MULTIPOD_LOSS_RTOL}")
    for got, want in zip(norms, r["reference_grad_norms"]):
        check(abs(got - want) <= MULTIPOD_NORM_RTOL * want,
              f"phase 24: gradient norms {norms} vs the reference's "
              f"{r['reference_grad_norms']}, relative {MULTIPOD_NORM_RTOL}")
    ties = r["first_step_ties"]
    check(ties["not_ties"] <= MULTIPOD_OFF_SHARE * ties["elements"]
          and ties["worst"] <= MULTIPOD_RES_WORST,
          f"phase 24: after the first step {ties['not_ties']} of "
          f"{ties['elements']} residual elements are off the reference's "
          f"by more than {MULTIPOD_RES_BLOCK_TOL} of their block's scale "
          f"and not ties (at most {MULTIPOD_OFF_SHARE} of them), the worst "
          f"{ties['worst']} of its block's scale from agreement or a tie "
          f"(at most {MULTIPOD_RES_WORST})")
    for i, after in enumerate(r["after_step"]):
        for part in ("params", "m", "v", "master"):
            tol = MULTIPOD_PARAM_RTOL if part in ("params", "master") \
                else MULTIPOD_MOMENT_RTOL
            leaf, rel = max(after["leaf_rel_l2"][part].items(),
                            key=lambda kv: kv[1])
            check(rel <= tol, f"phase 24: {part} of {leaf} after step "
                  f"{i + 1} at relative L2 {rel} from the reference's "
                  f"(tolerance {tol})")
    worst = max(r["after_step"][-1]["leaf_rel_l2"]["ef"].items(),
                key=lambda kv: kv[1])
    check(worst[1] <= MULTIPOD_RES_RTOL, f"phase 24: the residual of "
          f"{worst[0]} after {MULTIPOD_STEPS} steps at relative L2 "
          f"{worst[1]} from the reference's (tolerance {MULTIPOD_RES_RTOL})")
    check(not any(r["launches"].values()),
          f"phase 24: the train steps launched hand-written kernels "
          f"{r['launches']}")
    mem0, mem1 = (r[k] * 2**20 for k in ("allocated_at_start_mb",
                                         "allocated_at_end_mb"))
    check(abs(mem1 - mem0) <= MEMORY_SLACK,
          f"phase 24: {mem1} B allocated after, {mem0} B before")


# -- phase 23: the dry-run against the card ----------------------------------

# -- phase 25: sequence parallelism on a mesh of the card's shards ----------

def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def seqpar_phase(ops, card: str) -> dict:
    """Phase 25: ``seqpar_run``, its line printed, then
    ``seqpar_checks``."""
    r = seqpar_run(ops, card)
    seqpar_checks(r)
    return r


def seqpar_run(ops, card: str) -> dict:
    """Phase 25's run (the constants' comment): yi-9b at full width,
    ``SP_LAYERS`` layers, bf16, served and trained over ``SP_SHARDS``
    shards of the card without and with ``{"act_seq": "model"}``. Each
    prefill is counted (``opcount``: each shard's collective bytes and
    its peak of the bytes the step allocates) and then timed; each way's
    train steps are timed with their rendezvous and the card's peak.
    Printed as one line."""
    from repro_torch import opcount
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.sharding import use_sharding
    from repro_torch.serve.serve_step import (init_mesh_cache,
                                              make_prefill_step)
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_mesh_grad_fn, make_train_step)
    from repro_torch.train.optimizer import tree_flatten
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = allocated_without_workspaces()
    check(mem0 < MEMORY_BEFORE_SERVE, f"phase 25: {mem0} B still allocated "
          f"on the card before the weights load")
    model = train_model(SP_LAYERS)
    cfg = model.cfg
    batch = train_batch(cfg, 0, dev, SP_BATCH, SP_SEQ)
    tokens = batch["tokens"]
    ways = (("without", None), ("with", {"act_seq": "model"}))
    r = {"arch": cfg.name, "layers": cfg.n_layers, "batch": SP_BATCH,
         "seq": SP_SEQ, "shards": SP_SHARDS, "dtype": "bfloat16",
         "activation_gb": SP_BATCH * SP_SEQ * cfg.d_model * 2 / 1e9}

    # -- one card's prefill logits on the same weights --
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    cache = model.init_cache(SP_BATCH, SP_SEQ, dev)
    _, _, one = make_prefill_step(model, logits=True)(
        params, {"tokens": tokens}, cache)
    one = one.float()
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()

    # -- the prefill on the mesh, both ways --
    mesh = make_production_mesh(devices=[dev] * SP_SHARDS)
    placed = model.init(torch.Generator(device=dev).manual_seed(SEED), dev,
                        mesh=mesh)
    prefill = make_prefill_step(model, mesh, logits=True)
    logits = {}
    for name, rules in ways:
        out = r.setdefault("prefill", {}).setdefault(name, {})
        cache = init_mesh_cache(model, SP_BATCH, SP_SEQ, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        counter = opcount.Counter()
        with use_sharding(mesh, rules), opcount.counting(counter), \
                counted_rendezvous() as count:
            _, cache, last = prefill(placed, {"tokens": tokens}, cache)
            torch.cuda.synchronize()
        out["launches"] = dict(ops.LAUNCHES)
        out["rendezvous"] = count[0]
        out["collective_bytes"] = [counter.shards[i].collectives
                                   for i in range(SP_SHARDS)]
        out["shard_peak_gb"] = [counter.peak_with_caller.get(i, 0) / 1e9
                                for i in range(SP_SHARDS)]
        out["card_peak_gb"] = (torch.cuda.max_memory_allocated()
                               - base) / 1e9
        logits[name] = last.full(dev).float()
        out["finite"] = bool(torch.isfinite(logits[name]).all())
        out["rel_l2_vs_one_card"] = _rel_l2(logits[name], one)
        del counter
        with use_sharding(mesh, rules):
            ms = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prefill(placed, {"tokens": tokens}, cache)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
        out["prefill_ms"] = ms[-1]
        del cache, last
    r["prefill_rel_l2_with_vs_without"] = _rel_l2(logits["with"],
                                                  logits["without"])
    del placed, prefill, logits, one
    gc.collect()
    torch.cuda.empty_cache()

    # -- training: the first step's gradients both ways, then timed steps --
    state = init_train_state(model, torch.Generator(device=dev)
                             .manual_seed(SEED), dev, mesh=mesh)
    grads = {}
    for name, rules in ways:
        with use_sharding(mesh, rules):
            g, m = make_mesh_grad_fn(model)(state.params, batch)
        r.setdefault("train", {})[name] = {
            "loss": float(m["ce"] + m["aux"]),
            "grad_norm": float(m["grad_norm"])}
        grads[name] = g
    cos, ratio = {}, {}
    for (k, a), (_, b) in zip(tree_flatten(grads["without"]),
                              tree_flatten(grads["with"]), strict=True):
        a, b = a.full(dev).float().flatten(), b.full(dev).float().flatten()
        na, nb = a.norm(), b.norm()
        cos["/".join(k)] = float(torch.dot(a, b) / (na * nb)
                                 .clamp_min(1e-30))
        ratio["/".join(k)] = float(nb / na.clamp_min(1e-30))
        del a, b
    r["min_cosine"] = min(cos.values())
    r["max_norm_ratio_err"] = max(abs(x - 1) for x in ratio.values())
    r["worst_leaves"] = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    del grads, g, m
    gc.collect()
    step = make_train_step(model, TrainConfig(opt=train_opt()))
    for name, rules in ways:
        out = r["train"][name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        ms, rdv, losses = [], [], []
        with use_sharding(mesh, rules):
            for _ in range(SP_TRAIN_STEPS):
                with counted_rendezvous() as count:
                    t0 = time.perf_counter()
                    state, met = step(state, batch)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                rdv.append(count[0])
                losses.append(float(met["loss"]))
        out.update(step_ms=ms, ms_per_step=float(np.median(ms[1:])),
                   rendezvous_per_step=rdv, losses=losses,
                   launches=dict(ops.LAUNCHES),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del state, step, batch, met
    gc.collect()
    torch.cuda.empty_cache()
    mem1 = allocated_without_workspaces()
    r.update(allocated_at_start_mb=mem0 / 2**20,
             allocated_at_end_mb=mem1 / 2**20,
             phase_s=time.perf_counter() - t_phase)
    print(f"sequence parallelism on a (1, {SP_SHARDS}) mesh, phase 25 "
          f"({card}): " + json.dumps(r))
    return r


def seqpar_checks(r: dict) -> None:
    """Phase 25's checks (the constants' comment) on ``seqpar_run``'s
    result."""
    pre = r["prefill"]
    act_bytes = r["activation_gb"] * 1e9
    for name, out in pre.items():
        check(out["finite"], f"phase 25: non-finite logits {name} the rule")
        check(out["rel_l2_vs_one_card"] <= MESH_LOGITS_TOL,
              f"phase 25: the prefill {name} the rule is "
              f"{out['rel_l2_vs_one_card']} (relative L2) from one card's")
        want = SP_LAYERS * SP_SHARDS
        check(out["launches"]["flash_attention"] == want,
              f"phase 25: the prefill {name} the rule launched flash "
              f"{out['launches']} times, not {want}")
    check(r["prefill_rel_l2_with_vs_without"] <= SP_AGREE_RTOL,
          f"phase 25: the prefill with the rule is "
          f"{r['prefill_rel_l2_with_vs_without']} (relative L2) from the "
          f"one without")
    for i, c in enumerate(pre["with"]["collective_bytes"]):
        check(c["reduce-scatter"] > 0, f"phase 25: shard {i} reduce-"
              f"scattered nothing with the rule: {c}")
        check(c["all-reduce"] < act_bytes, f"phase 25: shard {i} "
              f"all-reduced {c['all-reduce']} B with the rule, an "
              f"activation is {act_bytes} B")
    tr = r["train"]
    check(abs(tr["with"]["loss"] - tr["without"]["loss"])
          <= SP_LOSS_RTOL * tr["without"]["loss"],
          f"phase 25: the first loss with the rule {tr['with']['loss']}, "
          f"without {tr['without']['loss']}")
    check(r["min_cosine"] >= TRAIN_COS_MIN, f"phase 25: a gradient leaf's "
          f"cosine with and without the rule is {r['min_cosine']}: "
          f"{r['worst_leaves']}")
    check(r["max_norm_ratio_err"] <= MESH_TRAIN_NORM_RTOL,
          f"phase 25: a gradient leaf's norm with the rule is "
          f"{r['max_norm_ratio_err']} from the one without")
    for name, out in tr.items():
        check(all(math.isfinite(x) for x in out["losses"]),
              f"phase 25: non-finite losses {name} the rule {out['losses']}")
        check(not any(out["launches"].values()), f"phase 25: the train "
              f"steps {name} the rule launched kernels {out['launches']}")
    check(abs(r["allocated_at_end_mb"] - r["allocated_at_start_mb"])
          * 2**20 <= MEMORY_SLACK, f"phase 25: "
          f"{r['allocated_at_end_mb']} MiB allocated after, "
          f"{r['allocated_at_start_mb']} MiB before")


def dryrun_meta(out_path: str) -> None:
    """The meta half of phase 23, run in a process of its own that sees no
    card (``start_dryrun_meta``): each cell of DRYRUN_CELLS lowered on
    meta shards and counted; its counts, result and seconds written to
    ``out_path`` as JSON."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.launch import dryrun as D
    out = {}
    for (label, arch, shape, chips, probe, od, batch, level,
         variant) in DRYRUN_CELLS:
        cell = D.build_cell(arch, shape, chips=chips, probe=probe,
                            over_decompose=od, batch=batch, opt_level=level,
                            multi_pod=variant == "compress_pod",
                            **D.VARIANTS[variant])
        counter, secs = D.count_step(cell)
        res = D.result_of(cell, counter, secs, 0.0, level)
        out[label] = {"counts": counter.summary(), "meta_s": secs,
                      "peak_all": counter.peak_all,
                      "arguments_all": all_shard_bytes(cell),
                      "result": {k: v for k, v in res.items()
                                 if k not in ("ops", "kernels")}}
        del cell, counter
        gc.collect()
    with open(out_path, "w") as f:
        json.dump(out, f)


def all_shard_bytes(cell) -> int:
    """Every shard's bytes of a dry-run cell's arguments."""
    from repro_torch.launch import dryrun as D
    return sum(D.shard_bytes(list(cell.args.values()), i)
               for i in range(cell.mesh.size))


def start_dryrun_meta():
    """Start ``dryrun_meta`` in a child process with no card visible (the
    meta runs are CPU work: they overlap the earlier phases); returns
    (the process, its output file, its log file). ``finish_dryrun_meta``
    waits for it; an exit before that stops it."""
    import atexit
    fd, out = tempfile.mkstemp(suffix=".json", prefix="dryrun_meta_")
    os.close(fd)
    log = tempfile.TemporaryFile()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dryrun-meta", out],
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), stdout=log,
        stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if os.path.exists(out):
            os.unlink(out)
    atexit.register(stop)
    return proc, out, log


def finish_dryrun_meta(meta) -> dict:
    proc, out, log = meta
    t0 = time.perf_counter()
    rc = proc.wait(timeout=600)
    log.seek(0)
    tail = log.read().decode(errors="replace")[-4000:]
    check(rc == 0, f"phase 23: the meta lowering exited {rc}: {tail}")
    with open(out) as f:
        res = json.load(f)
    os.unlink(out)
    res["_waited_s"] = time.perf_counter() - t0
    return res


def dryrun_phase(card: str, meta: dict) -> dict:
    """Phase 23: each cell of DRYRUN_CELLS built on the card (weights from
    SEED, a zero cache, seeded tokens, decode lengths of the full context)
    over its shards of cuda:0 and stepped once under the same counter as
    the meta run: the counts must be equal; the arguments' bytes equal the
    placed state's; the predicted peak against the card's; then one step
    without the counter, timed, against the roofline bound."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    dev = torch.device("cuda", 0)
    _, rates = R.peaks(torch.cuda.get_device_name(0))
    out = {"card": card, "meta_waited_s": meta.pop("_waited_s")}
    for (label, arch, shape, chips, probe, od, batch, level,
         variant) in DRYRUN_CELLS:
        t_cell = time.perf_counter()
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_allocated()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cell = D.build_cell(arch, shape, chips=chips, probe=probe,
                            over_decompose=od, batch=batch, opt_level=level,
                            device=dev, gen=gen,
                            multi_pod=variant == "compress_pod",
                            **D.VARIANTS[variant])
        torch.cuda.synchronize()
        placed = torch.cuda.memory_allocated() - mem0
        args0 = D.shard_bytes(list(cell.args.values()))
        torch.cuda.reset_peak_memory_stats()
        counter, counted_s = D.count_step(cell)
        torch.cuda.synchronize()
        # cuBLAS's workspaces (one a stream it ran on, 32 MiB on an H100),
        # allocated at the step's first product and held past its peak:
        # a library cache the counter does not see, not a temporary
        held = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        workspaces = held - torch.cuda.memory_allocated()
        peak = torch.cuda.max_memory_allocated() - mem0 - workspaces
        got = json.loads(json.dumps(counter.summary()))
        want = meta[label]["counts"]
        pred = meta[label]["result"]
        r = {"cell": [arch, shape, str(tuple(cell.mesh.shape.values())),
                      f"probe={probe}", f"od={od}",
                      f"batch={cell.shape.global_batch}", level,
                      variant],
             "counts_equal": got == want,
             "flops_per_device": D.device0(counter)["flops"],
             "bytes_per_device": D.device0(counter)["bytes"],
             "collective_bytes_per_device":
                 D.device0(counter)["collectives"],
             "ops_dispatched": pred["ops_dispatched"],
             "kernels": {k: v["launches"] for k, v in
                         D.device0(counter)["kernels"].items()},
             "argument_size_in_bytes": pred["argument_size_in_bytes"],
             "card_argument_bytes": args0, "card_placed_bytes": placed,
             "temp_size_in_bytes": pred["temp_size_in_bytes"],
             "card_peak_bytes": peak, "card_cublas_workspace_bytes":
                 workspaces, "meta_s": meta[label]["meta_s"],
             "counted_card_s": counted_s,
             "peak_all": meta[label]["peak_all"],
             "card_peak_all": counter.peak_all,
             "arguments_all": meta[label]["arguments_all"],
             "card_arguments_all": all_shard_bytes(cell)}
        if not r["counts_equal"]:
            r["count_diff"] = count_diff(want, got)
        del counter
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cell.run()
        torch.cuda.synchronize()
        r["step_s"] = time.perf_counter() - t0
        terms = {"compute": r["flops_per_device"] / rates.bf16,
                 "memory": r["bytes_per_device"] / rates.hbm,
                 "collective": sum(r["collective_bytes_per_device"]
                                   .values()) / rates.link}
        r["bound_s"] = max(terms.values())
        r["bottleneck"] = max(terms, key=terms.get)
        r["time_over_bound"] = r["step_s"] / r["bound_s"]
        # every shard's bytes together: the shards share the card
        r["predicted_card_peak_bytes"] = r["arguments_all"] + r["peak_all"]
        r["card_peak_all_rel_err"] = \
            (r["predicted_card_peak_bytes"] - peak) / peak
        card_temp_all = peak - r["card_arguments_all"]
        r["card_temp_all_bytes"] = card_temp_all
        r["temp_all_rel_err"] = (r["peak_all"] - card_temp_all) \
            / card_temp_all
        del cell
        gc.collect()
        torch.cuda.empty_cache()
        r["cell_s"] = time.perf_counter() - t_cell
        out[label] = r
    print(f"dryrun vs card, phase 23 ({card}): " + json.dumps(out))
    for label, *_ in DRYRUN_CELLS:
        r = out[label]
        check(r["counts_equal"], f"phase 23 ({label}): the meta counts "
              f"differ from the card's: {r.get('count_diff')}")
        check(r["argument_size_in_bytes"] == r["card_argument_bytes"],
              f"phase 23 ({label}): argument_size_in_bytes "
              f"{r['argument_size_in_bytes']} against the card's "
              f"{r['card_argument_bytes']}")
        if label in DRYRUN_KERNELS:
            check(r["kernels"].get(DRYRUN_KERNELS[label], 0) > 0,
                  f"phase 23 ({label}): {DRYRUN_KERNELS[label]} was not "
                  f"launched: {r['kernels']}")
        check(r["arguments_all"] == r["card_arguments_all"],
              f"phase 23 ({label}): the shards' arguments "
              f"{r['arguments_all']} B against the card's "
              f"{r['card_arguments_all']} B")
        if label in DRYRUN_PEAK_CHECKED:
            check(abs(r["card_peak_all_rel_err"]) <= DRYRUN_PEAK_TOL,
                  f"phase 23 ({label}): predicted peak of the shards "
                  f"together {r['predicted_card_peak_bytes']} B, the "
                  f"card's {r['card_peak_bytes']} B")
            check(abs(r["temp_all_rel_err"]) <= DRYRUN_TEMP_TOL,
                  f"phase 23 ({label}): predicted temporaries of the "
                  f"shards together {r['peak_all']} B, the card's "
                  f"{r['card_temp_all_bytes']} B (its peak less the "
                  f"shards' arguments)")
            check(r["step_s"] >= r["bound_s"], f"phase 23 ({label}): the "
                  f"step took {r['step_s']} s, under its bound "
                  f"{r['bound_s']} s")
    return out


def count_diff(want: dict, got: dict, path: str = "") -> list:
    """Where two count summaries differ (the first 20 places)."""
    diffs = []
    for k in sorted(set(want) | set(got), key=str):
        a, b = want.get(k), got.get(k)
        if isinstance(a, dict) and isinstance(b, dict):
            diffs += count_diff(a, b, f"{path}/{k}")
        elif a != b:
            diffs.append(f"{path}/{k}: meta {a}, card {b}")
    return diffs[:20]


def main() -> int:
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    from repro_torch.apps.dgemm import run_double_dgemm
    from repro_torch.apps.jacobi3d import run_reference, run_tasked
    from repro_torch.core import Runtime, RuntimeConfig
    from repro_torch.kernels import _build, ops
    # phase 23's meta half, on the host's cores while the card works
    meta = start_dryrun_meta()

    # -- phase 1: card and build --------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    sku, (fp32, bf16, mem_rate) = peaks(name)
    print(card)
    print(f"peaks of the {sku}: fp32 {fp32:.3g} FLOP/s, bf16 {bf16:.3g} "
          f"FLOP/s, {mem_rate:.3g} B/s; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    # the earlier head-dim-256 flash design, built beside the port's kernels
    variants = kernel_variants()
    earlier = variants.start_build(["column_groups"], "flash_attention")
    # the flash library is built afresh, so that ptxas reports its kernels
    # even where build/ holds an up-to-date one
    (_build.BUILD_DIR / "libflash_attention.so").unlink(missing_ok=True)
    log = _build.build_all()
    variants.finish_build(earlier)
    check("flash_attention" in log,
          "build_all did not rebuild the flash library: no ptxas report")
    print(f"build: nvcc {' '.join(_build.NVCC_FLAGS)} over "
          f"src/repro_torch/csrc/{{{','.join(sorted(_build.SIGNATURES))}}}.cu"
          f" and the column-group flash design in "
          f"{time.perf_counter() - t0:.3f} s")
    for lib, (secs, out) in sorted(log.items()):
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "Compiling entry" in ln
                or "spill" in ln]
        print(f"build: lib{lib}.so {secs:.3f} s; " + " | ".join(regs))
    flash_regs = ptxas_kernels(log["flash_attention"][1])
    print("build: flash kernels (registers at launch, spill bytes, wgmma "
          "serialised): " + json.dumps(flash_regs))
    one_pass = [r for k, r in flash_regs.items() if k.startswith("one_pass")]
    check(len(one_pass) == 3 and all(
        r["spill_stores"] == 0 == r["spill_loads"] for r in one_pass),
        "a one-pass flash kernel spills, or ptxas did not report it")
    check(not any(r["wgmma_serialised"] for r in flash_regs.values()),
          "ptxas serialised the wgmma products of a flash kernel")
    earlier_lib = variants.load("column_groups", "flash_attention")

    marks = [("start", t_start)]

    def mark(name: str) -> None:
        """The wall time up to here, named after the phase that ended."""
        marks.append((name, time.perf_counter()))
    mark("1 build")

    # -- phase 2: kernels against their plain versions ------------------------
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    res = kernel_checks(ops, gen, fp32, bf16, mem_rate, earlier_lib)
    for key, r in res.items():
        print(f"kernel {key}: {json.dumps(r)}")
    # the local layers' window path (plain torch, as in the JAX package)
    window = window_checks(gen, bf16)
    print(f"window ({card}): {json.dumps(window)}")
    gc.collect()
    torch.cuda.empty_cache()
    mark("2 kernels")

    # -- phase 3: double DGEMM through the runtime -----------------------------
    rt = Runtime(RuntimeConfig())
    try:
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        a, b, d = run_double_dgemm(rt, DGEMM_N, SEED)
        dgemm_ms = (time.perf_counter() - t0) * 1e3
        dgemm_launches = dict(ops.LAUNCHES)
        stats = rt.stats()
    finally:
        rt.shutdown()
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    want = ops.matmul_plain(ops.matmul_plain(ta, tb), tb).cpu().numpy()
    del ta, tb
    dgemm_err = float(np.max(np.abs(d - want)))
    check(bool(np.allclose(d, want, rtol=1e-3, atol=1e-3)),
          f"runtime DGEMM outside 1e-3 of plain (max err {dgemm_err})")
    check(dgemm_launches["matmul"] == 2,
          f"DGEMM launched matmul {dgemm_launches['matmul']} times, not 2")
    print(f"dgemm: n={DGEMM_N} {dgemm_ms:.3f} ms wall (incl. staging); "
          f"launches {dgemm_launches}; max abs err vs plain {dgemm_err}; "
          + json.dumps({k: stats[k] for k in (
              "tasks", "transfers_h2d", "transfers_d2h", "transfers_d2d",
              "bytes_h2d", "bytes_d2h", "staging_hits", "staging_misses",
              "prefetch_hits", "prefetch_stalls", "prefetch_misses")}))

    # -- phase 4: Jacobi3D through the runtime ---------------------------------
    u0 = np.random.default_rng(SEED).random((JACOBI_N,) * 3,
                                            dtype=np.float32)
    torch.cuda.reset_peak_memory_stats()
    rt = Runtime(RuntimeConfig())
    try:
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        got = run_tasked(u0, JACOBI_ITERS, rt,
                         over_decomposition=JACOBI_OD)
        jac_s = time.perf_counter() - t0
        jac_launches = dict(ops.LAUNCHES)
        stats = rt.stats()
    finally:
        rt.shutdown()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    trace = sweep_trace(run_tasked, Runtime, RuntimeConfig, u0)
    t0 = time.perf_counter()
    want = run_reference(u0, JACOBI_ITERS, device="cuda")
    ref_s = time.perf_counter() - t0
    n_diff = int(np.count_nonzero(got != want))
    check(n_diff == 0, f"run_tasked differs from run_reference at "
          f"{n_diff} points (max {float(np.max(np.abs(got - want)))})")
    want_launches = JACOBI_OD * JACOBI_ITERS
    check(jac_launches["jacobi3d_faces"] == want_launches,
          f"run_tasked launched jacobi3d_faces "
          f"{jac_launches['jacobi3d_faces']} times, not {want_launches}")
    check(bool(np.isfinite(got).all()), "non-finite Jacobi result")
    print(f"jacobi: {JACOBI_N}^3 od={JACOBI_OD} iters={JACOBI_ITERS} "
          f"run_tasked {jac_s * 1e3 / JACOBI_ITERS:.3f} ms/iteration wall "
          f"(incl. staging in and out); run_reference {ref_s:.3f} s; "
          f"tasks {stats['tasks']}; launches {jac_launches}; equal to "
          f"run_reference: True")
    print(f"jacobi peak device memory {peak_gb:.3f} GB; traced run: "
          + json.dumps(trace))
    # the Jacobi runtime's objects (and their lineage records, a cycle)
    # still hold the domain on the card
    del rt
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 4b: the same proxy with its sweeps replayed as CUDA graphs --
    traced = traced_jacobi(ops, run_tasked, Runtime, RuntimeConfig, u0, got,
                           want)
    traced["interpreted_trace"] = {k: trace.get(k) for k in (
        "steady_ms_per_sweep", "steady_device_idle_share",
        "stencil_kernel_ms")}
    print(f"jacobi traced ({card}): " + json.dumps(traced))
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    mark("3-4b dgemm, jacobi")

    # -- phase 5: dense-LM serving, yi-9b at full width and depth -------------
    srv = serve_phase(ops, Runtime, RuntimeConfig, 5)
    print(f"serve ({card}): " + json.dumps(srv))
    mark("5 yi-9b")

    # -- phase 6: Mamba-2 serving, mamba2-370m at full width and depth -------
    ssm = serve_phase(ops, Runtime, RuntimeConfig, 6)
    print(f"serve ssm ({card}): " + json.dumps(ssm))
    mark("6 mamba2")

    # -- phase 7: the distributed proxy on the message engine --------------
    dist = cluster_phase(ops, run_reference, RuntimeConfig, u0)
    print(f"jacobi cluster ({card}): " + json.dumps(dist))
    print(f"send latency ({card}): "
          + json.dumps(send_latency(RuntimeConfig)))
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 8: resilience: collectives, residual, elastic runtime ------
    print(f"allreduce ({card}): "
          + json.dumps(allreduce_times(RuntimeConfig)))
    print(f"jacobi residual ({card}): " + json.dumps(
        residual_phase(ops, run_reference, RuntimeConfig, u0)))
    print(f"jacobi elastic ({card}): " + json.dumps(
        elastic_phase(ops, run_reference, RuntimeConfig, u0)))
    gc.collect()
    torch.cuda.empty_cache()

    # -- phase 9: the SPMD path: run_spmd over a mesh sharing the card ----
    print(f"jacobi spmd ({card}): " + json.dumps(
        spmd_phase(ops, run_reference, u0, dist["ms_per_iteration"])))
    gc.collect()
    torch.cuda.empty_cache()
    mark("7-9 cluster, resilience, spmd")

    # -- phase 10: gemma3-27b serving at full width and depth ------------
    gemma = serve_phase(ops, Runtime, RuntimeConfig, 10)
    gemma["window_share_of_prefill"] = window_share(
        GEMMA_ARCH, window["gemma3"]["ms"], gemma["prefill_ms"])
    print(f"serve gemma3 ({card}): " + json.dumps(gemma))
    mark("10 gemma3")

    # -- phase 11: recurrentgemma-9b serving at full width and depth -----
    # -- phase 21 (run inside phases 11 and 15, on their weights): each
    # model served over a (1, 4) mesh of shards of the card -------------
    rg = serve_phase(ops, Runtime, RuntimeConfig, 11)
    rg["window_share_of_prefill"] = window_share(
        RG_ARCH, window["recurrentgemma"]["ms"], rg["prefill_ms"])
    rg["rglru"]["scan_share_of_prefill"] = layers_of(RG_ARCH, "rglru") * \
        rg["rglru"]["scan_ms"] / rg["prefill_ms"]
    mesh_rg = rg.pop("mesh")
    print(f"serve recurrentgemma ({card}): " + json.dumps(rg))
    print(f"serve recurrentgemma on a (1, {MESH_SHARDS}) mesh, phase 21 "
          f"({card}): " + json.dumps(mesh_rg))
    mark("11 recurrentgemma, with 21")

    # -- phase 12: pixtral-12b serving at full width and depth -----------
    pix = serve_phase(ops, Runtime, RuntimeConfig, 12)
    print(f"serve pixtral ({card}): " + json.dumps(pix))
    mark("12 pixtral")

    # -- phase 13: olmoe-1b-7b serving at full width and depth, then one
    # MoE layer expert-parallel over four shards sharing the card --------
    olmoe = serve_phase(ops, Runtime, RuntimeConfig, 13)
    olmoe["ep"] = ep_check(MOE_ARCH)
    print(f"serve olmoe ({card}): " + json.dumps(olmoe))
    mark("13 olmoe")

    # -- phase 14: llama4-scout-17b-16e at full width, 8 of 48 layers ----
    scout = serve_phase(ops, Runtime, RuntimeConfig, 14)
    scout["ep"] = ep_check(SCOUT_ARCH)
    # -- phase 19 (run inside phase 14, on its weights): the same model
    # served over a (1, 4) mesh of shards of the card --------------------
    mesh_scout = scout.pop("mesh")
    print(f"serve llama4-scout ({card}): " + json.dumps(scout))
    print(f"serve llama4-scout on a (1, {MESH_SHARDS}) mesh, phase 19 "
          f"({card}): " + json.dumps(mesh_scout))
    mark("14 llama4-scout, with 19")

    # -- phase 15: whisper-large-v3 at full width and depth --------------
    whisper = serve_phase(ops, Runtime, RuntimeConfig, 15)
    mesh_whisper = whisper.pop("mesh")
    print(f"serve whisper ({card}): " + json.dumps(whisper))
    print(f"serve whisper on a (1, {MESH_SHARDS}) mesh, phase 21 "
          f"({card}): " + json.dumps(mesh_whisper))
    mark("15 whisper, with 21")

    # -- phases 16-18: training yi-9b at full width; resume; compression
    # and the elastic driver over shards of the card --------------------
    # (each prints its line before its checks)
    train_phase(ops, card)
    resume_phase(card)
    compression_elastic_phase(card)
    mark("16-18 training")

    # -- phase 20: yi-9b trained over a (1, 4) mesh of shards of the card
    # (prints its line before its checks) --------------------------------
    with watchdog(MESH_TRAIN_WATCHDOG_S, "phase 20 (training on a mesh)"):
        mesh_train_phase(ops, card)
    mark("20 yi-9b on a mesh")

    # -- phase 22: recurrentgemma-9b (6 layers) and whisper-large-v3
    # trained over the same mesh (each prints its line before its
    # checks) -------------------------------------------------------------
    for arch in (RG_ARCH, WHISPER_ARCH):
        with watchdog(MESH_TRAIN_WATCHDOG_S, f"phase 22 ({arch})"):
            mesh_train_phase(ops, card, arch, 22)
        mark(f"22 {arch}")

    # -- phase 24: yi-9b (1 layer, float32) trained over a (2, 2, 2)
    # multi-pod mesh of shards of the card, compressed over pod and ZeRO-1
    # over data, against one card (prints its line before its checks) ----
    with watchdog(MULTIPOD_WATCHDOG_S, "phase 24 (the multi-pod mesh)"):
        multipod_phase(ops, card)
    mark("24 multi-pod")

    # -- phase 25: sequence parallelism on a (1, 4) mesh of shards of the
    # card, served and trained without and with the rule (prints its line
    # before its checks) ----------------------------------------------------
    with watchdog(SP_WATCHDOG_S, "phase 25 (sequence parallelism)"):
        seqpar_phase(ops, card)
    mark("25 sequence parallelism")

    # -- phase 23: the dry-run's counts against the card's (prints its line
    # before its checks) ----------------------------------------------------
    dryrun_phase(card, finish_dryrun_meta(meta))
    mark("23 dry-run")
    print("phase seconds: " + json.dumps(
        {name: round(t - t0_, 1) for (_, t0_), (name, t)
         in zip(marks, marks[1:])} | {"total": round(
            marks[-1][1] - t_start, 1)}))

    launches = {"jacobi3d_faces": jac_launches["jacobi3d_faces"],
                "matmul": dgemm_launches["matmul"],
                "flash_attention": srv["launches"]["flash_attention"],
                "decode_attention": srv["launches"]["decode_attention"],
                "ssd_chunk": ssm["launches"]["ssd_chunk"],
                "moe_experts": olmoe["launches"]["moe_experts"]}
    sources = {"jacobi3d_faces": ("src/repro_torch/csrc/jacobi3d.cu",
                                  "src/repro/kernels/jacobi3d.py:19"),
               "matmul": ("src/repro_torch/csrc/matmul.cu",
                          "src/repro/kernels/matmul.py:18"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:20"),
               "decode_attention": ("src/repro_torch/csrc/decode_attention.cu",
                                    "none: src/repro/models/attention.py:181 "
                                    "is two einsums"),
               "ssd_chunk": ("src/repro_torch/csrc/ssd.cu",
                             "src/repro/kernels/ssd.py:22"),
               "moe_experts": ("src/repro_torch/csrc/moe_experts.cu",
                               "none: src/repro/models/moe.py moe_dense "
                               "runs every expert on every token")}
    kernels = [dict(
        name=k, route="cuda", source=sources[k][0], replaces=sources[k][1],
        launches=launches[k], max_abs_err=res[k]["max_abs_err"],
        ms=res[k]["ms"], plain_ms=res[k]["plain_ms"],
        bound_ms=res[k]["bound_ms"], bound_by=res[k]["bound_by"],
        library_ms=res[k]["library_ms"]) for k in sources]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dryrun-meta"]:
        dryrun_meta(sys.argv[2])
        sys.exit(0)
    sys.exit(main())
