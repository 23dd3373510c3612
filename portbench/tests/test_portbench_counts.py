"""The frozen counts held to hand counts: at a small shape term by term,
and at the benchmark's shapes to the figures the cells are read against."""
from __future__ import annotations

import json

import pytest

from portbench import spec
from portbench.counts import work
from portbench.tests.conftest import REPO

YI = json.loads((REPO / "portbench/configs/yi-9b.json").read_text())
SMALL = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 2, "d_ff": 16, "vocab": 10}


def test_small_model_by_hand():
    # q 8x8, k and v 8x4 each, o 8x8, three MLP products 8x16
    assert work.layer_linear_params(SMALL) == 64 + 32 + 32 + 64 + 3 * 128
    assert work.linear_params(SMALL) == 2 * 576
    # 3 positions: pairs 1 + 2 + 3 = 6, each 4 FLOPs a head dim
    assert work.causal_attention_flops(1, 3, 4, 2) == 4 * 4 * 2 * 6
    assert work.prefill_flops(SMALL, 1, 3) == \
        2 * 1152 * 3 + 2 * 192 + 2 * 8 * 10
    # context 3: products and unembedding on one token, 3 keys a head
    assert work.decode_step_flops(SMALL, 1, 3) == \
        2 * (1152 + 80) + 4 * 4 * 2 * 3 * 2
    # per position: K and V, 2 kv heads of 2, bf16, 2 layers
    assert work.kv_bytes_per_position(SMALL, 1) == 2 * 2 * 2 * 2 * 2
    assert work.decode_step_bytes(SMALL, 1, 3) == \
        (1152 + 80) * 2 + 8 * 2 + 5 * 8 * 4 + 32 * 3 + 32


def test_stencil_by_hand():
    assert work.stencil_sweep_bytes(2) == 2 * 8 * 4
    assert work.stencil_chunk_bytes((2, 3, 4)) == \
        (2 * 24 + 2 * (12 + 8 + 6)) * 4
    assert work.chunk_shape(768, 8) == (384, 384, 384)
    assert work.chunk_shape(768, 2) == (384, 768, 768)


def test_benchmark_shapes():
    assert work.linear_params(YI) == pytest.approx(8.30e9, rel=1e-3)
    # one flash call of a yi-9b prefill, q [4, 2048, 4, 8, 128]: the kernel
    # table's 0.139 ms bound at 989 TFLOP/s
    f = work.causal_attention_flops(4, 2048, 32, 128)
    assert f == pytest.approx(1.37e11, rel=1e-2)
    assert f / 989e12 * 1e3 == pytest.approx(0.139, rel=1e-2)
    assert work.prefill_flops(YI, 4, 2048) == pytest.approx(1.43e14,
                                                            rel=1e-2)
    # a decode step at batch 64 and context 2112: 17.1 GB of weights,
    # 13.3 GB of cache
    b = work.decode_step_bytes(YI, 64, 2112)
    assert b == pytest.approx(17.13e9 + 13.3e9, rel=1e-2)
    # a 384^3 chunk and its faces, float32: the kernel table's 0.136 ms
    assert work.stencil_chunk_bytes((384,) * 3) / 3.35e12 * 1e3 == \
        pytest.approx(0.136, rel=1e-2)


def test_peak_table():
    row = work.peaks("NVIDIA H100 80GB HBM3")
    assert row["bf16_flop_s"] == 989e12 and row["hbm_bytes_s"] == 3.35e12
    assert row["power_limit_w"] == 700
    assert work.peaks("a card the table lacks") is None
    assert spec.HERE / "counts" / "peaks.json" == work.PEAKS_FILE
