"""The port's checkpointer (``repro_torch.checkpoint``) on the CPU: the
cases of ``tests/test_integrity.py`` and ``tests/test_train_checkpoint.py``
that need no training stack, the same leaf keys and digests as the JAX
package's ``Checkpointer`` (a step written by either restores in the
other), and bfloat16 leaves without a numpy bfloat16."""
import json
import os
import subprocess
import sys
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.checkpoint.checkpointer as jckpt_mod
import repro.distributed as jdist
from repro_torch.checkpoint import Checkpointer, CheckpointIntegrityError
from repro_torch.checkpoint.checkpointer import _flatten, _key_of
from repro_torch.distributed import FaultInjector


class Pair(NamedTuple):
    a: np.ndarray
    b: np.ndarray


def _state(seed: int):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.random((8, 4)).astype(np.float32),
                       "layers": [rng.random(3).astype(np.float64),
                                  rng.integers(0, 9, 5).astype(np.int32)]},
            "opt": (Pair(rng.random(2).astype(np.float32),
                         rng.random((2, 2)).astype(np.float16)), None),
            "step": np.array(seed, np.int64)}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)["leaves"]


def test_leaf_keys_and_order_are_the_jax_packages():
    state = _state(0)
    got = [(_key_of(p), v) for p, v in _flatten(state)]
    want = [(jckpt_mod._key_of(p), v) for p, v in
            jax.tree_util.tree_flatten_with_path(state)[0]]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a is b
    assert _key_of(()) == "leaf"


def test_save_restore_round_trip(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    state = _state(1)
    ckpt.save(5, state)
    ckpt.wait()
    got = ckpt.restore(5, state)
    assert got["opt"][1] is None and isinstance(got["opt"][0], Pair)
    for (_, a), (_, b) in zip(_flatten(got), _flatten(state)):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # tensor references come back as tensors of their dtype, on a device
    # when one is named
    ref = {"w": torch.zeros(8, 4, dtype=torch.float64)}
    ckpt.save(6, {"w": torch.from_numpy(state["params"]["w"])}, block=True)
    t = ckpt.restore(6, ref, device="cpu")["w"]
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), state["params"]["w"])
    assert ckpt.restore_latest({"w": None}) == {"w": None}


def test_rotation_and_torn_write(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2, async_save=False)
    for s in range(4):
        ckpt.save(s, {"x": np.full(3, s, np.float32)})
    assert ckpt.all_steps() == [2, 3]
    # a step directory without COMMIT is torn: never listed or restored
    os.makedirs(tmp_path / "step_9")
    assert ckpt.latest_step() == 3
    np.testing.assert_array_equal(
        ckpt.restore_latest({"x": np.zeros(3, np.float32)})["x"],
        np.full(3, 3, np.float32))


def test_corrupted_leaf_detected_and_falls_back_to_older_step(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=3, async_save=False)
    rng = np.random.default_rng(9)
    arrs = {s: rng.random((32, 8)).astype(np.float32) for s in (1, 2)}
    for s, arr in arrs.items():
        ckpt.save(s, {"w": arr})
    fi = FaultInjector(None, seed=0)
    fi.corrupt_checkpoint_leaf(str(tmp_path), 2, "w")
    assert fi.stats["ckpt_corrupted"] == 1
    with pytest.raises(CheckpointIntegrityError, match="digest"):
        ckpt.restore_leaf(2, "w")
    assert ckpt.stats["ckpt_verify_fail"] == 1
    step, arr = ckpt.restore_leaf_fallback("w")
    assert step == 1
    np.testing.assert_array_equal(arr, arrs[1])
    fi.corrupt_checkpoint_leaf(str(tmp_path), 1, "w")
    with pytest.raises(CheckpointIntegrityError, match="no committed step"):
        ckpt.restore_leaf_fallback("w")
    with pytest.raises(KeyError):
        ckpt.restore_leaf(1, "nope")


def test_injector_flips_the_bit_the_jax_injector_flips(tmp_path):
    """Same seed, same leaf: both packages' injectors flip the same bit."""
    arr = np.random.default_rng(3).random((16, 16)).astype(np.float32)
    for d in ("port", "jax"):
        Checkpointer(str(tmp_path / d), async_save=False).save(0, {"w": arr})
    clean = (tmp_path / "port" / "step_0" / "w.npy").read_bytes()
    FaultInjector(None, seed=5).corrupt_checkpoint_leaf(
        str(tmp_path / "port"), 0, "w")
    jdist.FaultInjector(None, seed=5).corrupt_checkpoint_leaf(
        str(tmp_path / "jax"), 0, "w")
    flipped = (tmp_path / "port" / "step_0" / "w.npy").read_bytes()
    assert flipped == (tmp_path / "jax" / "step_0" / "w.npy").read_bytes()
    assert flipped != clean


def test_restore_validates_manifest_shape_and_dtype(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=False)
    ckpt.save(0, {"w": np.ones((4, 4), np.float32)})
    np.save(os.path.join(str(tmp_path), "step_0", "w.npy"),
            np.ones((2, 2), np.float32))
    with pytest.raises(CheckpointIntegrityError, match="shape"):
        ckpt.restore_leaf(0, "w")
    np.save(os.path.join(str(tmp_path), "step_0", "w.npy"),
            np.ones((4, 4), np.float64))
    with pytest.raises(CheckpointIntegrityError, match="dtype"):
        ckpt.restore_leaf(0, "w")
    assert ckpt.stats["ckpt_verify_fail"] == 2


def test_async_save_failure_recorded_and_reraised(tmp_path):
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    ckpt.save(0, {"w": np.ones(8, np.float32)})
    ckpt.wait()
    ckpt.dir = str(tmp_path / "blocked")
    with open(ckpt.dir, "w") as f:
        f.write("not a directory")
    ckpt.save(1, {"w": np.ones(8, np.float32)})      # async: no raise yet
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        ckpt.save(2, {"w": np.ones(8, np.float32)})  # surfaced HERE
    assert ckpt.stats["save_errors"] == 1
    assert ckpt._error is None


def test_steps_cross_between_the_packages(tmp_path):
    """A step the JAX ``Checkpointer`` wrote restores in the port's and the
    reverse, with the same keys, files and digests."""
    state = _state(2)
    jckpt.Checkpointer(str(tmp_path / "jax"), async_save=False).save(
        3, state)
    Checkpointer(str(tmp_path / "port"), async_save=False).save(3, state)
    assert _manifest(tmp_path / "jax", 3) == _manifest(tmp_path / "port", 3)
    got = Checkpointer(str(tmp_path / "jax")).restore(3, state)
    back = jckpt.Checkpointer(str(tmp_path / "port")).restore(3, state)
    for (_, a), (_, b), (_, c) in zip(_flatten(got), _flatten(back),
                                      _flatten(state)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(np.asarray(b), c)
    assert jckpt.Checkpointer(str(tmp_path / "port")).restore_leaf(
        3, "params__layers__1").dtype == np.int32


def test_bf16_leaf_round_trip_needs_no_numpy_bfloat16(tmp_path):
    """A bf16 tensor is written as uint16 bits with dtype "bfloat16",
    digested over those bits, and restored (also after a bit flip is
    caught) in a process that never imports JAX."""
    code = (
        "import sys, numpy as np, torch\n"
        "from repro_torch.checkpoint import Checkpointer, "
        "CheckpointIntegrityError\n"
        "from repro_torch.core import digest_array\n"
        "from repro_torch.distributed import FaultInjector\n"
        f"d = {str(tmp_path)!r}\n"
        "x = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))"
        ".to(torch.bfloat16)\n"
        "c = Checkpointer(d, async_save=False)\n"
        "c.save(0, {'w': x}); c.save(1, {'w': x * 2})\n"
        "got = c.restore(0, {'w': x})['w']\n"
        "assert got.dtype == torch.bfloat16 and torch.equal(got, x)\n"
        "import json\n"
        "m = json.load(open(d + '/step_1/manifest.json'))['leaves']['w']\n"
        "assert m['dtype'] == 'bfloat16' and m['shape'] == [6, 5]\n"
        "bits = (x * 2).view(torch.uint16).numpy()\n"
        "assert m['digest'] == digest_array(bits)\n"
        "FaultInjector(None, seed=0).corrupt_checkpoint_leaf(d, 1, 'w')\n"
        "step, leaf = c.restore_leaf_fallback('w')\n"
        "assert step == 0 and torch.equal(leaf, x)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout
