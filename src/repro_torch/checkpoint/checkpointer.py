"""Checkpointing: async, sharded, rotated — the restart half of fault
tolerance (``repro/checkpoint/checkpointer.py`` at the same path).

Layout per step:  <dir>/step_<N>/
    manifest.json            tree structure + per-leaf metadata (+ digest)
    <leafkey>.npy            one file per leaf (host-gathered)
    COMMIT                   written last — a checkpoint without COMMIT is
                             torn and ignored by restore (crash-safe)

The layout, the leaf keys (``_key_of``: ``"slab3"``, ``"params__w"``) and
the digests are the JAX package's, so a step written by either package
restores in the other.

Restore is device-agnostic: leaves are loaded on host and placed on the
*current* device (``restore(..., device=)``), so a checkpoint restores onto
a shrunk or grown world (elastic rescale path). A state placed on a mesh
(leaves ``spmd.Sharded``) is saved leaf by leaf through the host, each
shard's block copied straight into the host array, so no card ever holds
more than its own blocks; the files are those of the same state on one
device, and ``restore(..., shardings=)`` places each leaf onto any mesh by
a matching tree of ``spmd.NamedSharding`` (``launch.mesh.opt_specs``: a
ZeRO-1 layout and the compressed step's residuals too, from an abstract
state with them), as JAX's mesh-agnostic restore does. A state may be nested
dicts, sequences and dataclasses (``train.TrainState``: leaves
``params__...``, ``opt__step``, ``opt__m__...``); its reference for a
restore may be a state of ``meta``-device tensors
(``train.abstract_train_state``), which gives each leaf's dtype.

Integrity: each leaf's fold64 content digest is computed at save time
(once, from the already-host-gathered array) and recorded in the
manifest. Every restore path re-digests the loaded bytes and validates
shape/dtype against the manifest — a silently bit-rotted or truncated
leaf raises ``CheckpointIntegrityError`` instead of feeding garbage back
into the job. ``restore_leaf_fallback`` turns that detection into
recovery: walk committed steps newest → oldest and return the first
copy of the leaf that verifies. Manifests written before digests existed
restore fine (the digest check is skipped when the key is absent).

bfloat16 leaves need no numpy bfloat16: a bf16 tensor is written as its
raw ``uint16`` bits with ``"dtype": "bfloat16"`` in the manifest, digested
over those bits, and read back as a ``torch.bfloat16`` tensor.

Async saves are not fire-and-forget: a failed background write is
recorded and re-raised at the next ``wait()`` or ``save()`` — the
caller that believes a checkpoint exists must find out it does not.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import torch_dtype
from repro_torch.core.integrity import digest_array

BF16 = "bfloat16"


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint leaf failed digest or shape/dtype validation."""


def _key_of(path) -> str:
    return "__".join(str(p) for p in path) or "leaf"


def _flatten(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """``[(path, leaf)]`` in the order and with the path entries of
    ``jax.tree_util.tree_flatten_with_path``: dict keys sorted, list and
    tuple indices, namedtuple and dataclass field names (a ``TrainState``
    as ``jax.tree_util.register_dataclass`` flattens it); ``None`` holds
    no leaf."""
    if tree is None:
        return []
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for f in dataclasses.fields(tree)
                for kv in _flatten(getattr(tree, f.name), path + (f.name,))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, path + (i,))]
    return [(path, tree)]


def _unflatten(tree: Any, leaf_fn, path: Tuple = ()) -> Any:
    """``tree`` with every leaf replaced by ``leaf_fn(path, leaf)``."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _unflatten(getattr(tree, f.name), leaf_fn,
                               path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaf_fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaf_fn, path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaf_fn, path + (i,))
                          for i, v in enumerate(tree))
    return leaf_fn(path, tree)


def _host_leaf(v: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the host array that is written (a private copy of a
    tensor; a placed leaf joined on the host; a bf16 leaf as its uint16
    bits) and its manifest dtype."""
    from repro_torch.distributed import spmd
    if isinstance(v, spmd.Sharded):
        v = v.full("cpu")
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(v)
    if arr.dtype.name == BF16:
        return arr.view(np.uint16), BF16
    return arr, str(arr.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 digest: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self.digest = digest
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.stats = {"ckpt_verify_fail": 0, "save_errors": 0}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, block: bool = False) -> None:
        """Snapshot on host, then write asynchronously (training continues
        while the write is in flight — compute/IO overlap). A pending
        failure from an earlier async write is raised here first: the
        caller must not keep rotating checkpoints on top of a save
        pipeline that is silently broken."""
        host_leaves = [(_key_of(p), *_host_leaf(v))
                       for p, v in _flatten(state)]
        self.wait()

        def write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {}
            for key, arr, dtype in host_leaves:
                fn = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
                np.save(os.path.join(tmp, fn), arr)
                entry = {"file": fn, "shape": list(arr.shape),
                         "dtype": dtype}
                if self.digest:
                    entry["digest"] = digest_array(arr)
                manifest[key] = entry
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump({"step": step, "leaves": manifest}, f)
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        def write_guarded():
            try:
                write()
            except BaseException as e:  # surfaced at next wait()/save()
                self.stats["save_errors"] += 1
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=write_guarded, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint save failed: {err!r}") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def _verified_leaf(self, step: int, key: str, meta: Dict,
                       path: str) -> Any:
        """Load one leaf and validate it against its manifest entry:
        shape and dtype must match exactly (a bfloat16 leaf is stored as
        uint16 bits), and (when the manifest carries one) the fold64
        digest of the loaded bytes must equal the digest recorded at save
        time. A bfloat16 leaf comes back as a CPU ``torch.bfloat16``
        tensor, any other as a numpy array."""
        arr = np.load(path)
        stored = "uint16" if meta["dtype"] == BF16 else meta["dtype"]
        if (list(arr.shape) != list(meta["shape"])
                or str(arr.dtype) != stored):
            self.stats["ckpt_verify_fail"] += 1
            raise CheckpointIntegrityError(
                f"checkpoint step {step} leaf {key!r}: file has "
                f"shape={arr.shape} dtype={arr.dtype}, manifest says "
                f"shape={tuple(meta['shape'])} dtype={meta['dtype']}")
        want = meta.get("digest")
        if want is not None and digest_array(arr) != want:
            self.stats["ckpt_verify_fail"] += 1
            raise CheckpointIntegrityError(
                f"checkpoint step {step} leaf {key!r}: content digest "
                f"mismatch (bit rot or torn write)")
        if meta["dtype"] == BF16:
            return torch.from_numpy(arr).view(torch.bfloat16)
        return arr

    def restore(self, step: int, abstract_state: Any,
                device: Optional[Any] = None, shardings: Any = None) -> Any:
        """Load ``step`` into the structure of ``abstract_state``, each
        leaf in its reference leaf's dtype. With ``device`` every leaf is
        a tensor there (device-agnostic restore); without, a leaf is a
        CPU tensor where its reference is a tensor or the leaf is
        bfloat16, and a numpy array otherwise. With ``shardings`` (a tree
        like the state of ``spmd.NamedSharding``) every leaf is placed
        from the host by its own, each shard a tensor of its own
        (``spmd.place(..., share=False)``: a state the shards update in
        place). Every leaf is digest/shape/dtype-verified before
        placement."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        if shardings is not None:
            from repro_torch.distributed import spmd
            placed = dict(_flatten(shardings))
            host = self.restore(step, abstract_state)

            def put(path, leaf):
                return spmd.place({"x": leaf}, {"x": placed[path]},
                                  consume=True, share=False)["x"]
            return _unflatten(host, put)

        def leaf(path, ref):
            key = _key_of(path)
            meta = manifest[key]
            arr = self._verified_leaf(step, key, meta,
                                      os.path.join(d, meta["file"]))
            want = getattr(ref, "dtype", None)
            if (device is None and not isinstance(arr, torch.Tensor)
                    and not isinstance(ref, torch.Tensor)):
                return arr if want is None else arr.astype(want)
            t = arr if isinstance(arr, torch.Tensor) \
                else torch.from_numpy(arr)
            if want is not None:
                t = t.to(torch_dtype(want))
            return t.to(device) if device is not None else t

        return _unflatten(abstract_state, leaf)

    def restore_leaf(self, step: int, key: str) -> Any:
        """Load ONE leaf of a committed checkpoint by its manifest key —
        the elastic-recovery path: a rank died, only its chunks need
        restoring, and re-reading the whole tree would stall recovery on
        I/O proportional to the world size instead of the loss. The leaf
        is digest/shape/dtype-verified before it is handed back."""
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        if key not in manifest:
            raise KeyError(f"checkpoint step {step} has no leaf {key!r}; "
                           f"has {sorted(manifest)[:8]}...")
        meta = manifest[key]
        return self._verified_leaf(step, key, meta,
                                   os.path.join(d, meta["file"]))

    def restore_leaf_fallback(self, key: str) -> Tuple[int, Any]:
        """Detection → recovery: return ``(step, leaf)`` from the NEWEST
        committed step whose copy of ``key`` verifies, skipping corrupted
        or missing copies. Raises ``CheckpointIntegrityError`` only when
        every retained step fails."""
        steps = self.all_steps()
        last_err: Optional[BaseException] = None
        for step in reversed(steps):
            try:
                return step, self.restore_leaf(step, key)
            except (CheckpointIntegrityError, KeyError, OSError,
                    ValueError) as e:
                last_err = e
        raise CheckpointIntegrityError(
            f"no committed step holds a valid copy of leaf {key!r} "
            f"(searched {len(steps)} steps)") from last_err

    def restore_latest(self, abstract_state: Any,
                       device: Optional[Any] = None) -> Any:
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        return self.restore(step, abstract_state, device)
