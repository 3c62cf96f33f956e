"""Fault-tolerant checkpointing (numpy files), the counterpart of
``repro.checkpoint.manager``, in the reference's format, so that a
checkpoint of either package restores through the other's
``restore_checkpoint``:

* ``step_XXXXXXXXXX/`` holds ``manifest.json`` (step, time, and per leaf
  its file, shape and dtype) and one ``leaf_NNNNN.npy`` per leaf; a leaf's
  key joins its path with ``::`` (dict keys, list indices), and leaves are
  numbered in the sorted order of their keys, as the reference numbers
  them;
* **atomic**: writes go to ``step_XXXXXXXXXX.tmp``, renamed only when the
  manifest is written;
* **async**: ``save`` copies the tree to host numpy arrays *before* the
  writer thread starts.  The reference's JAX arrays are immutable; the
  port's tensors are updated in place by the next step, and on the CPU
  ``tensor.numpy()`` is a view, so the snapshot must be a copy;
* **bounded**: keeps the newest ``keep_n`` steps.

A bfloat16 leaf is written byte for byte as the reference writes one
(``np.save`` of an ``ml_dtypes.bfloat16`` array: dtype descriptor ``<V2``,
the manifest's dtype ``bfloat16``), from the tensor's raw 16-bit words, so
no ``ml_dtypes`` is needed; restore returns such a leaf, the port's or the
reference's, as a CPU ``torch.bfloat16`` tensor of the same bits (the
manifest names the dtype; numpy alone would give raw ``V2`` words, as the
reference's own restore does).  Every other leaf restores as a numpy
array; the caller moves them to its state's devices and dtypes.

A tree of DTensors (a state sharded on a ``DeviceMesh``) is saved whole:
every rank gathers each leaf (``full_tensor``, a collective, so ``save``
is called on every rank, and the snapshot is taken before the writer
starts), and rank 0 alone writes, the same files an unsharded save of the
same values writes.  A blocking save returns on every rank once the files
are in place; after an async one, ``CheckpointManager.wait`` on every rank
does.  ``runtime.elastic_restore`` places a restored tree on any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

_SEP = "::"


def _flatten_with_paths(tree, prefix=()) -> dict:
    """{key: leaf} in the reference's path order (dict keys sorted, list
    indices in order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_with_paths(v, prefix + (str(i),)))
        return out
    return {_SEP.join(prefix): tree}


def _unflatten_like(tree, values: dict, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unflatten_like(v, values, prefix + (str(i),))
                for i, v in enumerate(tree)]
    return values[_SEP.join(prefix)]


def _is_dtensor(x) -> bool:
    from ..dist.sharding import is_dtensor
    return is_dtensor(x)


def _snapshot(leaf):
    """A host copy of one leaf: (array to write, manifest dtype); a
    DTensor's whole value."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            words = t.contiguous().view(torch.int16).numpy()
            return words.view(np.dtype("V2")), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _save_npy(path: str, arr) -> None:
    """``np.save``; a bf16 leaf (raw words as ``V2``) is written with the
    descriptor ``np.save`` gives an ``ml_dtypes.bfloat16`` array."""
    if arr.dtype == np.dtype("V2"):
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).tobytes())
        return
    np.save(path, arr)


def save_checkpoint(directory: str, step: int, tree, *, keep_n: int = 3,
                    blocking: bool = True):
    """Snapshot (copied to the host now) + write.  Returns the writer
    thread if blocking=False (None on a rank that does not write).  A tree
    with DTensor leaves is saved on every rank, written by rank 0 (a
    blocking save waits for the files on every rank)."""
    leaves = _flatten_with_paths(tree)
    distributed = any(_is_dtensor(v) for v in leaves.values())
    host = {k: _snapshot(v) for k, v in leaves.items()}
    if distributed:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            host = None

    def _write():
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for i, (key, (arr, dtype)) in enumerate(sorted(host.items())):
            fname = f"leaf_{i:05d}.npy"
            _save_npy(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _cleanup(directory, keep_n)

    if host is None:
        if blocking:
            _barrier()
        return None
    if blocking:
        _write()
        if distributed:
            _barrier()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def _barrier():
    import torch.distributed as dist
    dist.barrier()


def _cleanup(directory: str, keep_n: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep_n]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def _load_leaf(path: str, dtype: str):
    if dtype != "bfloat16":
        return np.load(path)
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, _, _ = read(f)
        words = np.frombuffer(f.read(), dtype=np.int16).reshape(shape)
    return torch.from_numpy(words.copy()).view(torch.bfloat16)


def restore_checkpoint(directory: str, target_tree, step: int | None = None):
    """Restore into the structure of ``target_tree`` (shape-checked).
    Returns (tree of numpy arrays, bf16 leaves as CPU tensors; step), or
    (None, None) if nothing is saved."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None, None
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    restored = {}
    for key, leaf in _flatten_with_paths(target_tree).items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = _load_leaf(os.path.join(d, meta["file"]), meta["dtype"])
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else None
        if want is not None and tuple(arr.shape) != want:
            raise ValueError(
                f"leaf {key!r}: checkpoint shape {tuple(arr.shape)} != "
                f"{want}")
        restored[key] = arr
    return _unflatten_like(target_tree, restored), step


class CheckpointManager:
    """Periodic async checkpointing for the training loop."""

    def __init__(self, directory: str, *, interval: int = 100,
                 keep_n: int = 3, async_save: bool = True):
        self.directory = directory
        self.interval = interval
        self.keep_n = keep_n
        self.async_save = async_save
        self._pending: threading.Thread | None = None
        self._distributed = False

    def maybe_save(self, step: int, tree) -> bool:
        if step % self.interval:
            return False
        self.wait()
        self._distributed = any(_is_dtensor(v) for v in
                                _flatten_with_paths(tree).values())
        self._pending = save_checkpoint(
            self.directory, step, tree, keep_n=self.keep_n,
            blocking=not self.async_save)
        return True

    def wait(self):
        """The last save's files in place (on every rank, after a
        distributed async save: call it on every rank)."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._distributed and self.async_save:
            _barrier()
        self._distributed = False

    def restore_latest(self, target_tree):
        self.wait()
        return restore_checkpoint(self.directory, target_tree)
