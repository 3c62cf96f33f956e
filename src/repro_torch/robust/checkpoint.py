"""Chunk-boundary checkpoints of the streaming engine's pass state.

2PS-L's whole point is partitioning graphs whose edge streams dwarf
memory — and at that scale wall-clock is long enough that a crash
mid-pass is the normal case, not the exception.  The saving grace of the
paper's design is that everything the engine carries *between* chunks is
the small O(|V|) per-vertex state (replication bit-matrix, cluster
volumes, degrees, partition sizes), never the O(|E|) stream.  So a
checkpoint at a chunk boundary is cheap: snapshot that state plus the
cursor (pass index, next chunk, edge offset), and a resumed run replays
the remaining chunks into **bit-identical** final assignments — the chunk
kernels are deterministic functions of (state, chunk), and the stream
re-delivers the same chunks in the same order.

A copy of the reference package's ``robust/checkpoint.py``: the same
layout, meta and array dtypes, so a checkpoint written by either package
resumes in the other (the port's engine stores its int32 word tensors as
the reference's uint32 words).

Layout (one directory per checkpoint, atomic tmp+rename)::

    <dir>/ckpt_<pass:02d>_<chunk:08d>/
      manifest.json    meta (spec hash, k, graph geometry, cursor,
                       pass_counts, resumes) + array catalog
      arr_*.npy        device-state leaves, partitioner host-state
                       leaves, and — for in-memory runs only — the
                       partial assignment

Memmap-backed runs (``run_spec(out_path=...)``) do **not** copy the
assignment into the checkpoint: the engine flushes the memmap before the
snapshot and records its write position; on resume the same ``out_path``
is re-opened in place and every row at or beyond the checkpointed cursor
is rewritten by the replay, so a torn post-checkpoint write can never
survive into the final artifact.

The directory-name encoding makes "latest" a lexical ``max()`` and means
an interrupted checkpoint write (still ``*.tmp``) is invisible to
``latest_checkpoint``.  ``keep_n`` bounds disk: older checkpoints are
deleted after each successful save.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from dataclasses import dataclass, field

import numpy as np

from .integrity import save_json_atomic

__all__ = ["CheckpointMismatchError", "EngineCheckpoint",
           "crash_after_checkpoints", "latest_checkpoint",
           "load_engine_checkpoint", "save_engine_checkpoint", "spec_hash"]

_PREFIX = "ckpt_"
_MANIFEST = "manifest.json"


class CheckpointMismatchError(ValueError):
    """A checkpoint does not belong to this (spec, stream, k, out) run."""


def spec_hash(spec) -> str:
    """Stable fingerprint of a ``PartitionerSpec`` — resume refuses to mix
    state produced under different algorithm hyper-parameters."""
    blob = json.dumps(spec.to_dict(), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


@dataclass
class EngineCheckpoint:
    """One chunk-boundary snapshot (see module docstring).

    ``meta`` carries the scalars::

        spec_hash, algorithm, k, num_edges, num_vertices, chunk_size,
        pass_index     index into partitioner.passes() of the pass in
                       flight
        next_chunk     first chunk index the resumed pass must process
        edge_lo        assignment row the next writeback starts at
        assigned       rows assigned so far in the in-flight pass
        pass_counts    completed passes' assignment counts
        resumes        how many resumes produced the state so far
        assignment_in_checkpoint   True for in-memory runs

    ``device_state`` is the engine's state pytree materialized to host
    (the plug-in protocol keeps it a flat ``{name: array}`` dict);
    ``host_state`` is whatever ``StreamingPartitioner.host_state()``
    returned (host-folded bit matrices, cluster tables, ...).
    """

    meta: dict
    device_state: dict = field(default_factory=dict)
    host_state: dict = field(default_factory=dict)
    assignment: np.ndarray | None = None


def crash_after_checkpoints(written: int) -> None:
    """Deterministic crash hook for the crash-resume tests and the CI
    smoke stages: die hard (``os._exit`` — no atexit, no flush) once
    ``written`` reaches ``REPRO_CRASH_AFTER_CHECKPOINTS``.  A no-op when
    the environment variable is unset or 0."""
    limit = int(os.environ.get("REPRO_CRASH_AFTER_CHECKPOINTS", "0") or 0)
    if limit and written >= limit:
        os._exit(137)


def _dirname(pass_index: int, next_chunk: int) -> str:
    return f"{_PREFIX}{pass_index:02d}_{next_chunk:08d}"


def save_engine_checkpoint(directory: str, ckpt: EngineCheckpoint, *,
                           keep_n: int = 2) -> str:
    """Atomically persist ``ckpt``; returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, _dirname(ckpt.meta["pass_index"],
                                             ckpt.meta["next_chunk"]))
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    groups = {"device": ckpt.device_state, "host": ckpt.host_state}
    if ckpt.assignment is not None:
        groups["assignment"] = {"rows": ckpt.assignment}
    catalog = {}
    for group, leaves in groups.items():
        for key in sorted(leaves):
            arr = np.asarray(leaves[key])
            fname = f"arr_{len(catalog):05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            catalog[f"{group}::{key}"] = fname
    arrays["catalog"] = catalog
    save_json_atomic(os.path.join(tmp, _MANIFEST),
                     {"meta": ckpt.meta, **arrays})
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _cleanup(directory, keep_n)
    return final


def _cleanup(directory: str, keep_n: int) -> None:
    done = sorted(d for d in os.listdir(directory)
                  if d.startswith(_PREFIX) and not d.endswith(".tmp"))
    for d in done[:-keep_n]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_checkpoint(directory: str) -> str | None:
    """Path of the newest complete checkpoint in ``directory`` (lexical
    max of the ``ckpt_<pass>_<chunk>`` names — progression order), or
    None when the directory holds none."""
    if not os.path.isdir(directory):
        return None
    done = [d for d in os.listdir(directory)
            if d.startswith(_PREFIX) and not d.endswith(".tmp")
            and os.path.exists(os.path.join(directory, d, _MANIFEST))]
    return os.path.join(directory, max(done)) if done else None


def load_engine_checkpoint(directory: str) -> EngineCheckpoint | None:
    """Load the latest checkpoint under ``directory`` (None if empty)."""
    path = latest_checkpoint(directory)
    if path is None:
        return None
    with open(os.path.join(path, _MANIFEST)) as f:
        doc = json.load(f)
    device, host, assignment = {}, {}, None
    for full_key, fname in doc["catalog"].items():
        group, key = full_key.split("::", 1)
        arr = np.load(os.path.join(path, fname))
        if group == "device":
            device[key] = arr
        elif group == "host":
            host[key] = arr
        elif group == "assignment":
            assignment = arr
        else:
            raise CheckpointMismatchError(
                f"{path}: unknown checkpoint array group {group!r}")
    return EngineCheckpoint(meta=doc["meta"], device_state=device,
                            host_state=host, assignment=assignment)


def check_compatible(meta: dict, spec, stream, k: int,
                     out_path: str | None) -> None:
    """Refuse to resume against a different spec, graph, k, or output
    modality (in-memory vs memmap)."""
    want = spec_hash(spec)
    if meta["spec_hash"] != want:
        raise CheckpointMismatchError(
            f"checkpoint was written by spec {meta['algorithm']!r} "
            f"(hash {meta['spec_hash']}), this run uses hash {want} — "
            f"resume requires the identical PartitionerSpec")
    for name, got in (("k", k), ("num_edges", stream.num_edges),
                      ("num_vertices", stream.num_vertices)):
        if int(meta[name]) != int(got):
            raise CheckpointMismatchError(
                f"checkpoint {name}={meta[name]} does not match this "
                f"run's {name}={got}")
    if meta["assignment_in_checkpoint"] == (out_path is not None):
        raise CheckpointMismatchError(
            "checkpoint and run disagree on the assignment sink: "
            "resume an out_path= run with the same out_path, and an "
            "in-memory run without one")
    if out_path is not None and not os.path.exists(out_path):
        raise CheckpointMismatchError(
            f"resume needs the partial assignment memmap at {out_path}, "
            f"which does not exist")
