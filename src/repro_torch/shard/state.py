"""Serializable per-shard engine state (see docs/distributed.md): a copy
of the reference package's ``shard/state.py``, so that a state file
written by either package loads in the other.

A ``ShardState`` is what one worker publishes at a round boundary: the
same flat ``{name: array}`` device-state + host-state dicts the engine
checkpoint store (``repro_torch.robust.checkpoint``) already snapshots
(numpy, in the reference's layout: word matrices as uint32), plus a JSON
``meta`` dict and optional extra array payloads (the final exchange
carries the rank's assignment slice under ``arrays["asg"]``).

On disk a ShardState is one ``.npz`` written atomically
(tmp+rename via ``savez_atomic``), so an exchange peer polling for the
file can never observe a torn write: existence implies completeness.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..robust.integrity import savez_atomic

__all__ = ["ShardState"]

_META_KEY = "__meta__"


@dataclass
class ShardState:
    """One worker's state at a rendezvous point.

    ``meta`` must be JSON-serializable (rank, round, pass index,
    pass-count / checksum bookkeeping); ``device`` / ``host`` mirror the
    engine's state dicts; ``arrays`` carries any extra payloads.
    """

    meta: dict
    device: dict = field(default_factory=dict)
    host: dict = field(default_factory=dict)
    arrays: dict = field(default_factory=dict)

    @classmethod
    def snapshot(cls, meta: dict, device: dict | None = None,
                 host: dict | None = None,
                 arrays: dict | None = None) -> "ShardState":
        """Build a state whose array leaves are materialized **copies** —
        safe to hand to another thread while this worker keeps mutating
        its own buffers (the in-process exchange shares objects)."""
        cp = lambda d: {k: np.array(np.asarray(v), copy=True)
                        for k, v in (d or {}).items()}
        return cls(meta=dict(meta), device=cp(device), host=cp(host),
                   arrays=cp(arrays))

    def save(self, path: str) -> None:
        """Atomically persist as one ``.npz`` (group-prefixed keys)."""
        entries = {_META_KEY: np.frombuffer(
            json.dumps(self.meta).encode(), dtype=np.uint8)}
        for prefix, group in (("dev", self.device), ("host", self.host),
                              ("x", self.arrays)):
            for key, arr in group.items():
                entries[f"{prefix}.{key}"] = np.asarray(arr)
        savez_atomic(path, **entries)

    @classmethod
    def load(cls, path: str) -> "ShardState":
        with np.load(path) as z:
            meta = json.loads(bytes(z[_META_KEY]).decode())
            out = cls(meta=meta)
            for name in z.files:
                if name == _META_KEY:
                    continue
                prefix, key = name.split(".", 1)
                group = {"dev": out.device, "host": out.host,
                         "x": out.arrays}[prefix]
                group[key] = z[name]
        return out
