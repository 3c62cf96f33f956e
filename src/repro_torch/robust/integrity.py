"""Artifact integrity: content checksums + atomic file replacement.

Partitioning a billion-edge graph is hours of wall-clock; the artifact it
produces is consumed by every downstream job (halo planning, SPMD
training, serving).  A crash mid-save, a torn write, or silent disk
corruption must therefore never yield a *loadable-but-wrong* artifact.
Two mechanisms, both used by ``repro_torch.core.artifact`` (manifest format
v4); a copy of the reference package's ``robust/integrity.py``:

* **atomic replacement** (``atomic_path`` / ``save_json_atomic`` /
  ``savez_atomic``): every file is written to a ``*.tmp`` sibling and
  ``os.replace``d into place (tmp+rename).  The
  manifest is always written *last*, so a crash at any point leaves
  either the previous complete artifact or no manifest at all — never a
  fresh manifest pointing at half-written sidecars.
* **content checksums** (``file_checksum`` / ``checksum_files`` /
  ``verify_checksums``): the manifest's ``integrity`` block records a
  digest per data file (assignment memmap, ``halo_plan.npz``,
  ``host_plan.npz``, per-partition ``local_csc_p*.npz``), verified on
  ``PartitionArtifact.load`` — a stale manifest over newer sidecars (or
  any bit flip) is rejected instead of silently served.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os

__all__ = ["ArtifactIntegrityError", "CHECKSUM_ALGORITHM", "atomic_path",
           "checksum_files", "file_checksum", "save_json_atomic",
           "savez_atomic", "verify_checksums"]

#: Digest recorded in manifests.  sha256 everywhere: collision-resistant
#: enough to double as a run-identity fingerprint in CI, and the streamed
#: hashing below keeps memory O(buffer) for graph-sized assignment files.
CHECKSUM_ALGORITHM = "sha256"


class ArtifactIntegrityError(ValueError):
    """A persisted file does not match the digest its manifest recorded."""


def file_checksum(path: str, algorithm: str = CHECKSUM_ALGORITHM,
                  buffer_bytes: int = 1 << 22) -> str:
    """Streamed content digest of ``path`` as ``"<algorithm>:<hex>"``."""
    h = hashlib.new(algorithm)
    with open(path, "rb") as f:
        while True:
            block = f.read(buffer_bytes)
            if not block:
                break
            h.update(block)
    return f"{algorithm}:{h.hexdigest()}"


def checksum_files(dirpath: str, names) -> dict:
    """``{name: digest}`` for every existing ``name`` under ``dirpath``."""
    out = {}
    for name in names:
        p = os.path.join(dirpath, name)
        if os.path.exists(p):
            out[name] = file_checksum(p)
    return out


def verify_checksums(dirpath: str, files: dict, *, label: str = "") -> None:
    """Check every recorded digest; raise ``ArtifactIntegrityError`` on the
    first missing or mismatching file (message names file + both digests)."""
    label = label or dirpath
    for name, want in files.items():
        p = os.path.join(dirpath, name)
        if not os.path.exists(p):
            raise ArtifactIntegrityError(
                f"{label}: {name} is listed in the manifest integrity "
                f"block but missing on disk")
        algorithm = want.split(":", 1)[0] if ":" in want else \
            CHECKSUM_ALGORITHM
        got = file_checksum(p, algorithm)
        if got != want:
            raise ArtifactIntegrityError(
                f"{label}: {name} failed its integrity check "
                f"(manifest {want}, on disk {got}) — the artifact is "
                f"corrupt or was written by an interrupted save; "
                f"re-partition or restore from a good copy "
                f"(load(verify=False) bypasses verification)")


@contextlib.contextmanager
def atomic_path(final: str, suffix: str = ""):
    """Yield a tmp sibling path; ``os.replace`` it onto ``final`` only if
    the block completes (the tmp file is removed on error).  ``suffix``
    must be kept when the writer derives the format from the extension
    (``np.savez`` appends ``.npz`` unless the name already ends with it).
    """
    tmp = final + ".tmp" + suffix
    try:
        yield tmp
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_json_atomic(path: str, obj, *, indent: int = 2) -> None:
    with atomic_path(path) as tmp:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent)
            f.flush()
            os.fsync(f.fileno())


def savez_atomic(path: str, **arrays) -> None:
    """Atomic ``np.savez`` (the tmp name keeps the ``.npz`` extension so
    numpy does not append a second one before the rename)."""
    import numpy as np
    with atomic_path(path, suffix=".npz") as tmp:
        np.savez(tmp, **arrays)
