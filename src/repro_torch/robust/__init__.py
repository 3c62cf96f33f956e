"""``repro_torch.robust`` — crash-safe, fault-tolerant partitioning: the
port's copy of the reference package's ``robust`` modules.

Three pillars, threaded through the engine / artifact / serving layers
(user guide: docs/robustness.md):

* **engine checkpoints** (``checkpoint``): chunk-boundary snapshots of
  the engine's O(|V|) pass state, written atomically; ``run_spec(...,
  checkpoint_every_chunks=N, checkpoint_dir=..., resume_from=...)``
  resumes mid-pass with bit-identical final assignments.
* **fault injection + retry** (``faults``): ``FaultyStream`` injects
  deterministic chunk-indexed IO faults; ``ResilientStream`` validates
  and retries chunk reads with bounded backoff (``engine.io_retries``);
  ``ResilientFetcher`` degrades serving instead of crashing it.
* **artifact integrity** (``integrity``): content checksums recorded in
  the manifest (format v4) and verified on ``PartitionArtifact.load``;
  atomic tmp+rename writes with the manifest last, so a crash mid-save
  can never yield a loadable-but-wrong artifact.
"""
from .checkpoint import (CheckpointMismatchError, EngineCheckpoint,
                         latest_checkpoint, load_engine_checkpoint,
                         save_engine_checkpoint, spec_hash)
from .faults import (ChunkFault, ChunkReadError, FaultyStream,
                     ResilientFetcher, ResilientStream, RetryPolicy)
from .integrity import (ArtifactIntegrityError, CHECKSUM_ALGORITHM,
                        atomic_path, checksum_files, file_checksum,
                        save_json_atomic, savez_atomic, verify_checksums)

__all__ = [
    "CheckpointMismatchError", "EngineCheckpoint", "latest_checkpoint",
    "load_engine_checkpoint", "save_engine_checkpoint", "spec_hash",
    "ChunkFault", "ChunkReadError", "FaultyStream", "ResilientFetcher",
    "ResilientStream", "RetryPolicy",
    "ArtifactIntegrityError", "CHECKSUM_ALGORITHM", "atomic_path",
    "checksum_files", "file_checksum", "save_json_atomic", "savez_atomic",
    "verify_checksums",
]
