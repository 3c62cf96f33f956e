"""Edge partitioning in PyTorch: the port's counterpart of ``repro.core``.

The same declarative ``PartitionerSpec``s, executed by one streaming engine
(``run_spec``) whose device state lives in torch tensors — on the card by
default, on the CPU when asked.  Every registered spec runs (``PORTED`` is
the whole registry): 2PS-L and 2PS-HDRF (flat and host-aware), HDRF and
Greedy, DBH, Grid and Random, HEP and buffered re-streaming.  A run
persists as a ``PartitionArtifact`` in the reference's format (manifest v4,
halo and host plans, local graphs).  The ``run_*`` / ``PARTITIONERS`` entry
points are shims over ``run_spec``.
"""
from .artifact import ASSIGNMENT_FILE, PartitionArtifact
from .clustering import (ClusteringResult, cluster_in_memory_scan,
                         cluster_sequential, default_max_vol,
                         streaming_clustering)
from .engine import (PORTED, PartitionRunResult, StreamingPartitioner,
                     StreamPass, build_partitioner, compute_degrees_streaming,
                     resolve_device, run_spec)
from .mapping import map_clusters_lpt, map_clusters_lpt_torch
from .metrics import (PartitionQuality, capacity, cross_host_replicas,
                      cross_host_replication_factor, host_assignment,
                      quality_from_assignment, quality_from_bitmatrix)
from .pipeline import (PARTITIONERS, run_2ps_hdrf, run_2psl, run_buffered,
                       run_dbh, run_greedy, run_grid, run_hdrf, run_hep,
                       run_partitioner, run_random)
from .specs import (BufferedSpec, DBHSpec, HDRFSpec, HEPSpec,
                    PartitionerSpec, SpecError, SPEC_REGISTRY,
                    StatelessSpec, TwoPSLSpec, spec_for, spec_from_dict)
from .stream import (BYTES_PER_EDGE, EdgeStream, InMemoryEdgeStream,
                     MemmapEdgeStream, ThrottledEdgeStream, compute_degrees)

__all__ = [
    "ClusteringResult", "cluster_in_memory_scan", "cluster_sequential",
    "default_max_vol", "streaming_clustering", "map_clusters_lpt",
    "map_clusters_lpt_torch", "PartitionQuality",
    "capacity", "quality_from_assignment", "quality_from_bitmatrix",
    "cross_host_replicas", "cross_host_replication_factor",
    "host_assignment", "PARTITIONERS",
    "PartitionRunResult", "run_2ps_hdrf", "run_2psl", "run_buffered",
    "run_dbh", "run_greedy", "run_grid",
    "run_hdrf", "run_hep", "run_partitioner", "run_random",
    "BYTES_PER_EDGE",
    "EdgeStream", "InMemoryEdgeStream", "MemmapEdgeStream",
    "ThrottledEdgeStream", "compute_degrees",
    "PartitionerSpec", "TwoPSLSpec", "HDRFSpec", "DBHSpec", "StatelessSpec",
    "HEPSpec", "BufferedSpec",
    "SpecError", "SPEC_REGISTRY", "spec_for", "spec_from_dict",
    "StreamingPartitioner", "StreamPass", "build_partitioner", "PORTED",
    "run_spec",
    "compute_degrees_streaming", "resolve_device",
    "ASSIGNMENT_FILE", "PartitionArtifact",
]
