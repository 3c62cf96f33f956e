"""2PS-L in PyTorch: the port's counterpart of ``repro.core``.

The same declarative ``PartitionerSpec``s, executed by one streaming engine
(``run_spec``) whose device state lives in torch tensors — on the card by
default, on the CPU when asked.  This slice ports 2PS-L (flat and
host-aware); ``build_partitioner`` names the ROADMAP item for every other
registered spec.
"""
from .clustering import (ClusteringResult, cluster_sequential,
                         default_max_vol, streaming_clustering)
from .engine import (PartitionRunResult, StreamingPartitioner, StreamPass,
                     build_partitioner, compute_degrees_streaming,
                     resolve_device, run_spec)
from .mapping import map_clusters_lpt
from .metrics import (PartitionQuality, capacity, cross_host_replicas,
                      cross_host_replication_factor, host_assignment,
                      quality_from_assignment, quality_from_bitmatrix)
from .specs import (BufferedSpec, DBHSpec, HDRFSpec, HEPSpec,
                    PartitionerSpec, SpecError, SPEC_REGISTRY,
                    StatelessSpec, TwoPSLSpec, spec_for, spec_from_dict)
from .stream import (BYTES_PER_EDGE, EdgeStream, InMemoryEdgeStream,
                     MemmapEdgeStream, ThrottledEdgeStream, compute_degrees)

__all__ = [
    "ClusteringResult", "cluster_sequential", "default_max_vol",
    "streaming_clustering", "map_clusters_lpt", "PartitionQuality",
    "capacity", "quality_from_assignment", "quality_from_bitmatrix",
    "cross_host_replicas", "cross_host_replication_factor",
    "host_assignment", "PartitionRunResult", "BYTES_PER_EDGE",
    "EdgeStream", "InMemoryEdgeStream", "MemmapEdgeStream",
    "ThrottledEdgeStream", "compute_degrees",
    "PartitionerSpec", "TwoPSLSpec", "HDRFSpec", "DBHSpec", "StatelessSpec",
    "HEPSpec", "BufferedSpec",
    "SpecError", "SPEC_REGISTRY", "spec_for", "spec_from_dict",
    "StreamingPartitioner", "StreamPass", "build_partitioner", "run_spec",
    "compute_degrees_streaming", "resolve_device",
]
