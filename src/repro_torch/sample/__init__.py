"""Partition-aware sampling, the port's counterpart of ``repro.sample``.

``local_graph`` lowers a ``PartitionArtifact`` into per-partition CSC/CSR
serving structure (``local_csc_p{i}.npz`` next to the manifest, artifact
format v3) in one chunked sweep; ``build_adjacency`` builds every CSR/CSC,
buffered re-streaming's too.  The neighbour sampler and
the feature cache come with the GNN serving slice.
"""
from .local_graph import (LocalGraph, PartitionedGraph, build_adjacency,
                          build_local_graphs, load_local_graph,
                          local_graphs_manifest_entry)

__all__ = [
    "LocalGraph", "PartitionedGraph", "build_adjacency",
    "build_local_graphs", "load_local_graph", "local_graphs_manifest_entry",
]
