"""Partition-aware sampling and serving, the port's counterpart of
``repro.sample``.

``local_graph`` lowers a ``PartitionArtifact`` into per-partition CSC/CSR
serving structure (``local_csc_p{i}.npz`` next to the manifest, artifact
format v3) in one chunked sweep; ``build_adjacency`` builds every CSR/CSC,
buffered re-streaming's too.  ``neighbor``'s fan-out sampler draws k-hop
ego networks that stay partition-local and cross into halo-owned
neighbours only where the frontier demands it, and ``feature_cache``'s
degree-ordered hot-vertex cache serves remote-partition features without
a halo exchange on a hit.  ``launch/serve.py``'s ``serve_gnn`` wires the
three into a request loop.  All three are numpy copies of the reference's
modules, with the same ``sample.*`` spans and counters; the cache never
changes values, only latency and metrics, so a cached serve returns
bit-identical logits to an uncached one.
"""
from .feature_cache import HotVertexFeatureCache
from .local_graph import (LocalGraph, PartitionedGraph, build_adjacency,
                          build_local_graphs, load_local_graph,
                          local_graphs_manifest_entry)
from .neighbor import PartitionedNeighborSampler, minibatch_halo_plan

__all__ = [
    "HotVertexFeatureCache", "LocalGraph", "PartitionedGraph",
    "PartitionedNeighborSampler", "build_adjacency", "build_local_graphs",
    "load_local_graph", "local_graphs_manifest_entry", "minibatch_halo_plan",
]
