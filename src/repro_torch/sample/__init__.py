"""Partition-aware sampling, the port's counterpart of ``repro.sample``.

Only ``build_adjacency``, the one CSR/CSC builder, is here so far: buffered
re-streaming builds each window's mini-graph with it.  The local graphs,
the neighbour sampler and the feature cache come with the GNN serving
slice.
"""
from .local_graph import build_adjacency

__all__ = ["build_adjacency"]
