"""Synthetic graph generators for the partitioning benchmarks (a copy of the
reference package's ``data/synthetic_graphs.py``).

The paper evaluates on real graphs up to 64B edges; these generators
reproduce the two structural *classes* it distinguishes at reduced scale:

* ``rmat_graph``              — power-law, social-network-like (OK/TW/FR-mini).
                                R-MAT (Chakrabarti et al.) with the classic
                                (0.57, 0.19, 0.19, 0.05) quadrant skew.
* ``planted_partition_graph`` — strong community structure, web-graph-like
                                (IT/UK/GSH-mini): most edges intra-cluster.

Both are fully vectorized numpy; deterministic under a seed.
"""
from __future__ import annotations

import numpy as np


def rmat_graph(scale: int, edge_factor: int = 16, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0,
               dedupe: bool = True) -> np.ndarray:
    """R-MAT graph with 2**scale vertices and ~edge_factor * 2**scale edges."""
    rng = np.random.default_rng(seed)
    n_edges = edge_factor << scale
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for level in range(scale):
        r = rng.random(n_edges)
        # quadrant: (0,0) w.p. a, (0,1) w.p. b, (1,0) w.p. c, (1,1) w.p. d
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src = (src << 1) | go_down
        dst = (dst << 1) | go_right
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]           # drop self-loops
    if dedupe:
        key = edges[:, 0].astype(np.int64) * (1 << scale) + edges[:, 1]
        _, idx = np.unique(key, return_index=True)
        edges = edges[np.sort(idx)]
    # compact vertex ids so |V| == number of touched vertices
    _, inv = np.unique(edges.reshape(-1), return_inverse=True)
    return inv.reshape(-1, 2).astype(np.int32)


def planted_partition_graph(n_clusters: int, nodes_per_cluster: int,
                            intra_edges_per_cluster: int,
                            inter_edges: int, seed: int = 0) -> np.ndarray:
    """Graph with planted communities: dense intra-cluster, sparse inter."""
    rng = np.random.default_rng(seed)
    V = n_clusters * nodes_per_cluster
    chunks = []
    for ci in range(n_clusters):
        base = ci * nodes_per_cluster
        e = rng.integers(0, nodes_per_cluster,
                         size=(intra_edges_per_cluster, 2)) + base
        chunks.append(e)
    inter = rng.integers(0, V, size=(inter_edges, 2))
    edges = np.concatenate(chunks + [inter], axis=0).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    rng.shuffle(edges)       # stream order should not leak the communities
    return np.ascontiguousarray(edges)


def scaled_benchmark_graphs(seed: int = 0) -> dict[str, np.ndarray]:
    """Reduced-scale stand-ins for the paper's Table III graphs.

    Names keep the paper's initials; sizes are scaled to a small budget
    (the paper's OK graph alone is 117M edges).  The social/web structural
    split that drives Figures 5 and 6 is preserved.
    """
    return {
        # social-network-like (power-law, hard to partition)
        "OK-mini": rmat_graph(14, edge_factor=24, seed=seed),
        "TW-mini": rmat_graph(15, edge_factor=16, seed=seed + 1),
        "FR-mini": rmat_graph(15, edge_factor=20, seed=seed + 2),
        # web-like (strong communities, easy to pre-partition)
        "IT-mini": planted_partition_graph(
            192, 128, 4000, 30_000, seed=seed + 3),
        "UK-mini": planted_partition_graph(
            384, 128, 4000, 60_000, seed=seed + 4),
    }
