"""GraphBatch builders for the three GNN data regimes: full-graph
(Cora/ogbn-products-like), batched small molecules, and sampled subgraphs
(see sampler.py).  A copy of the reference package's
``data/gnn_batches.py`` (numpy only); the models take the arrays as
tensors."""
from __future__ import annotations

import numpy as np

from .synthetic_graphs import planted_partition_graph


def full_graph_batch(n_nodes: int, n_edges: int, d_feat: int,
                     n_classes: int = 8, n_communities: int = 32,
                     seed: int = 0, with_coords: bool = False):
    """Synthetic citation-style graph: community structure drives both the
    features and the labels, so the node-classification task is learnable."""
    rng = np.random.default_rng(seed)
    nodes_per = n_nodes // n_communities
    intra = int(n_edges * 0.8 / n_communities)
    inter = n_edges - intra * n_communities
    edges = planted_partition_graph(n_communities, nodes_per, intra, inter,
                                    seed=seed)
    edges = edges[edges.max(axis=1) < n_nodes]
    E = len(edges)
    comm = np.arange(n_nodes) // nodes_per
    comm = np.minimum(comm, n_communities - 1)
    centers = rng.standard_normal((n_communities, d_feat)) * 1.5
    feats = centers[comm] + rng.standard_normal((n_nodes, d_feat))
    labels = comm % n_classes
    batch = {
        "nodes": feats.astype(np.float32),
        "edges": edges.astype(np.int32),
        "edge_attr": None,
        "node_mask": np.ones(n_nodes, np.float32),
        "edge_mask": np.ones(E, np.float32),
        "graph_ids": np.zeros(n_nodes, np.int32),
        "labels": labels.astype(np.int32),
    }
    if with_coords:
        batch["coords"] = (centers[comm, :3] if d_feat >= 3 else
                           rng.standard_normal((n_nodes, 3))
                           ).astype(np.float32) \
            + rng.standard_normal((n_nodes, 3)).astype(np.float32) * 0.1
    return batch


def molecule_batch(batch_size: int, n_nodes: int = 30, n_edges: int = 64,
                   n_species: int = 4, seed: int = 0,
                   one_hot_species: bool = False):
    """Padded batch of small 3D molecular graphs flattened into one
    disjoint graph (graph_ids routes the readout)."""
    rng = np.random.default_rng(seed)
    B = batch_size
    N, E = n_nodes, n_edges
    coords = rng.standard_normal((B, N, 3)).astype(np.float32) * 1.5
    species = rng.integers(0, n_species, (B, N))
    # kNN-ish edges: random pairs biased to short distance
    src = rng.integers(0, N, (B, E))
    dst = rng.integers(0, N, (B, E))
    offs = (np.arange(B) * N)[:, None]
    edges = np.stack([(src + offs).reshape(-1),
                      (dst + offs).reshape(-1)], axis=1)
    # synthetic regression target: function of pairwise distances
    d = np.linalg.norm(coords[:, :, None] - coords[:, None, :], axis=-1)
    energy = np.exp(-d).sum(axis=(1, 2)) / N
    nodes = species.reshape(-1).astype(np.int32)
    if one_hot_species:
        nodes = np.eye(n_species, dtype=np.float32)[nodes]
    return {
        "nodes": nodes,
        "coords": coords.reshape(-1, 3),
        "edges": edges.astype(np.int32),
        "edge_attr": None,
        "node_mask": np.ones(B * N, np.float32),
        "edge_mask": (edges[:, 0] != edges[:, 1]).astype(np.float32),
        "graph_ids": np.repeat(np.arange(B), N).astype(np.int32),
        "labels": np.zeros(B * N, np.int32),
        "energy_target": energy.astype(np.float32),
    }, B
