"""Neighbor sampling for minibatch GNN training (GraphSAGE-style fan-out):
a copy of the reference package's ``data/sampler.py`` (numpy only).

Thin compatibility shim: the adjacency build lives in
``repro_torch.sample.local_graph.build_adjacency`` (the single CSR/CSC
builder shared with the partition-aware serving sampler), and this module
keeps the original single-graph ``CSRGraph`` / ``NeighborSampler`` API for
the in-memory training path.  Partition-aware sampling against a
``PartitionArtifact`` is ``repro_torch.sample.PartitionedNeighborSampler``.

Semantics note: this sampler walks *out*-adjacency (sampled edges are
``(neighbor -> node)``); the serving sampler walks *in*-adjacency, the
message direction.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray
    indices: np.ndarray
    num_nodes: int

    @staticmethod
    def from_edges(edges: np.ndarray, num_nodes: int) -> "CSRGraph":
        from ..sample.local_graph import build_adjacency
        edges = np.asarray(edges)
        indptr, order = build_adjacency(edges, num_nodes, by="src")
        indices = (edges[order, 1].astype(np.int64) if len(order)
                   else np.empty(0, np.int64))
        return CSRGraph(indptr=indptr.astype(np.int64), indices=indices,
                        num_nodes=num_nodes)

    def degree(self, nodes):
        return self.indptr[nodes + 1] - self.indptr[nodes]


class NeighborSampler:
    """Uniform fan-out sampler producing fixed-shape subgraph batches."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...],
                 seed: int = 0):
        self.g = graph
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def sample(self, roots: np.ndarray):
        """Returns dict: nodes (unique ids), edges (local ids), masks, and
        root positions — fixed shapes given (len(roots), fanouts)."""
        g = self.g
        frontier = roots.astype(np.int64)
        all_src_g, all_dst_g = [], []
        for f in self.fanouts:
            deg = g.degree(frontier)                       # (F,)
            has = deg > 0
            # sample with replacement: offset = floor(u * deg)
            u = self.rng.random((len(frontier), f))
            off = (u * np.maximum(deg, 1)[:, None]).astype(np.int64)
            # zero-degree rows (incl. isolated trailing vertices, whose
            # indptr slot can equal len(indices)) must not be gathered
            rows = np.where(has[:, None], g.indptr[frontier][:, None] + off, 0)
            if len(g.indices) == 0:
                nbr = np.zeros_like(rows)
            else:
                nbr = g.indices[rows]                      # (F, f)
            src = np.where(has[:, None], nbr, -1)
            dst = np.repeat(frontier, f).reshape(len(frontier), f)
            all_src_g.append(src.reshape(-1))
            all_dst_g.append(dst.reshape(-1))
            frontier = np.unique(src[src >= 0]) if (src >= 0).any() \
                else np.array([0], np.int64)
        src_g = np.concatenate(all_src_g)
        dst_g = np.concatenate(all_dst_g)
        valid = src_g >= 0
        # relabel to local ids
        uniq, inv = np.unique(
            np.concatenate([roots, src_g[valid], dst_g[valid]]),
            return_inverse=True)
        n_root = len(roots)
        root_local = inv[:n_root]
        src_l = np.zeros_like(src_g)
        dst_l = np.zeros_like(dst_g)
        src_l[valid] = inv[n_root:n_root + valid.sum()]
        dst_l[valid] = inv[n_root + valid.sum():]
        return {
            "node_ids": uniq.astype(np.int64),         # global ids
            "edges": np.stack([src_l, dst_l], 1).astype(np.int32),
            "edge_mask": valid.astype(np.float32),
            "root_local": root_local.astype(np.int32),
        }

    def padded_batch(self, roots: np.ndarray, node_feats: np.ndarray,
                     labels: np.ndarray, *, max_nodes: int, max_edges: int):
        """Fixed-shape GraphBatch for jit: pads nodes/edges to static caps."""
        s = self.sample(roots)
        n = len(s["node_ids"])
        e = len(s["edges"])
        if n > max_nodes or e > max_edges:
            raise ValueError(f"sample exceeded caps: nodes {n}/{max_nodes} "
                             f"edges {e}/{max_edges}")
        nodes = np.zeros((max_nodes, node_feats.shape[1]), np.float32)
        nodes[:n] = node_feats[s["node_ids"]]
        node_mask = np.zeros(max_nodes, np.float32)
        node_mask[:n] = 1.0
        edges = np.zeros((max_edges, 2), np.int32)
        edges[:e] = s["edges"]
        edge_mask = np.zeros(max_edges, np.float32)
        edge_mask[:e] = s["edge_mask"]
        lab = np.zeros(max_nodes, np.int32)
        lab[:n] = labels[s["node_ids"]]
        # loss only on the root nodes
        loss_mask = np.zeros(max_nodes, np.float32)
        loss_mask[s["root_local"]] = 1.0
        return {
            "nodes": nodes, "edges": edges, "edge_attr": None,
            "node_mask": node_mask, "edge_mask": edge_mask,
            "graph_ids": np.zeros(max_nodes, np.int32),
            "labels": lab, "loss_mask": loss_mask,
        }
