"""Per-partition adjacency.  So far only ``build_adjacency``, a copy of the
reference's numpy builder (``repro/sample/local_graph.py``); the local
graphs that need the partition artifact come with it.
"""
from __future__ import annotations

import numpy as np


def build_adjacency(edges, num_nodes: int, *, by: str = "src"):
    """Group an (E, 2) edge array by one endpoint column.

    Returns ``(indptr, order)``: ``indptr`` is the (num_nodes + 1,) int64
    group-offset array and ``order`` the (E,) int64 permutation such that
    ``edges[order]`` is grouped by the chosen endpoint, original edge
    order preserved within a group (stable sort — so adjacency lists keep
    stream order, which downstream bit-parity checks rely on).

    Empty edge arrays of any dtype and graphs whose trailing vertices are
    isolated (max id < num_nodes - 1) both work.
    """
    edges = np.asarray(edges)
    if edges.size == 0:
        return (np.zeros(num_nodes + 1, np.int64),
                np.empty(0, np.int64))
    if edges.ndim != 2 or edges.shape[1] < 2:
        raise ValueError(f"edges must be (E, 2), got {edges.shape}")
    col = edges[:, 0 if by == "src" else 1].astype(np.int64)
    if len(col) and (col.min() < 0 or col.max() >= num_nodes):
        raise ValueError(
            f"edge endpoint out of range [0, {num_nodes}): "
            f"[{col.min()}, {col.max()}]")
    order = np.argsort(col, kind="stable")
    counts = np.bincount(col, minlength=num_nodes)
    indptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, order
