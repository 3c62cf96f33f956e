"""Literal edge-at-a-time numpy implementation of 2PS-L Phase 2 (Algorithm
2): the faithfulness oracle, a copy of the reference's.

Tests compare the bulk-synchronous chunked partitioner against this loop on
small graphs, and the paper's invariants (hard balance cap, every edge
assigned exactly once) are asserted on both.
"""
from __future__ import annotations

import numpy as np

from . import bitops
from .clustering import ClusteringResult
from .hashing import hash_mod_np
from .metrics import capacity


def _score(u, v, p, d, vol, v2c, c2p, bm):
    du, dv = int(d[u]), int(d[v])
    cu, cv = int(v2c[u]), int(v2c[v])
    dsum = max(du + dv, 1)
    g_u = (1.0 + (1.0 - du / dsum)) if bitops.get_np(
        bm, np.array([u]), np.array([p]))[0] else 0.0
    g_v = (1.0 + (1.0 - dv / dsum)) if bitops.get_np(
        bm, np.array([v]), np.array([p]))[0] else 0.0
    vsum = max(int(vol[cu]) + int(vol[cv]), 1)
    sc_u = vol[cu] / vsum if c2p[cu] == p else 0.0
    sc_v = vol[cv] / vsum if c2p[cv] == p else 0.0
    return g_u + g_v + sc_u + sc_v


def partition_sequential(edges: np.ndarray, clus: ClusteringResult,
                         c2p: np.ndarray, k: int, alpha: float = 1.05):
    E = len(edges)
    cap = capacity(E, k, alpha)
    d, vol, v2c = clus.degrees, clus.vol, clus.v2c
    bm = bitops.alloc_np(len(d), k)
    sizes = np.zeros(k, np.int64)
    assignment = np.full(E, -1, np.int32)

    def fallback(u, v, p):
        if sizes[p] < cap:
            return p
        hi = u if d[u] >= d[v] else v
        p = int(hash_mod_np(np.array([hi], np.uint32), k)[0])
        if sizes[p] < cap:
            return p
        return int(np.argmin(sizes))

    def assign(i, u, v, p):
        assignment[i] = p
        sizes[p] += 1
        bitops.set_np(bm, np.array([u, v]), np.array([p, p]))

    # ---- Step 2: pre-partitioning ------------------------------------
    for i, (u, v) in enumerate(edges):
        cu, cv = v2c[u], v2c[v]
        if cu == cv or c2p[cu] == c2p[cv]:
            assign(i, u, v, fallback(u, v, int(c2p[cu])))

    # ---- Step 3: 2-candidate scoring ---------------------------------
    for i, (u, v) in enumerate(edges):
        if assignment[i] >= 0:
            continue
        p1 = int(c2p[v2c[u]])
        p2 = int(c2p[v2c[v]])
        s1 = _score(u, v, p1, d, vol, v2c, c2p, bm)
        s2 = _score(u, v, p2, d, vol, v2c, c2p, bm)
        p = p2 if s2 > s1 else p1
        assign(i, u, v, fallback(u, v, p))

    return assignment, bm, sizes
