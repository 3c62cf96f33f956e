"""2PS-L Phase 1 — streaming clustering (paper Algorithm 1).

Extension of Hollocou et al.'s one-pass clustering with the paper's two
novelties: (1) true upfront degrees + an explicit cluster *volume cap*, and
(2) optional re-streaming passes.

* ``cluster_sequential``  — the literal edge-at-a-time loop (numpy), a copy
  of the reference's oracle, kept as a test aid.
* ``_cluster_chunk_step`` — the bulk-synchronous per-chunk update: every
  edge of a ``sub``-edge micro-batch reads the batch-entry state, migration
  conflicts are resolved last-writer-wins (matching sequential order), and
  volumes are repaired with scatter-adds.  The reference runs the
  micro-batches as a ``lax.scan``; here they are a Python loop of eager
  torch ops that update ``v2c``/``vol`` in place.  ``sub`` stays 128: the
  micro-batch width changes the result.
* ``cluster_in_memory_scan`` — the same update over an in-memory edge
  tensor, a loop over its chunk views.

Cluster ids are initialized to vertex ids (identity singletons with volume
``d[v]``), which is the paper's lazy ``next_id`` creation up to relabeling.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .stream import EdgeStream, compute_degrees


@dataclass
class ClusteringResult:
    v2c: np.ndarray        # (V,) vertex -> cluster id
    vol: np.ndarray        # (V,) cluster volumes (indexed by cluster id)
    degrees: np.ndarray    # (V,) true vertex degrees
    max_vol: int

    @property
    def num_clusters(self) -> int:
        return int((np.bincount(self.v2c, minlength=len(self.v2c)) > 0).sum())


def default_max_vol(num_edges: int, k: int, factor: float = 1.0) -> int:
    """Volume cap: ``factor * 2|E|/k``.  Total volume is 2|E|; capping single
    clusters at roughly one partition's volume share keeps Phase 2 from having
    to cut clusters to meet the balance constraint (paper §III-A.2)."""
    return max(int(factor * 2.0 * num_edges / k), 1)


# ---------------------------------------------------------------------------
# Sequential oracle (Algorithm 1, verbatim)
# ---------------------------------------------------------------------------

def cluster_sequential(edges: np.ndarray, degrees: np.ndarray,
                       max_vol: int, passes: int = 1) -> ClusteringResult:
    V = len(degrees)
    d = degrees.astype(np.int64)
    v2c = np.arange(V, dtype=np.int64)
    vol = d.copy()
    for _ in range(passes):
        for u, v in edges:
            cu, cv = v2c[u], v2c[v]
            if vol[cu] <= max_vol and vol[cv] <= max_vol:      # line 16
                # line 17: v_s has the smaller residual volume
                if vol[cu] - d[u] <= vol[cv] - d[v]:
                    vs, vl = u, v
                else:
                    vs, vl = v, u
                cs, cl = v2c[vs], v2c[vl]
                if cs != cl and vol[cl] + d[vs] <= max_vol:    # line 19
                    vol[cl] += d[vs]
                    vol[cs] -= d[vs]
                    v2c[vs] = cl
    return ClusteringResult(v2c=v2c.astype(np.int32), vol=vol.astype(np.int64),
                            degrees=degrees.astype(np.int32), max_vol=max_vol)


# ---------------------------------------------------------------------------
# Bulk-synchronous chunked version (eager per-chunk update, in place)
# ---------------------------------------------------------------------------

def _cluster_update(v2c: torch.Tensor, vol: torch.Tensor, d: torch.Tensor,
                    u: torch.Tensor, v: torch.Tensor, uv: torch.Tensor,
                    valid: torch.Tensor, max_vol: int, winner: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """One bulk-synchronous micro-batch of Algorithm 1, updating ``v2c`` and
    ``vol`` in place; returns the number of migrations (a 0-d tensor).

    ``u``/``v`` are the batch's endpoints (int64), ``uv`` the two
    concatenated (one gather per table serves both endpoints), ``idx`` is
    ``arange(sub)``.  All edges observe the batch-entry state; per-vertex
    migration conflicts are resolved in favor of the latest edge in stream
    order.  ``winner`` is a ``V+1`` int64 scratch of -1s (the last slot
    absorbs non-moving edges): ``scatter_reduce("amax")`` of the edge index
    per migrating vertex replaces the reference's
    ``.at[].max(mode="drop")``, and the touched slots are reset to -1
    before returning.  The state updates are adds of 0 for edges that do
    not migrate, so no update needs dropping.
    """
    c = v2c.index_select(0, uv)
    dd = d.index_select(0, uv)
    vc = vol.index_select(0, c)
    cu, cv = c.view(2, -1).unbind()
    du, dv = dd.view(2, -1).unbind()
    vol_cu, vol_cv = vc.view(2, -1).unbind()
    eligible = (torch.maximum(vol_cu, vol_cv) <= max_vol) & valid

    u_small = (vol_cu - du) <= (vol_cv - dv)
    vs = torch.where(u_small, u, v)
    ds = torch.where(u_small, du, dv)
    cs = torch.where(u_small, cu, cv)
    cl = torch.where(u_small, cv, cu)
    vol_cl = torch.where(u_small, vol_cv, vol_cu)

    move = eligible & (cs != cl) & (vol_cl + ds <= max_vol)

    # Last-writer-wins per migrating vertex (stream order within the batch).
    key = torch.where(move, vs, winner.shape[0] - 1)
    winner.scatter_reduce_(0, key, torch.where(move, idx, -1), reduce="amax")
    win = move & (winner.index_select(0, vs) == idx)
    winner.index_fill_(0, key, -1)

    v2c.index_add_(0, vs, torch.where(win, cl - cs, 0))
    dlt = torch.where(win, ds, 0)
    vol.index_add_(0, cl, dlt)
    vol.index_add_(0, cs, dlt, alpha=-1)
    return win.sum()


def _cluster_chunk_step(v2c: torch.Tensor, vol: torch.Tensor,
                        d: torch.Tensor, edges: torch.Tensor,
                        valid: torch.Tensor, *, max_vol: int,
                        sub: int = 128):
    """One chunk = a loop over ``sub``-edge micro-batches, in place on
    ``v2c`` and ``vol`` (the reference donates them).  Returns
    ``(v2c, vol, moved)``.  Each micro-batch is some thirty small eager
    ops, so on the card this loop is bound by the host's launch rate."""
    C = edges.shape[0]
    if C % sub:
        raise ValueError(f"chunk of {C} edges is not a multiple of "
                         f"sub={sub}")
    dev = vol.device
    # per-batch views made once per chunk: (C//sub, sub) endpoints and the
    # (C//sub, 2*sub) [u | v] rows the gathers read
    e = edges.to(torch.int64).view(C // sub, sub, 2)
    uv = e.transpose(1, 2).reshape(C // sub, 2 * sub)
    u_rows, v_rows = uv[:, :sub].unbind(), uv[:, sub:].unbind()
    valid_rows = valid.view(C // sub, sub).unbind()
    winner = torch.full((vol.shape[0] + 1,), -1, dtype=torch.int64,
                        device=dev)
    idx = torch.arange(sub, device=dev)
    moved = torch.zeros((), dtype=torch.int64, device=dev)
    for b, row in enumerate(uv.unbind()):
        moved += _cluster_update(v2c, vol, d, u_rows[b], v_rows[b], row,
                                 valid_rows[b], max_vol, winner, idx)
    return v2c, vol, moved


def streaming_clustering(stream: EdgeStream, degrees: np.ndarray | None = None,
                         *, k: int, device, max_vol: int | None = None,
                         max_vol_factor: float = 1.0, passes: int = 1,
                         chunk_size: int = 1 << 16,
                         sub: int = 128, readahead: int = 0) -> ClusteringResult:
    """Out-of-core Phase 1: the host streams chunks, ``device`` holds the
    O(|V|) state.  ``readahead > 0`` reads chunks ahead on a background
    thread (nothing below synchronizes per chunk)."""
    from .partitioning import pad_chunk
    if degrees is None:
        degrees = compute_degrees(stream, chunk_size)
    if max_vol is None:
        max_vol = default_max_vol(stream.num_edges, k, max_vol_factor)
    sub = min(sub, chunk_size)
    chunk_size = (chunk_size // sub) * sub
    V = stream.num_vertices
    d = torch.as_tensor(np.asarray(degrees, np.int32), device=device)
    v2c = torch.arange(V, dtype=torch.int32, device=device)
    # 2|E| < 2^31 for all supported stream sizes
    vol = d.clone()

    for _ in range(passes):
        it = stream.iter_chunks_prefetch(chunk_size, readahead)
        try:
            for chunk in it:
                pc = pad_chunk(chunk, chunk_size, device)
                _cluster_chunk_step(v2c, vol, d, pc.edges, pc.valid,
                                    max_vol=int(max_vol), sub=sub)
        finally:
            if hasattr(it, "close"):
                it.close()          # joins the prefetch thread on error

    return ClusteringResult(v2c=v2c.cpu().numpy(), vol=vol.cpu().numpy(),
                            degrees=np.asarray(degrees, np.int32),
                            max_vol=int(max_vol))


def cluster_in_memory_scan(edges: torch.Tensor, degrees: torch.Tensor,
                           max_vol: int, passes: int = 1,
                           chunk_size: int = 4096):
    """Fully in-memory variant on the tensors' device: a loop over
    ``chunk_size`` views of the (E, 2) ``edges`` through
    ``_cluster_chunk_step`` (the reference runs a ``lax.scan`` over them).
    Semantics identical to ``streaming_clustering``.  Returns ``(v2c,
    vol)`` as int32 tensors."""
    dev = edges.device
    E = edges.shape[0]
    nchunks = -(-E // chunk_size)
    padded = nchunks * chunk_size
    edges_p = torch.zeros((padded, 2), dtype=torch.int64, device=dev)
    edges_p[:E] = edges
    valid = (torch.arange(padded, device=dev) < E).view(nchunks, chunk_size)
    edges_c = edges_p.view(nchunks, chunk_size, 2)
    d = degrees.to(torch.int32)
    v2c = torch.arange(degrees.shape[0], dtype=torch.int32, device=dev)
    vol = d.clone()
    for _ in range(passes):
        for i in range(nchunks):
            _cluster_chunk_step(v2c, vol, d, edges_c[i], valid[i],
                                max_vol=max_vol)
    return v2c, vol
