"""Incremental 2PS-L: absorb edge insertions into an existing partition.

The paper (§VI, citing Fan et al.) notes 2PS-L "could be transformed into an
incremental algorithm to efficiently handle dynamic graphs".  This module
does that on top of the chunked phase-2 functions, on the run's device:

* the state that matters at assignment time — degrees, cluster volumes,
  v2c, c2p, the packed replication bits and partition sizes — is kept in a
  ``PartitionerState`` of tensors;
* new edges stream through the same two steps as the batch algorithm:
  pre-partition if the endpoints' clusters agree, else 2-candidate scoring
  (on the card one ``edge_score_choose_bits`` launch per chunk);
* unseen vertices join the cluster of their first neighbour (the streaming
  clustering's migration rule applied once);
* a drift monitor reports when enough volume has moved that a re-clustering
  pass is worth scheduling.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import bitops, partitioning as P
from .convert import words_to_numpy, words_to_torch
from .engine import PartitionRunResult, resolve_device, run_spec
from .metrics import capacity, quality_from_bitmatrix
from .specs import TwoPSLSpec
from .stream import EdgeStream


@dataclass
class PartitionerState:
    """Everything needed to keep assigning edges after the initial run."""
    k: int
    alpha: float
    num_edges: int                       # edges assigned so far
    initial_edges: int                   # capacity derives from this + growth
    d: torch.Tensor                      # (V,) degrees
    vol: torch.Tensor                    # (V,) cluster volumes
    v2c: torch.Tensor                    # (V,)
    c2p: torch.Tensor                    # (V,)
    bits: torch.Tensor                   # (V, W) int32 replication words
    sizes: torch.Tensor                  # (k,)
    headroom: float = 1.5                # capacity growth factor for inserts
    inserted: int = 0
    moved_volume: int = 0                # drift accumulator

    @property
    def cap(self) -> int:
        return capacity(int(self.initial_edges * self.headroom
                            + self.inserted), self.k, self.alpha)

    def drift(self) -> float:
        """Fraction of total volume contributed by post-initial inserts —
        when this is large, clustering no longer reflects the graph and a
        re-partition should be scheduled."""
        total = float(self.vol.sum())
        return self.moved_volume / max(total, 1.0)

    def quality(self):
        return quality_from_bitmatrix(words_to_numpy(self.bits),
                                      self.sizes.cpu().numpy(),
                                      self.num_edges)


def bootstrap(stream: EdgeStream, k: int, *, alpha: float = 1.05,
              chunk_size: int = 1 << 16, headroom: float = 1.5,
              spec: TwoPSLSpec | None = None, device="cuda",
              **kw) -> tuple[PartitionRunResult, PartitionerState]:
    """Initial batch 2PS-L run on ``device`` (the card by default; ``cpu``
    on request) + retained incremental state.

    Configure via a ``TwoPSLSpec`` or the alpha/chunk_size kwargs (ignored
    when ``spec`` is given)."""
    device = resolve_device(device)
    if spec is None:
        spec = TwoPSLSpec(alpha=alpha, chunk_size=chunk_size, **kw)
    alpha, chunk_size = spec.alpha, spec.chunk_size
    res = run_spec(spec, stream, k, device=device)
    from .clustering import streaming_clustering
    from .mapping import map_clusters_lpt
    from .stream import compute_degrees
    degrees = compute_degrees(stream, chunk_size)
    clus = streaming_clustering(stream, degrees, k=k, device=device,
                                chunk_size=chunk_size)
    c2p, _ = map_clusters_lpt(clus.vol, k)

    # rebuild bits/sizes from the assignment (cheap, exact)
    V = stream.num_vertices
    bits = bitops.alloc_np(V, k)
    edges = np.concatenate(list(stream.iter_chunks(chunk_size)))
    bitops.set_np(bits, edges[:, 0].astype(np.int64), res.assignment)
    bitops.set_np(bits, edges[:, 1].astype(np.int64), res.assignment)
    sizes = np.bincount(res.assignment, minlength=k).astype(np.int32)

    def put(arr):
        return torch.from_numpy(np.asarray(arr, np.int32)).to(device)
    state = PartitionerState(
        k=k, alpha=alpha, num_edges=stream.num_edges,
        initial_edges=stream.num_edges,
        d=put(degrees), vol=put(clus.vol), v2c=put(clus.v2c), c2p=put(c2p),
        bits=words_to_torch(bits, device), sizes=put(sizes),
        headroom=headroom)
    return res, state


def insert_edges(state: PartitionerState, new_edges: np.ndarray,
                 chunk_size: int = 1 << 14) -> np.ndarray:
    """Assign a batch of inserted edges; returns their partition ids.

    Runs the same phase-2 chunk functions as the batch algorithm, on the
    state's device, so the per-edge cost is the paper's O(1) scoring."""
    dev = state.bits.device
    new_edges = np.ascontiguousarray(new_edges, np.int32)
    assignment = np.full(len(new_edges), -1, np.int32)

    # 1) update degrees / adopt clusters for unseen vertices (first-neighbour
    # adoption = one application of the clustering migration rule)
    verts = new_edges.reshape(-1)
    state.d.index_add_(0, torch.from_numpy(verts.astype(np.int64)).to(dev),
                       torch.ones(len(verts), dtype=torch.int32, device=dev))
    v2c_np = state.v2c.cpu().numpy().copy()
    u, v = new_edges[:, 0], new_edges[:, 1]
    # vertices whose cluster is still their identity singleton with zero
    # volume adopt the neighbour's cluster
    vol_np = state.vol.cpu().numpy()
    for a, b in ((u, v), (v, u)):
        fresh = vol_np[v2c_np[a]] == 0
        v2c_np[a[fresh]] = v2c_np[b[fresh]]
    state.v2c = torch.from_numpy(v2c_np).to(dev)
    add_vol = np.bincount(v2c_np[verts], minlength=len(vol_np))
    state.vol = state.vol + torch.from_numpy(add_vol.astype(np.int32)).to(dev)
    state.moved_volume += int(len(verts))

    # 2) stream the new edges through prepartition + scoring
    cap = state.cap
    lo = 0
    for start in range(0, len(new_edges), chunk_size):
        chunk = new_edges[start:start + chunk_size]
        pc = P.pad_chunk(chunk, chunk_size, dev)
        _, _, asg, _ = P._prepartition_chunk(
            state.bits, state.sizes, state.d, state.v2c, state.c2p,
            pc.edges, pc.valid, k=state.k, cap=cap)
        asg_np = asg[:pc.n].cpu().numpy()
        _, _, asg2 = P._score_chunk(
            state.bits, state.sizes, state.d, state.vol, state.v2c,
            state.c2p, pc.edges, pc.valid, k=state.k, cap=cap)
        asg2_np = asg2[:pc.n].cpu().numpy()
        merged = np.where(asg_np >= 0, asg_np, asg2_np)
        assignment[lo:lo + pc.n] = merged
        lo += pc.n

    state.inserted += len(new_edges)
    state.num_edges += len(new_edges)
    return assignment
