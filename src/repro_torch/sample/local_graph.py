"""Per-partition CSC/CSR local graph structure, derived out-of-core: a
copy of the reference package's ``sample/local_graph.py`` (numpy only).

A ``PartitionArtifact`` holds the edge -> partition assignment; minibatch
serving needs the *adjacency* of each partition's edge set in local ids.
``build_local_graphs`` derives it with ONE chunked sweep over the edge
stream against the assignment memmap (peak memory O(partition edges +
chunk), never a second full-graph pass) and persists one
``local_csc_p{i}.npz`` per partition next to the manifest — artifact
format v3; older artifacts load unchanged, they just have no local
structure until it is built.

Id-map contract: a partition's local vertex ids are positions in its
sorted-ascending global vertex set — exactly the valid prefix of the halo
plan's ``vmap_global[p]`` — so sampler output, halo-plan boundary tables
and per-device layouts all speak the same local ids
(``build_local_graphs`` asserts this against the persisted plan when one
exists).

``build_adjacency`` builds every CSR/CSC here; buffered re-streaming
also builds each window's mini-graph with it.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from .. import obs

LOCAL_GRAPH_FILE_FMT = "local_csc_p{i}.npz"
#: manifest block written by ``build_local_graphs`` (format v3)
LOCAL_GRAPH_MANIFEST_KEY = "local_graphs"


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


@dataclass
class LocalGraph:
    """One partition's edge set as CSC (in-edges by destination) + CSR
    (out-edges by source) over local vertex ids.

    ``vmap_global`` is the sorted local -> global id map (the halo plan's
    ``vmap_global[p]`` valid prefix).  Both adjacency index arrays carry
    the *global edge id* (position in the artifact's edge stream) per
    entry, so every sampled edge is traceable to the source graph — the
    property suites verify sampled edges against ``edges[eid]`` and
    ``assignment[eid]`` exactly.
    """

    part_id: int
    vmap_global: np.ndarray   # (n_local,) int64, sorted ascending
    csc_indptr: np.ndarray    # (n_local + 1,) int64 — in-edges by dst
    csc_src: np.ndarray       # (n_edges,) int32 local src ids
    csc_eid: np.ndarray       # (n_edges,) int64 global edge ids
    csr_indptr: np.ndarray    # (n_local + 1,) int64 — out-edges by src
    csr_dst: np.ndarray       # (n_edges,) int32 local dst ids
    csr_eid: np.ndarray       # (n_edges,) int64 global edge ids

    @property
    def num_local(self) -> int:
        return len(self.vmap_global)

    @property
    def num_edges(self) -> int:
        return len(self.csc_src)

    def local_of(self, global_ids: np.ndarray) -> np.ndarray:
        """Local ids of ``global_ids`` (must all be present; -1 where
        absent rather than a bogus neighbor's id)."""
        gids = np.asarray(global_ids, np.int64)
        if self.num_local == 0:
            return np.full(gids.shape, -1, np.int64)
        pos = np.searchsorted(self.vmap_global, gids)
        pos = np.minimum(pos, self.num_local - 1)
        return np.where(self.vmap_global[pos] == gids, pos, -1)

    def in_degree(self, local_ids: np.ndarray) -> np.ndarray:
        return self.csc_indptr[local_ids + 1] - self.csc_indptr[local_ids]

    @classmethod
    def from_edges(cls, part_id: int, edges_global: np.ndarray,
                   edge_ids: np.ndarray) -> "LocalGraph":
        """Build from this partition's (n, 2) global-id edge rows + their
        global edge ids (any order; CSC/CSR keep it stably)."""
        edges_global = np.asarray(edges_global, np.int64).reshape(-1, 2)
        edge_ids = np.asarray(edge_ids, np.int64)
        vmap = np.unique(edges_global) if len(edges_global) else \
            np.empty(0, np.int64)
        local = np.searchsorted(vmap, edges_global) if len(edges_global) \
            else np.empty((0, 2), np.int64)
        n = len(vmap)
        csc_indptr, csc_order = build_adjacency(local, n, by="dst")
        csr_indptr, csr_order = build_adjacency(local, n, by="src")
        return cls(
            part_id=int(part_id), vmap_global=vmap,
            csc_indptr=csc_indptr,
            csc_src=local[csc_order, 0].astype(np.int32),
            csc_eid=edge_ids[csc_order],
            csr_indptr=csr_indptr,
            csr_dst=local[csr_order, 1].astype(np.int32),
            csr_eid=edge_ids[csr_order])

    # -- persistence -----------------------------------------------------
    _ARRAYS = ("vmap_global", "csc_indptr", "csc_src", "csc_eid",
               "csr_indptr", "csr_dst", "csr_eid")

    def save(self, dirpath: str) -> str:
        from ..robust.integrity import savez_atomic
        path = os.path.join(dirpath,
                            LOCAL_GRAPH_FILE_FMT.format(i=self.part_id))
        savez_atomic(path, part_id=self.part_id,
                     **{a: getattr(self, a) for a in self._ARRAYS})
        return path

    @classmethod
    def load(cls, path: str) -> "LocalGraph":
        with np.load(path) as z:
            return cls(part_id=int(z["part_id"][()]),
                       **{a: z[a] for a in cls._ARRAYS})


def load_local_graph(artifact_path: str, part_id: int) -> LocalGraph:
    """Load one partition's persisted local structure by directory."""
    return LocalGraph.load(os.path.join(
        artifact_path, LOCAL_GRAPH_FILE_FMT.format(i=part_id)))


def build_local_graphs(artifact, stream=None, *, edges=None,
                       chunk_size: int = 1 << 20) -> list[LocalGraph]:
    """Derive + persist every partition's CSC/CSR from ``artifact`` and
    the edge stream in ONE chunked sweep, then stamp the manifest
    (format v3).  Pass the graph as ``stream`` (an ``EdgeStream``) or
    ``edges`` (in-memory (E, 2)); with neither, the manifest's
    ``graph_path`` is memmapped.

    The sweep scatters each chunk's rows into per-partition buffers at
    fill cursors (sized by one cheap bincount pass over the assignment
    memmap — no graph IO), so peak memory is O(|E| rows + chunk), the
    same envelope as halo-plan assembly.  When the artifact carries a
    halo plan, each partition's derived vertex set is asserted identical
    to the plan's ``vmap_global`` valid prefix — the id-map contract the
    sampler and SPMD steps share.
    """
    from ..core.artifact import PartitionArtifact
    if isinstance(artifact, (str, bytes, os.PathLike)):
        artifact = PartitionArtifact.load(os.fspath(artifact))
    if stream is None and edges is None:
        gp = artifact.manifest.get("graph_path")
        if not gp:
            raise ValueError(
                "no edge source: pass stream= or edges= (the manifest "
                "has no graph_path to reopen)")
        from ..core.stream import MemmapEdgeStream
        stream = MemmapEdgeStream(gp,
                                  num_vertices=artifact.num_vertices)
    if edges is not None:
        from ..core.stream import InMemoryEdgeStream
        stream = InMemoryEdgeStream(
            np.asarray(edges, np.int32),
            num_vertices=artifact.num_vertices)
    if stream.num_edges != artifact.num_edges:
        raise ValueError(f"stream has {stream.num_edges} edges but the "
                         f"artifact assignment covers "
                         f"{artifact.num_edges}")

    k = artifact.k
    asg = artifact.assignment
    tracer = obs.get_tracer()
    with tracer.span("local_graphs", cat="sample", k=k):
        # sizing pass: per-partition edge counts from the assignment
        # memmap alone (chunked bincount — no graph IO)
        counts = np.zeros(k, np.int64)
        for lo in range(0, artifact.num_edges, chunk_size):
            counts += np.bincount(np.asarray(asg[lo:lo + chunk_size]),
                                  minlength=k)

        bufs = [np.empty((int(n), 2), np.int64) for n in counts]
        eids = [np.empty(int(n), np.int64) for n in counts]
        fill = np.zeros(k, np.int64)
        lo = 0
        for chunk in stream.iter_chunks(chunk_size):
            e = np.ascontiguousarray(chunk)[:, :2].astype(np.int64)
            a = np.asarray(asg[lo:lo + len(e)])
            gid = np.arange(lo, lo + len(e), dtype=np.int64)
            order = np.argsort(a, kind="stable")
            bounds = np.searchsorted(a[order], np.arange(k + 1))
            for p in range(k):
                s, t = int(bounds[p]), int(bounds[p + 1])
                if s == t:
                    continue
                sel = order[s:t]
                n0, n1 = int(fill[p]), int(fill[p]) + (t - s)
                bufs[p][n0:n1] = e[sel]
                eids[p][n0:n1] = gid[sel]
                fill[p] = n1
            lo += len(e)

        plan = artifact.halo_plan() if artifact.has_halo_plan() else None
        graphs, files = [], []
        for p in range(k):
            g = LocalGraph.from_edges(p, bufs[p], eids[p])
            if plan is not None:
                pv = plan.vmap_global[p]
                np.testing.assert_array_equal(
                    g.vmap_global, pv[pv >= 0],
                    err_msg=f"partition {p}: local vertex set diverges "
                            f"from the halo plan's vmap_global")
            files.append(os.path.basename(g.save(artifact.path)))
            graphs.append(g)

    artifact.register_local_graphs({
        "files": files, "num_partitions": k,
        "edge_counts": [int(n) for n in counts],
    })
    obs.get_registry().gauge("sample.local_graphs_built").set(k)
    return graphs


class PartitionedGraph:
    """All k local graphs + the replica index the sampler crosses
    partitions with.

    The replica index is the flat (vertex-sorted) concatenation of every
    partition's ``vmap_global`` — for a global vertex it answers "which
    partitions hold a replica, under which local ids" in O(log V), which
    is exactly the halo plan's replica-set relation (same source arrays).
    ``home_of`` is the master convention the SPMD parity suites use: the
    lowest partition id holding a replica.
    """

    def __init__(self, graphs: list[LocalGraph], num_vertices: int):
        self.graphs = graphs
        self.k = len(graphs)
        self.num_vertices = int(num_vertices)
        parts = np.concatenate([
            np.full(g.num_local, g.part_id, np.int32) for g in graphs]) \
            if graphs else np.empty(0, np.int32)
        verts = np.concatenate([g.vmap_global for g in graphs]) \
            if graphs else np.empty(0, np.int64)
        locs = np.concatenate([
            np.arange(g.num_local, dtype=np.int64) for g in graphs]) \
            if graphs else np.empty(0, np.int64)
        # sort by (vertex, partition): replicas of a vertex are contiguous
        # and partition-ascending, so home_of is the run's first entry
        order = np.lexsort((parts, verts))
        self.rep_vertex = verts[order]
        self.rep_part = parts[order]
        self.rep_local = locs[order]

    @classmethod
    def load(cls, artifact) -> "PartitionedGraph":
        from ..core.artifact import PartitionArtifact
        if isinstance(artifact, (str, bytes, os.PathLike)):
            artifact = PartitionArtifact.load(os.fspath(artifact))
        if not artifact.has_local_graphs():
            raise FileNotFoundError(
                f"{artifact.path} has no local graphs; run "
                f"repro_torch.sample.build_local_graphs (or partition "
                f"with "
                f"--local-graphs) first")
        graphs = [artifact.local_graph(p) for p in range(artifact.k)]
        return cls(graphs, artifact.num_vertices)

    def replica_slices(self, gids: np.ndarray):
        """(starts, stops) into the replica index for each global id."""
        gids = np.asarray(gids, np.int64)
        return (np.searchsorted(self.rep_vertex, gids, side="left"),
                np.searchsorted(self.rep_vertex, gids, side="right"))

    def home_of(self, gids: np.ndarray) -> np.ndarray:
        """Master partition (lowest replica partition id; -1 for vertices
        no edge covers)."""
        gids = np.asarray(gids, np.int64)
        starts, stops = self.replica_slices(gids)
        found = starts < stops
        if not len(self.rep_part):
            return np.full(gids.shape, -1, np.int32)
        idx = np.minimum(starts, len(self.rep_part) - 1)
        return np.where(found, self.rep_part[idx], -1).astype(np.int32)

    def masters(self, part_id: int) -> np.ndarray:
        """Global ids mastered on ``part_id`` (feature-shard ownership)."""
        is_first = np.concatenate(
            [[True], self.rep_vertex[1:] != self.rep_vertex[:-1]])
        return self.rep_vertex[is_first & (self.rep_part == part_id)]

    def degrees(self) -> np.ndarray:
        """Global in-degree per vertex, folded across partitions — the
        hotness order the feature cache pins by."""
        deg = np.zeros(self.num_vertices, np.int64)
        for g in self.graphs:
            if g.num_local:
                deg[g.vmap_global] += np.diff(g.csc_indptr)
        return deg


def local_graphs_manifest_entry(path: str) -> dict | None:
    """The ``local_graphs`` manifest block of an artifact dir (None when
    the structure was never built)."""
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f).get(LOCAL_GRAPH_MANIFEST_KEY)
