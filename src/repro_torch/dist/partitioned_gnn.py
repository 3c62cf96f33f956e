"""Halo-exchange planning for partition-aware GNN execution: 2PS-L edge
assignment -> a static, padded exchange plan (``HaloPlan``).

The port's copy of the planner half of the reference package's
``dist/partitioned_gnn.py`` (numpy only).  An edge partitioner emits
``assignment: (E,) int`` edge->partition ids; the planner turns that into
per-pair boundary tables that carry exactly the replicated vertices, so
the per-layer synchronization volume of the distributed GNN is
proportional to the replication factor the partitioner optimized.

Plan layout (all arrays padded/fixed-shape):

- ``edges[p]``:       partition-local edge list in local vertex ids,
  ``edge_mask`` marking the valid prefix-count rows (stream order kept).
- ``vmap_global[p]``: sorted local->global vertex map (-1 padding); the
  inverse of DGL's per-partition node map.
- ``send_idx[p, q]`` / ``recv_idx[q, p]``: symmetric pair tables — local
  ids (on p resp. q) of the vertices replicated on both, in ascending
  global order, so a tiled all-to-all aligns partial aggregates without
  any index traffic.
- ``ov_idx``: the all-reduce overflow lane.  Boundary sizes are skewed;
  capping the pair tables at a quantile (``pair_cap_quantile < 1``) moves
  every vertex of every over-cap pair out of the pairwise tables into one
  dense (o_cap, d) buffer that is all-reduced instead.

The execution half (the partitioned GNN train steps, whose exchange
becomes ``torch.distributed``'s all-to-all and all-reduce) comes with the
GNN training slice.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import obs


# ---------------------------------------------------------------------------
# planning core (pure numpy, vectorized, chunk-at-a-time)
#
# Every pass over the graph is expressed against an (edges, assignment)
# chunk iterator, so the same core serves both the in-memory path (one big
# chunk) and the out-of-core path (``plan_halo_exchange_stream``: the edge
# stream re-iterated chunk by chunk against the assignment memmap — peak
# memory is O(chunk + plan), never O(|E|)).
# ---------------------------------------------------------------------------

def _inmemory_chunks(edges: np.ndarray, assignment: np.ndarray):
    """Chunk factory for already-resident arrays: one chunk."""
    edges = np.ascontiguousarray(edges)[:, :2].astype(np.int64)
    assignment = np.asarray(assignment).astype(np.int64)
    if len(edges) != len(assignment):
        raise ValueError("edges / assignment length mismatch")

    def chunks():
        yield edges, assignment
    return chunks


def _stream_chunks(stream, assignment: np.ndarray, chunk_size: int):
    """Chunk factory over an ``EdgeStream`` + assignment array/memmap,
    aligned by stream offset.  Re-iterable (planning needs two sweeps)."""
    if stream.num_edges != len(assignment):
        raise ValueError("stream / assignment length mismatch")

    def chunks():
        lo = 0
        for chunk in stream.iter_chunks(chunk_size):
            n = chunk.shape[0]
            yield (np.ascontiguousarray(chunk)[:, :2].astype(np.int64),
                   np.asarray(assignment[lo:lo + n]).astype(np.int64))
            lo += n
    return chunks


def _replica_events(verts: np.ndarray, parts: np.ndarray, k: int, V: int):
    """All ordered replica pairs (v, p, q), p != q, as a sorted flat key
    ``(p*k + q)*V + v`` — one event per direction per shared vertex."""
    order = np.argsort(verts, kind="stable")
    gv, gp = verts[order], parts[order]
    uverts, vcounts = np.unique(gv, return_counts=True)
    vstarts = np.concatenate([[0], np.cumsum(vcounts)[:-1]])
    keys = []
    for r in np.unique(vcounts):
        if r < 2:
            continue
        sel = np.nonzero(vcounts == r)[0]
        idx = vstarts[sel][:, None] + np.arange(r)[None, :]
        pg = gp[idx]                                   # (groups, r)
        ii, jj = np.nonzero(~np.eye(int(r), dtype=bool))
        pq = pg[:, ii] * k + pg[:, jj]                 # (groups, r*(r-1))
        keys.append((pq * V + uverts[sel][:, None]).ravel())
    if not keys:
        return np.empty(0, np.int64)
    return np.sort(np.concatenate(keys))


def _lane_ranks(ev_pq: np.ndarray) -> np.ndarray:
    """Rank of each event inside its (p, q) lane (events must be sorted by
    lane key, and are v-sorted within a lane)."""
    idx = np.arange(len(ev_pq))
    if not len(ev_pq):
        return idx
    is_start = np.concatenate([[True], ev_pq[1:] != ev_pq[:-1]])
    return idx - np.maximum.accumulate(np.where(is_start, idx, 0))


def _plan_core(chunks, V, k, pair_cap_quantile):
    """First sweep: replica incidence + per-partition edge counts, folded
    chunk by chunk (``chunks`` is a chunk factory, see above).

    Per-chunk unique keys are buffered and merged geometrically (only when
    the buffer outgrows the merged set) instead of union1d per chunk —
    re-sorting the full incidence for every chunk would make the sweep
    O(chunks * |incidence|); this keeps it O(|incidence| log chunks) with
    peak memory a small multiple of the incidence size."""
    merged = np.empty(0, np.int64)
    pending, pending_n = [], 0
    edge_counts = np.zeros(k, np.int64)
    for e, a in chunks():
        ck = np.unique(np.concatenate([a * V + e[:, 0], a * V + e[:, 1]]))
        pending.append(ck)
        pending_n += len(ck)
        if pending_n >= max(len(merged), 1 << 22):
            merged = np.unique(np.concatenate([merged, *pending]))
            pending, pending_n = [], 0
        edge_counts += np.bincount(a, minlength=k)
    if pending:
        merged = np.unique(np.concatenate([merged, *pending]))
    key = merged
    parts, verts = key // V, key % V    # sorted by (partition, vertex)
    part_counts = np.bincount(parts, minlength=k)       # |V(p_i)|
    covered = len(np.unique(verts))
    rf = float(len(verts)) / max(covered, 1)

    ekey = _replica_events(verts, parts, k, V)
    ev_pq, ev_v = ekey // V, ekey % V
    pair_sizes = np.bincount(ev_pq, minlength=k * k).reshape(k, k)
    nz = pair_sizes[pair_sizes > 0]

    if len(nz) == 0:
        b_cap = 0
    elif pair_cap_quantile >= 1.0:
        b_cap = int(nz.max())
    else:
        b_cap = int(np.ceil(np.quantile(nz, pair_cap_quantile)))

    overflow_verts = np.unique(ev_v[_lane_ranks(ev_pq) >= b_cap])
    # an overflowed vertex leaves EVERY pairwise lane (handled via psum)
    keep = ~np.isin(ev_v, overflow_verts)

    return {
        "parts": parts, "verts": verts,
        "part_counts": part_counts, "edge_counts": edge_counts,
        "covered": covered, "replication_factor": rf,
        "pair_sizes": pair_sizes, "nonzero_pair_sizes": nz,
        "b_cap": b_cap, "overflow_verts": overflow_verts,
        "ev_pq": ev_pq[keep], "ev_v": ev_v[keep],
    }


def plan_capacities(edges, assignment, V, k, pair_cap_quantile=1.0) -> dict:
    """Capacities of the halo plan WITHOUT materializing the padded arrays
    — cheap enough to run at manifest-writing time on huge graphs."""
    with obs.get_tracer().span("halo_capacities", cat="halo", k=k):
        return _capacities(
            _plan_core(_inmemory_chunks(edges, assignment), V, k,
                       pair_cap_quantile), k)


def plan_capacities_stream(stream, assignment, V, k, pair_cap_quantile=1.0,
                           chunk_size: int = 1 << 20) -> dict:
    """``plan_capacities`` over an ``EdgeStream`` + assignment memmap —
    one chunked sweep, O(chunk + plan) peak memory."""
    with obs.get_tracer().span("halo_capacities", cat="halo", k=k,
                               streamed=True):
        return _capacities(
            _plan_core(_stream_chunks(stream, assignment, chunk_size), V, k,
                       pair_cap_quantile), k)


def _capacities(c: dict, k: int) -> dict:
    nz = c["nonzero_pair_sizes"]
    return {
        "k": int(k),
        "v_cap": int(max(c["part_counts"].max(), 1)),
        "e_cap": int(max(c["edge_counts"].max(), 1)),
        "b_cap": int(c["b_cap"]),
        "o_cap": int(len(c["overflow_verts"])),
        "replication_factor": c["replication_factor"],
        "covered_vertices": int(c["covered"]),
        "pair_mean": float(nz.mean()) if len(nz) else 0.0,
        "edge_counts": [int(n) for n in c["edge_counts"]],
    }


@dataclass
class HaloPlan:
    """Static halo-exchange plan for one (graph, assignment, k)."""
    k: int
    v_cap: int
    e_cap: int
    b_cap: int
    o_cap: int
    edges: np.ndarray         # (k, e_cap, 2) int32, local vertex ids
    edge_mask: np.ndarray     # (k, e_cap) float32
    vmap_global: np.ndarray   # (k, v_cap) int64, -1 padded, sorted ascending
    node_mask: np.ndarray     # (k, v_cap) float32
    send_idx: np.ndarray      # (k, k, b_cap) int32, -1 padded
    recv_idx: np.ndarray      # (k, k, b_cap) int32, -1 padded
    ov_idx: np.ndarray        # (k, o_cap) int32, -1 padded
    replication_factor: float
    pair_sizes: np.ndarray    # (k, k) int64 pre-cap boundary sizes
    edge_counts: np.ndarray   # (k,) int64

    def device_arrays(self) -> dict:
        """The arrays the SPMD step consumes (device_put targets)."""
        return {"edges": self.edges, "edge_mask": self.edge_mask,
                "send_idx": self.send_idx, "recv_idx": self.recv_idx,
                "ov_idx": self.ov_idx, "node_mask": self.node_mask}


def plan_halo_exchange(edges, assignment, V, k,
                       pair_cap_quantile=1.0, *, host_groups=None):
    """Build the full padded ``HaloPlan`` from an edge->partition
    assignment (see module docstring for the layout).

    ``host_groups`` (a host count or explicit contiguous groups, see
    ``dist.multihost``) switches to the host-grouped DCN-aware layout and
    returns a ``HostHaloPlan`` wrapping the identical base plan."""
    with obs.get_tracer().span("halo_plan", cat="halo", k=k):
        chunks = _inmemory_chunks(edges, assignment)
        plan = _build_plan(_plan_core(chunks, V, k, pair_cap_quantile),
                           chunks, V, k)
        return _maybe_host_plan(plan, host_groups)


def plan_halo_exchange_stream(stream, assignment, V, k, *,
                              pair_cap_quantile=1.0,
                              chunk_size: int = 1 << 20,
                              host_groups=None):
    """Out-of-core ``plan_halo_exchange``: chunk the planning sweeps over
    an ``EdgeStream`` + the engine's assignment memmap, so paper-scale
    graphs can be planned without the incidence list's edges ever being
    resident (the ROADMAP "out-of-core planning" follow-up).  Bit-identical
    to the in-memory planner — stream order is preserved chunk by chunk.
    ``host_groups`` behaves exactly as in ``plan_halo_exchange`` (the host
    re-slicing is a pure table transform of the finished base plan, so the
    streamed host plan is bit-identical to the in-memory one too)."""
    with obs.get_tracer().span("halo_plan", cat="halo", k=k,
                               streamed=True):
        chunks = _stream_chunks(stream, assignment, chunk_size)
        plan = _build_plan(_plan_core(chunks, V, k, pair_cap_quantile),
                           chunks, V, k)
        return _maybe_host_plan(plan, host_groups)


def _maybe_host_plan(plan, host_groups):
    if host_groups is None:
        return plan
    from .multihost import host_plan_from_halo
    return host_plan_from_halo(plan, host_groups)


def _build_plan(c: dict, chunks, V, k) -> HaloPlan:
    """Second sweep: assemble the padded plan arrays from the planning core
    dict + another pass over the (edges, assignment) chunks."""
    parts, verts = c["parts"], c["verts"]
    part_counts, edge_counts = c["part_counts"], c["edge_counts"]
    v_cap = int(max(part_counts.max(), 1))
    e_cap = int(max(edge_counts.max(), 1))
    b_cap = int(c["b_cap"])
    offsets = np.zeros(k + 1, np.int64)
    np.cumsum(part_counts, out=offsets[1:])

    # local->global vertex maps (each partition block is already sorted)
    vmap_global = np.full((k, v_cap), -1, np.int64)
    local_of = np.arange(len(verts)) - offsets[parts]   # local id per replica
    vmap_global[parts, local_of] = verts
    node_mask = (vmap_global >= 0).astype(np.float32)

    # per-partition local edge arrays (stream order preserved: chunks come
    # in stream order, the in-chunk sort is stable, and each partition's
    # rows are appended at its fill cursor)
    loc_edges = np.zeros((k, e_cap, 2), np.int32)
    edge_mask = np.zeros((k, e_cap), np.float32)
    fill = np.zeros(k, np.int64)
    for e, a in chunks():
        order = np.argsort(a, kind="stable")
        es, a_s = e[order], a[order]
        bounds = np.searchsorted(a_s, np.arange(k + 1))
        for p in range(k):
            s, t = int(bounds[p]), int(bounds[p + 1])
            if s == t:
                continue
            block = es[s:t]
            vp = vmap_global[p, :part_counts[p]]
            n0, n1 = int(fill[p]), int(fill[p]) + (t - s)
            loc_edges[p, n0:n1, 0] = np.searchsorted(vp, block[:, 0])
            loc_edges[p, n0:n1, 1] = np.searchsorted(vp, block[:, 1])
            edge_mask[p, n0:n1] = 1.0
            fill[p] = n1

    # symmetric pair tables: events already sorted by (p, q, v)
    send_idx = np.full((k, k, b_cap), -1, np.int32)
    ev_pq, ev_v = c["ev_pq"], c["ev_v"]
    if len(ev_pq):
        ev_p = ev_pq // k
        loc = _local_ids(vmap_global, part_counts, ev_p, ev_v)
        send_idx[ev_p, ev_pq % k, _lane_ranks(ev_pq)] = loc
    recv_idx = send_idx.copy()    # exchange is symmetric & order-aligned

    # psum overflow lane: slot j <-> global overflow vertex ov[j]
    ov = c["overflow_verts"]
    o_cap = len(ov)
    ov_idx = np.full((k, o_cap), -1, np.int32)
    if o_cap:
        m = np.isin(verts, ov)
        ov_idx[parts[m], np.searchsorted(ov, verts[m])] = \
            local_of[m].astype(np.int32)

    # pairwise exchange volume (rows shipped per layer before any host
    # aggregation) — the ICI-side twin of HostHaloPlan.dcn_summary
    obs.get_registry().gauge("halo.boundary_rows").set(
        int((send_idx >= 0).sum()))
    return HaloPlan(
        k=int(k), v_cap=v_cap, e_cap=e_cap, b_cap=b_cap, o_cap=int(o_cap),
        edges=loc_edges, edge_mask=edge_mask, vmap_global=vmap_global,
        node_mask=node_mask, send_idx=send_idx, recv_idx=recv_idx,
        ov_idx=ov_idx, replication_factor=c["replication_factor"],
        pair_sizes=c["pair_sizes"], edge_counts=edge_counts)


def _local_ids(vmap_global, part_counts, ps, vs):
    """Local id of global vertex vs[i] on partition ps[i] (must exist)."""
    out = np.empty(len(ps), np.int32)
    for p in np.unique(ps):
        m = ps == p
        out[m] = np.searchsorted(vmap_global[p, :part_counts[p]], vs[m])
    return out


def capacities_from_plan(plan: HaloPlan) -> dict:
    """The ``plan_capacities`` dict derived from an already-built plan —
    manifests written next to a persisted plan need no second pass over
    the planning core."""
    nz = plan.pair_sizes[plan.pair_sizes > 0]
    vm = plan.vmap_global
    return {
        "k": plan.k, "v_cap": plan.v_cap, "e_cap": plan.e_cap,
        "b_cap": plan.b_cap, "o_cap": plan.o_cap,
        "replication_factor": plan.replication_factor,
        "covered_vertices": int(len(np.unique(vm[vm >= 0]))),
        "pair_mean": float(nz.mean()) if len(nz) else 0.0,
        "edge_counts": [int(n) for n in plan.edge_counts],
    }


def load_halo_plan(artifact) -> HaloPlan:
    """HaloPlan from a ``PartitionArtifact`` (or its directory path) —
    the cached-plan path: no edge stream is read."""
    if isinstance(artifact, (str, bytes, os.PathLike)):
        from ..core.artifact import PartitionArtifact
        artifact = PartitionArtifact.load(os.fspath(artifact))
    return artifact.halo_plan()
