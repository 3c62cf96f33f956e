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

Execution (``make_partitioned_gin_step`` and its GatedGCN and EGNN
siblings): each partition computes local partial aggregates, replicas are
reconciled through the plan (``_halo_combine``), and the masters-only
masked loss matches the dense single-process reference.  Two routes run
the same losses:

- **one process, all k partitions on one device** (a
  ``launch.mesh.HostMesh``; the card's route): the partitions are
  flattened to (k * v_cap, d) rows, so the plan's lanes compose to one
  static linear map, each row the sum of its vertex's replica rows.  It
  is built once per plan from the lane tables (the replica slots) and
  runs as two ``spmm`` launches whatever the plan's layout: every row
  summed into its slot, then each slot spread back to its rows.  The
  neighbour sum is one ``spmm`` a layer over all k partitions' edges.
  Every backward is ``spmm`` over the reversed map: each row has one
  owner summing in a fixed order, so a step is bit-repeatable on the
  card.  There is no ``index_add_`` on this route.
- **one partition a ``torch.distributed`` rank** (a ``DeviceMesh``): the
  pairwise and host lanes are ``all_to_all_single`` over the pair and host
  groups, the overflow lane and the host replication ``all_reduce``, all
  differentiable (``torch.distributed.nn.functional``), and the received
  rows are scattered by ``spmm``.  Each rank differentiates its own share
  of the loss (an all-reduced loss would come back scaled by the world
  size); the step then sums the parameter gradients over the ranks, so
  every rank takes the same AdamW step.
"""
from __future__ import annotations

import functools
import os
import types
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import obs
from ..kernels.spmm import TilePrep, prepare_tiles, spmm
from ..models import gnn as G
from ..models import layers as L
from ..optim.adamw import tree_leaves
from ..optim.schedules import linear_warmup_cosine
from ..training import make_train_step
from .multihost import HostHaloPlan, split_mesh_axes


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


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

class _AxisLayout(NamedTuple):
    """Mesh-axis split the combinator runs over.  ``pair``: the pairwise
    all-to-all axes (all mesh axes single-host; the trailing intra-host
    device axes when host-grouped).  ``host``: the leading DCN axes of the
    host-grouped layout (empty otherwise).  ``all``: every mesh axis —
    overflow all-reduce and loss reductions.  ``groups``: the process
    groups of the ranks route (None on the one-process route)."""
    pair: tuple
    host: tuple
    all: tuple
    groups: "_RankGroups | None" = None


def _as_layout(axes) -> _AxisLayout:
    """Accept either an _AxisLayout or the legacy plain axis tuple."""
    if isinstance(axes, _AxisLayout):
        return axes
    axes = tuple(axes) if not isinstance(axes, str) else (axes,)
    return _AxisLayout(pair=axes, host=(), all=axes)


@dataclass(frozen=True, eq=False)
class _RankGroups:
    """This rank's partition and process groups (``DeviceMesh`` route):
    ``all`` spans the mesh, ``pair`` the ranks of this rank's host group
    (the mesh when single-level), ``host`` the ranks at this rank's
    position in every host group (None when single-level)."""
    index: int
    device: torch.device
    all: object
    pair: object
    host: object


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass(frozen=True, eq=False)
class _Lane:
    """One static index map: ``out[dst[e]] += x[src[e]]`` for the edges
    e of the map, as one ``spmm`` on edges bound once (forward and
    reverse)."""
    src: torch.Tensor
    prep: TilePrep

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        # float32 sums whatever x's dtype, as ``models.gnn.segment_sum``
        y = spmm(x.float().contiguous(), self.src, None, self.prep)
        return y.to(x.dtype)


def _lane(src: np.ndarray, dst: np.ndarray, in_rows: int, out_rows: int,
          device, *, keep_empty: bool = False) -> _Lane | None:
    """The ``_Lane`` of the edges ``src -> dst`` from ``in_rows`` rows of
    x into ``out_rows`` rows; None when there are none (the lane launches
    nothing) unless ``keep_empty``."""
    if not len(src) and not keep_empty:
        return None
    s = torch.from_numpy(np.ascontiguousarray(src, np.int64)).to(device)
    prep = prepare_tiles(np.asarray(dst, np.int64), out_rows).to(device)
    prep = prep.with_edges(s, None, num_rows=in_rows).with_reverse(s)
    return _Lane(src=s, prep=prep)


@dataclass(frozen=True, eq=False)
class _LocalExchange:
    """The one-process route's exchange over the k partitions' flattened
    (k * v_cap, d) rows.  On one device the plan's lanes compose to one
    linear map, each row the sum of its vertex's replica rows, so it runs
    as that map in two ``spmm`` launches whatever the plan: ``total``
    sums every replica group into its slot (partition order), ``spread``
    sets each slot into its rows (one edge a row).  Each backward is the
    other's shape, so both directions sum in a fixed order."""
    total: _Lane
    spread: _Lane

    #: ``spmm`` launches of one combine (as many again in its backward)
    launches = 2

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.spread(self.total(x.contiguous()))


def _replica_slots(plan, v_cap: int) -> np.ndarray:
    """The slot of every flattened row (``p * v_cap + i``): the rows that
    the plan's lanes join share one (the pair tables join
    ``send_idx[p, q, j]`` on p with ``recv_idx[q, p, j]`` on q, a host
    lane its senders with its receiver, the overflow lane the rows of
    slot j), and every other row, padding too, has its own.  Slots are
    numbered in the order of their first rows; an entry that is negative
    or not below ``v_cap`` joins nothing."""
    send, recv = _numpy(plan["send_idx"]), _numpy(plan["recv_idx"])
    ov = _numpy(plan["ov_idx"])
    k, n, _ = send.shape
    joined = []                               # (rows, rows) joined pairs

    def row(part, idx):            # flattened row, -1 where idx is none
        ok = (idx >= 0) & (idx < v_cap)
        return np.where(ok, part * v_cap + idx.astype(np.int64), -1)

    def join(a, b):
        a, b = np.broadcast_arrays(a, b)
        ok = (a >= 0) & (b >= 0)
        joined.append((a[ok], b[ok]))

    # partition p's i-th pair slot is its group's i-th member q
    p = np.repeat(np.arange(k), n).reshape(k, n)
    q = (p // n) * n + np.arange(n)[None, :]
    join(row(p[..., None], send), row(q[..., None], recv[q, p % n]))
    H = plan["hsend_idx"].shape[1] if "hsend_idx" in plan else 1
    if H > 1:
        # receiver q's host-a slot j: the rows hsend[., B(q), j] of a's
        # partitions
        hsend, hrecv = _numpy(plan["hsend_idx"]), _numpy(plan["hrecv_idx"])
        D = k // H
        q = np.broadcast_to(np.arange(k)[:, None], (k, H))
        for dd in range(D):
            p = np.arange(H)[None, :] * D + dd
            join(row(p[..., None], hsend[p, q // D]),
                 row(q[..., None], hrecv))
    # the overflow lane's slot j: its rows on every partition
    ov_rows = row(np.arange(k)[:, None], ov)
    join(ov_rows, ov_rows.max(axis=0, initial=-1)[None, :])
    a = np.concatenate([x for x, _ in joined])
    b = np.concatenate([y for _, y in joined])
    label = np.arange(k * v_cap, dtype=np.int64)
    while True:           # the least row of each joined set, by relaxation
        m = np.minimum(label[a], label[b])
        new = label.copy()
        np.minimum.at(new, a, m)
        np.minimum.at(new, b, m)
        new = new[new]
        if np.array_equal(new, label):
            break
        label = new
    _, slot = np.unique(label, return_inverse=True)
    return slot.reshape(-1)


def _local_exchange(plan, v_cap: int, device) -> _LocalExchange:
    """Build the one-process exchange of ``plan`` (``device_arrays()``)
    once: the replica slots of its rows, summed then spread."""
    slot = _replica_slots(plan, v_cap)
    rows = np.arange(len(slot), dtype=np.int64)
    n_slots = int(slot.max()) + 1
    return _LocalExchange(
        total=_lane(rows, slot, len(slot), n_slots, device),
        spread=_lane(slot, rows, n_slots, len(slot), device))


def step_spmm_launches(model: str, n_layers: int) -> tuple:
    """One partitioned train step's ``spmm`` launches on the one-process
    route, ``c`` those of one combine: (all, backward, on the bound
    route).  GIN: a neighbour sum and a combine a layer, each forward and
    backward, all bound; GatedGCN: two segment sums (their backward a
    gather) and two combines a layer, the combines backward; EGNN: the
    degree (a segment sum and a combine, forward only), then two segment
    sums and two combines a layer, the last layer's coordinate combine
    not differentiated."""
    L, c = n_layers, _LocalExchange.launches
    if model == "gin":
        return 2 * L * (1 + c), L * (1 + c), 2 * L * (1 + c)
    if model == "gatedgcn":
        return 2 * L + 4 * L * c, 2 * L * c, 4 * L * c
    bwd = (2 * L - 1) * c
    fwd = 1 + c + L * (2 + 2 * c)
    return fwd + bwd, bwd, c + 2 * L * c + bwd


@dataclass(frozen=True, eq=False)
class _RankExchange:
    """The ranks route's exchange over this rank's (v_cap, d) rows: the
    reference's collectives through ``torch.distributed.nn.functional``
    (differentiable), the received rows scattered by ``spmm``."""
    groups: _RankGroups
    send: torch.Tensor | None           # (n, b_cap) clamped row ids
    send_ok: torch.Tensor | None        # (n, b_cap, 1)
    recv: _Lane | None                  # received (n * b_cap) -> rows
    hsend: torch.Tensor | None          # (H, hb_cap)
    hsend_ok: torch.Tensor | None
    hrecv: _Lane | None
    ov: torch.Tensor | None             # (o_cap,)
    ov_ok: torch.Tensor | None
    ov_set: _Lane | None                # totals (o_cap) -> their rows
    is_overflow: torch.Tensor | None    # (v_cap, 1) bool

    # Every rank runs every collective of the plan and keeps its output
    # in the graph (a lane with no rows on this rank is an empty ``spmm``):
    # a rank that skipped one would leave the others waiting in the
    # backward.

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed.nn import functional as dnn
        g, d = self.groups, x.shape[-1]
        if self.ov is not None:      # gather overflow partials BEFORE any add
            buf = torch.where(self.ov_ok, x[self.ov], 0.0)
            ov_tot = dnn.all_reduce(buf, group=g.all)
        if self.send is not None:
            buf = torch.where(self.send_ok, x[self.send], 0.0).reshape(-1, d)
            buf = dnn.all_to_all_single(torch.empty_like(buf), buf,
                                        group=g.pair)
            x = x + self.recv(buf)
        if self.hsend is not None:   # x holds host partials: leaders send
            hbuf = torch.where(self.hsend_ok, x[self.hsend], 0.0)
            # host-replicate the aggregated lane
            hbuf = dnn.all_reduce(hbuf, group=g.pair).reshape(-1, d)
            hbuf = dnn.all_to_all_single(torch.empty_like(hbuf), hbuf,
                                         group=g.host)
            x = x + self.hrecv(hbuf)
        if self.ov is not None:
            x = torch.where(self.is_overflow, self.ov_set(ov_tot), x)
        return x


def _scatter_lane(idx: np.ndarray, v_cap: int, device) -> _Lane:
    """The ``_Lane`` adding received slot s at row ``idx.flat[s]`` (slots
    with a negative or out-of-range row dropped)."""
    flat = idx.reshape(-1)
    ok = (flat >= 0) & (flat < v_cap)
    return _lane(np.nonzero(ok)[0], flat[ok], len(flat), v_cap, device,
                 keep_empty=True)


def _rank_exchange(plan, v_cap: int, groups: _RankGroups) -> _RankExchange:
    """Build this rank's exchange of ``plan`` once (its row of every
    table)."""
    p, dev = groups.index, groups.device

    def rows(t):
        return torch.from_numpy(np.minimum(np.maximum(t, 0), v_cap - 1)
                                .astype(np.int64)).to(dev)

    def ok(t):
        return torch.from_numpy(t >= 0)[..., None].to(dev)

    send, recv = _numpy(plan["send_idx"])[p], _numpy(plan["recv_idx"])[p]
    ov = _numpy(plan["ov_idx"])[p]
    kw = dict.fromkeys(("send", "send_ok", "recv", "hsend", "hsend_ok",
                        "hrecv", "ov", "ov_ok", "ov_set", "is_overflow"))
    if send.shape[0] > 1 and send.shape[1] > 0:
        kw.update(send=rows(send), send_ok=ok(send),
                  recv=_scatter_lane(recv, v_cap, dev))
    if "hsend_idx" in plan:
        hsend, hrecv = (_numpy(plan["hsend_idx"])[p],
                        _numpy(plan["hrecv_idx"])[p])
        if hsend.shape[0] > 1 and hsend.shape[1] > 0:
            kw.update(hsend=rows(hsend), hsend_ok=ok(hsend),
                      hrecv=_scatter_lane(hrecv, v_cap, dev))
    if len(ov):
        dst_ok = (ov >= 0) & (ov < v_cap)
        mask = np.zeros(v_cap, bool)
        mask[ov[dst_ok]] = True
        kw.update(ov=rows(ov), ov_ok=ok(ov),
                  ov_set=_scatter_lane(ov, v_cap, dev),
                  is_overflow=torch.from_numpy(mask[:, None]).to(dev))
    return _RankExchange(groups=groups, **kw)


def _halo_combine(x, lanes):
    """Reconcile per-replica partial aggregates: after this, every replica
    of a vertex holds the full (global) aggregate.

    ``lanes`` is the plan's exchange on one of the two routes: a
    ``_LocalExchange`` over the k partitions' flattened (k * v_cap, d)
    rows (the lanes' composed map, two ``spmm``s), or a ``_RankExchange``
    over this rank's (v_cap, d) rows (the collectives).  On the ranks
    route, host-grouped plans first leave
    every replica with its host partial, then add every other host's
    through the aggregated lanes (``dist.multihost``); the overflow lane's
    rows take the sum over all replicas."""
    with obs.get_tracer().span("halo_combine", cat="halo"):
        return lanes(x)


def _combiner(plan, axes: _AxisLayout, v_cap, *, device=None):
    """The ``_halo_combine`` closure for a plan's arrays — routes onto the
    two-level path when the plan carries host lanes, and onto the ranks
    route when ``axes`` carries process groups (else the one-process
    route, on ``device``).

    The batch's plan arrays and the step's axis layout MUST come from the
    same plan: a host-grouped layout over flat (k, k, b_cap) tables is
    shape-compatible with the intra-host all_to_all (k divides by the
    device-axis size), so a mismatch would silently exchange wrong lanes
    — fail loudly instead.  (A 1-host HostHaloPlan carries the key with
    H == 1 and an empty layout — both levels inactive, consistent.)"""
    axes = _as_layout(axes)
    lanes_active = "hsend_idx" in plan and plan["hsend_idx"].shape[1] > 1
    if lanes_active != bool(axes.host):
        raise ValueError(
            "plan arrays / mesh layout mismatch: batch['plan'] "
            + ("carries host lanes but the step was built from a "
               "single-level plan" if lanes_active else
               "has no host lanes but the step was built from a "
               "host-grouped plan")
            + "; pass the same plan's device_arrays() to the batch as "
              "the step factory's dims")
    if axes.groups is not None:
        lanes = _rank_exchange(plan, v_cap, axes.groups)
    else:
        lanes = _local_exchange(plan, v_cap, torch.device(device or "cpu"))
    return functools.partial(_halo_combine, lanes=lanes)


@dataclass(frozen=True, eq=False)
class _Partitions:
    """The partitions one process runs, prepared once per plan on its
    device: all k flattened on the one-process route, its own on a rank.
    ``graph`` binds their edges (local ids offset by ``p * v_cap``) for
    ``neighbour_sum`` and ``segment_sum`` (forward and reverse)."""
    index: int | None        # this rank's partition (None: all k)
    device: torch.device
    graph: G.GraphPrep
    node_mask: torch.Tensor  # (rows, 1)
    combine: object

    @property
    def rows(self) -> int:
        return self.graph.num_nodes

    @property
    def lanes(self):
        return self.combine.keywords["lanes"]

    def take(self, t) -> torch.Tensor:
        """A batch entry of leading shape (k, v_cap) (or, on a rank, (1,
        v_cap): its own partition) as this process's (rows, ...) rows."""
        t = torch.as_tensor(t, device=self.device)
        if self.index is not None and t.shape[0] != 1:
            t = t[self.index:self.index + 1]
        return t.reshape((self.rows,) + tuple(t.shape[2:]))


def _prepare(plan, axes, v_cap: int, device=None) -> _Partitions:
    """``_Partitions`` of a plan's arrays (``device_arrays()``, numpy or
    tensors) for ``axes``' route."""
    axes = _as_layout(axes)
    combine = _combiner(plan, axes, v_cap, device=device)
    groups = axes.groups
    device = torch.device(device or "cpu") if groups is None else \
        groups.device
    edges = _numpy(plan["edges"])
    emask = _numpy(plan["edge_mask"])
    nmask = _numpy(plan["node_mask"])
    if groups is not None:
        edges, emask, nmask = (a[groups.index:groups.index + 1]
                               for a in (edges, emask, nmask))
    off = (np.arange(edges.shape[0], dtype=np.int64) * v_cap)[:, None, None]
    flat = (edges.astype(np.int64) + off).reshape(-1, 2)
    graph = G.edge_prep(torch.from_numpy(flat).to(device),
                        torch.from_numpy(emask.reshape(-1)
                                         .astype(np.float32)).to(device),
                        nmask.size, reverse=True)
    return _Partitions(
        index=None if groups is None else groups.index, device=device,
        graph=graph,
        node_mask=torch.from_numpy(nmask.reshape(-1, 1)
                                   .astype(np.float32)).to(device),
        combine=combine)


def _partitions(batch, axes, v_cap: int) -> _Partitions:
    """The batch's prepared plan (a step hands it prepared; a direct call
    prepares it now, on the device of ``batch['nodes']``)."""
    plan = batch["plan"]
    if isinstance(plan, _Partitions):
        return plan
    nodes = batch["nodes"]
    device = nodes.device if isinstance(nodes, torch.Tensor) else None
    return _prepare(plan, axes, v_cap, device)


class _Reported(torch.autograd.Function):
    """The value ``total`` with the gradient of ``local``: a rank reports
    the all-reduced loss and differentiates its own share."""

    @staticmethod
    def forward(ctx, local, total):
        return total.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _masked_xent(logits, labels, lmask, axes: _AxisLayout):
    """Masters-only cross-entropy over the whole mesh: the sum over this
    process's rows of ``ll * mask`` over the global mask count.  On a rank
    the count is all-reduced without a gradient, and the reported value
    is the all-reduced loss (``_Reported``)."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = G.label_log_prob(logp, labels)
    num = torch.sum(ll * lmask)
    den = torch.sum(lmask)
    groups = _as_layout(axes).groups
    if groups is None:
        return -num / torch.clamp_min(den, 1.0)
    import torch.distributed as dist
    den = den.detach().clone()
    dist.all_reduce(den, group=groups.all)
    loss = -num / torch.clamp_min(den, 1.0)
    total = loss.detach().clone()
    dist.all_reduce(total, group=groups.all)
    return _Reported.apply(loss, total)


def partitioned_gin_loss(cfg, params, batch, *, axes, v_cap):
    """GIN loss over the partitions this process runs.

    Same math as the dense reference (GIN message passing, no batchnorm —
    global batch statistics would break partition locality); the loss is
    averaged over MASTER vertices only (``batch['loss_mask']``), so every
    covered vertex is counted exactly once across the mesh.  The neighbour
    sum is one ``spmm`` a layer over all of them."""
    axes = _as_layout(axes)
    part = _partitions(batch, axes, v_cap)
    nmask = part.node_mask
    h = L.dense(params["encoder"], part.take(batch["nodes"])) * nmask
    for lp in params["layers"]:
        agg = part.combine(G.neighbour_sum(h, part.graph))
        pre = (1.0 + lp["eps"]) * h + agg
        h = L.dense(lp["mlp"]["l2"], F.relu(L.dense(lp["mlp"]["l1"], pre)))
        h = F.relu(h) * nmask
    logits = L.dense(params["head"], h).float()
    return _masked_xent(logits, part.take(batch["labels"]),
                        part.take(batch["loss_mask"]), axes)


def partitioned_gatedgcn_loss(cfg, params, batch, *, axes, v_cap):
    """GatedGCN loss over the partitions this process runs.

    Same gated aggregation as the dense reference minus batchnorm (global
    batch statistics break partition locality, as for GIN).  Edge features
    are partition-local — every edge lives on exactly one partition — so
    only the two per-destination partial sums of the gated mean (numerator
    and gate normalizer) go through ``_halo_combine``; the division
    happens after both are globally reconciled."""
    axes = _as_layout(axes)
    part = _partitions(batch, axes, v_cap)
    gp, nmask, R = part.graph, part.node_mask, part.rows
    src, dst = gp.src_rows, gp.dst_rows
    em = gp.edge_mask[:, None]
    h = L.dense(params["encoder"], part.take(batch["nodes"])) * nmask
    ef = L.dense(params["edge_encoder"],
                 torch.ones((em.shape[0], 1), dtype=h.dtype,
                            device=h.device))
    for lp in params["layers"]:
        e_new = (L.dense(lp["A"], h)[src] + L.dense(lp["B"], h)[dst]
                 + L.dense(lp["C"], ef))
        eta = torch.sigmoid(e_new) * em
        num = part.combine(G.segment_sum(eta * L.dense(lp["V"], h)[src],
                                         gp.edges, R))
        den = part.combine(G.segment_sum(eta, gp.edges, R))
        h_new = L.dense(lp["U"], h) + num / (den + 1e-6)
        h = (h + F.relu(h_new)) * nmask
        ef = ef + F.relu(e_new)
    logits = L.dense(params["head"], h).float()
    return _masked_xent(logits, part.take(batch["labels"]),
                        part.take(batch["loss_mask"]), axes)


def partitioned_egnn_forward(cfg, params, batch, *, axes, v_cap):
    """EGNN forward over the partitions this process runs, returning the
    final ``(h, x)`` node features AND coordinates, (parts, v_cap, d) and
    (parts, v_cap, 3) with parts k on the one-process route and 1 on a
    rank.

    Both per-destination partial sums — the feature aggregate and the
    (v_cap, 3) coordinate numerator — reconcile through the same
    ``_halo_combine``, and the degree normalizer is combined once up
    front; since every replica starts from identical coords and applies
    identical reconciled updates, positions stay consistent across the
    mesh without a separate position broadcast."""
    axes = _as_layout(axes)
    part = _partitions(batch, axes, v_cap)
    gp, nmask, R = part.graph, part.node_mask, part.rows
    em = gp.edge_mask[:, None]
    h = L.dense(params["encoder"], part.take(batch["nodes"])) * nmask
    x = part.take(batch["coords"]).to(h.dtype)
    deg = part.combine(G.segment_sum(em, gp.edges, R)) + 1.0
    for lp in params["layers"]:
        m, xmsg = G.egnn_layer_terms(lp, h, x, gp.src_rows, gp.dst_rows, em)
        x = x + part.combine(G.segment_sum(xmsg, gp.edges, R)) / deg
        agg = part.combine(G.segment_sum(m, gp.edges, R))
        h = (h + G._mlp2(lp["phi_h"], torch.cat([h, agg], dim=-1))) * nmask
    parts = R // v_cap
    return (h.reshape(parts, v_cap, -1), x.reshape(parts, v_cap, -1))


def partitioned_egnn_loss(cfg, params, batch, *, axes, v_cap):
    """Masters-only masked node loss over ``partitioned_egnn_forward``."""
    axes = _as_layout(axes)
    part = _partitions(batch, axes, v_cap)
    h, _ = partitioned_egnn_forward(cfg, params, {**batch, "plan": part},
                                    axes=axes, v_cap=v_cap)
    logits = L.dense(params["head"], h.reshape(part.rows, -1)).float()
    return _masked_xent(logits, part.take(batch["labels"]),
                        part.take(batch["loss_mask"]), axes)


PARTITIONED_LOSSES = {"gin": partitioned_gin_loss,
                      "gatedgcn": partitioned_gatedgcn_loss,
                      "egnn": partitioned_egnn_loss}


def _plan_dims(dims) -> tuple[int, int, int | None]:
    """(k, v_cap, num_hosts|None) from a capacities dict, a HaloPlan, a
    HostHaloPlan, or a PartitionArtifact (which loads its cached plan —
    the host-grouped one when the artifact persisted it)."""
    if hasattr(dims, "halo_plan"):              # PartitionArtifact
        if getattr(dims, "has_host_plan", lambda: False)():
            dims = dims.host_halo_plan()
        else:
            dims = dims.halo_plan()
    if isinstance(dims, HostHaloPlan):
        return dims.k, dims.v_cap, dims.num_hosts
    if isinstance(dims, HaloPlan):
        return dims.k, dims.v_cap, None
    return (int(dims["k"]), int(dims["v_cap"]),
            int(dims["num_hosts"]) if "num_hosts" in dims else None)


def _is_device_mesh(mesh) -> bool:
    return not hasattr(mesh, "axis_names") and hasattr(mesh, "mesh")


def _mesh_view(mesh):
    """(axis names, a ``devices`` array of the mesh's shape) of a
    ``HostMesh`` or a ``DeviceMesh``, as ``split_mesh_axes`` reads them."""
    if not _is_device_mesh(mesh):
        return mesh
    shape = tuple(mesh.mesh.shape)
    names = tuple(mesh.mesh_dim_names
                  or (f"dim{i}" for i in range(len(shape))))
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _rank_groups(mesh, axes: _AxisLayout) -> _RankGroups:
    """This rank's ``_RankGroups`` on a ``DeviceMesh`` whose ranks are in
    partition order (flat position p holds partition p).  Every rank of
    the world calls this, in the same order (group creation is
    collective)."""
    import torch.distributed as dist
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    if ranks != sorted(ranks):
        raise ValueError(f"mesh ranks {ranks} are not in ascending order: "
                         "partition p runs on the rank at flat position p")
    world = dist.get_world_size()
    all_group = None if ranks == list(range(world)) else \
        dist.new_group(ranks)
    view = _mesh_view(mesh)
    sizes = dict(zip(view.axis_names, view.devices.shape))
    n_host = int(np.prod([sizes[a] for a in axes.host], dtype=np.int64))
    grid = np.asarray(ranks).reshape(n_host, -1)
    if axes.host:
        pair, _ = dist.new_subgroups_by_enumeration(
            [row.tolist() for row in grid])
        host, _ = dist.new_subgroups_by_enumeration(
            [col.tolist() for col in grid.T])
    else:
        pair, host = all_group, None
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    return _RankGroups(index=ranks.index(dist.get_rank()), device=device,
                       all=all_group, pair=pair, host=host)


def _sum_over_ranks(grads, *, group):
    """Every rank's gradients summed (one all-reduce of the flattened
    leaves), written back into ``grads``."""
    import torch.distributed as dist
    leaves = tree_leaves(grads)
    flat = torch.cat([g.reshape(-1) for g in leaves])
    dist.all_reduce(flat, group=group)
    at = 0
    for g in leaves:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return grads


def make_partitioned_gnn_step(model, cfg, mesh, dims, *, lr=1e-3):
    """Partitioned GNN train step: one partition per mesh position.

    ``model`` is a ``PARTITIONED_LOSSES`` key ('gin', 'gatedgcn', 'egnn').
    ``dims`` may be a ``HaloPlan``, a ``HostHaloPlan``, a
    ``plan_capacities`` dict, or a ``PartitionArtifact`` (whose persisted
    plan supplies the capacities).  Batch layout: ``nodes (k, v_cap, d)``,
    ``labels``/``loss_mask (k, v_cap)`` (plus ``coords (k, v_cap, 3)`` for
    'egnn'), ``plan`` = the plan's ``device_arrays()``; a rank may pass its
    own partition's rows alone (leading axis 1).

    ``mesh`` is a ``launch.mesh.HostMesh`` (one process: every partition
    on its ``device``) or a ``torch.distributed`` ``DeviceMesh`` (one
    partition a rank).  The step prepares the plan on the device once and
    keeps it while the batch carries the same arrays.  With a host-grouped
    plan the leading mesh axes whose sizes multiply to ``num_hosts``
    become the DCN group and the trailing axes the intra-host device group
    (``dist.multihost.split_mesh_axes``); a single-level plan keeps one
    flat exchange over every axis."""
    loss_body = PARTITIONED_LOSSES[model]
    k, v_cap, num_hosts = _plan_dims(dims)
    view = _mesh_view(mesh)
    all_axes = tuple(view.axis_names)
    n_dev = int(np.prod(np.shape(view.devices)))
    if k != n_dev:
        raise ValueError(f"plan has k={k} partitions but mesh has "
                         f"{n_dev} devices")
    if num_hosts is None:
        axes = _AxisLayout(pair=all_axes, host=(), all=all_axes)
    else:
        host_axes, dev_axes = split_mesh_axes(view, num_hosts)
        axes = _AxisLayout(pair=dev_axes, host=host_axes, all=all_axes)
    reduce_grads, device = None, getattr(mesh, "device", None)
    if _is_device_mesh(mesh):
        axes = axes._replace(groups=_rank_groups(mesh, axes))
        reduce_grads = functools.partial(_sum_over_ranks,
                                         group=axes.groups.all)
    cache = {}

    def prepared(plan) -> _Partitions:
        key = tuple((name, id(a)) for name, a in sorted(plan.items()))
        if cache.get("key") != key:
            cache.clear()
            cache.update(key=key, arrays=tuple(plan.values()),
                         part=_prepare(plan, axes, v_cap, device))
        return cache["part"]

    def loss_fn(params, batch):
        batch = {**batch, "plan": prepared(batch["plan"])}
        return loss_body(cfg, params, batch, axes=axes, v_cap=v_cap)

    step = make_train_step(loss_fn, linear_warmup_cosine(lr, 20, 2_000),
                           weight_decay=0.0, reduce_grads=reduce_grads)
    step.prepare = prepared
    return step


def make_partitioned_gin_step(cfg, mesh, dims, *, lr=1e-3):
    return make_partitioned_gnn_step("gin", cfg, mesh, dims, lr=lr)


def make_partitioned_gatedgcn_step(cfg, mesh, dims, *, lr=1e-3):
    return make_partitioned_gnn_step("gatedgcn", cfg, mesh, dims, lr=lr)


def make_partitioned_egnn_step(cfg, mesh, dims, *, lr=1e-3):
    return make_partitioned_gnn_step("egnn", cfg, mesh, dims, lr=lr)
