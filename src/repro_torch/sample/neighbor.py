"""Partition-aware k-hop neighbor sampling over per-partition CSC: a copy
of the reference package's ``sample/neighbor.py`` (numpy only).

The sampler answers ego-network queries against a ``PartitionedGraph``:
per hop it expands the frontier through *incoming* edges (message
direction, exactly the dense models' ``src -> dst``), reading each
frontier vertex's in-edges from its **home partition first** and crossing
into other partitions only where the halo plan says a replica lives —
the per-minibatch cross-partition traffic is therefore bounded by the
replication factor the partitioner optimized, which is the paper's
quality metric showing up as serving fan-out.

Two regimes per hop:

* ``fanout >= 0`` — fixed-shape sampling with replacement (GraphSAGE
  style): every frontier vertex contributes exactly ``fanout`` slots,
  masked where its degree is zero.  Output shapes depend only on
  (len(roots), fanouts) (the reference's jitted forward compiles once).
* ``fanout == -1`` — full fan-out: every in-edge, each vertex expanded
  at most once, and the final edge list sorted by global edge id.  That
  ordering makes a full-fan-out sampled forward **bit-consistent** with
  the dense reference on the roots: per destination, the segment sum
  (``kernels/spmm``: one owner per row, edges in destination order)
  accumulates the identical terms in the identical order.

Minibatches come out in the shared GraphBatch dict format
(``padded_batch``), so dense reference models run unmodified;
``minibatch_halo_plan`` re-plans a sampled subgraph with
``dist.partitioned_gnn.plan_halo_exchange`` using each edge's recorded
source partition as its assignment.
"""
from __future__ import annotations

import numpy as np

from .. import obs

from .local_graph import PartitionedGraph


def _expand_ranges(starts: np.ndarray, stops: np.ndarray) -> np.ndarray:
    """Concatenate ``arange(starts[i], stops[i])`` without a Python loop."""
    counts = (stops - starts).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    offs = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=offs[1:])
    return (np.arange(total, dtype=np.int64)
            - np.repeat(offs, counts) + np.repeat(starts, counts))


class PartitionedNeighborSampler:
    """Fan-out sampler over a ``PartitionedGraph`` (see module doc)."""

    def __init__(self, pgraph: PartitionedGraph, fanouts, seed: int = 0):
        self.pg = pgraph
        self.fanouts = tuple(int(f) for f in fanouts)
        if any(f < -1 for f in self.fanouts):
            raise ValueError(f"fanouts must be >= 0 or -1 (full), got "
                             f"{self.fanouts}")
        self.rng = np.random.default_rng(seed)

    # -- candidate gathering --------------------------------------------
    def _gather_in_edges(self, verts: np.ndarray):
        """All in-edges of ``verts`` across every replica partition.

        Returns ``(seg_ptr, src_global, eid, part)``: rows grouped by
        vertex (``seg_ptr[i]:seg_ptr[i+1]`` is vertex i's in-edges), home
        partition's rows first then remaining replicas in ascending
        partition order, CSC (stream) order within a partition.
        """
        pg = self.pg
        starts, stops = pg.replica_slices(verts)
        flat = _expand_ranges(starts, stops)     # rows in the replica index
        owner = np.repeat(np.arange(len(verts)), (stops - starts))
        parts = pg.rep_part[flat] if len(flat) else np.empty(0, np.int32)
        locs = pg.rep_local[flat] if len(flat) else np.empty(0, np.int64)

        srcs, eids, tags, owners = [], [], [], []
        for p in np.unique(parts):
            g = pg.graphs[int(p)]
            m = parts == p
            lp = locs[m]
            rows = _expand_ranges(g.csc_indptr[lp], g.csc_indptr[lp + 1])
            n_each = (g.csc_indptr[lp + 1] - g.csc_indptr[lp])
            srcs.append(g.vmap_global[g.csc_src[rows]])
            eids.append(g.csc_eid[rows])
            tags.append(np.full(len(rows), p, np.int32))
            owners.append(np.repeat(owner[m], n_each))
        if not srcs:
            return (np.zeros(len(verts) + 1, np.int64),
                    np.empty(0, np.int64), np.empty(0, np.int64),
                    np.empty(0, np.int32))
        src = np.concatenate(srcs)
        eid = np.concatenate(eids)
        tag = np.concatenate(tags)
        own = np.concatenate(owners)
        # group per vertex; the per-partition append order (ascending p)
        # survives the stable sort, so each vertex's home rows lead
        order = np.argsort(own, kind="stable")
        seg = np.zeros(len(verts) + 1, np.int64)
        np.cumsum(np.bincount(own, minlength=len(verts)), out=seg[1:])
        return seg, src[order], eid[order], tag[order]

    # -- sampling --------------------------------------------------------
    def sample(self, roots: np.ndarray, *, home: int | None = None):
        """Draw one ego-network minibatch rooted at ``roots``.

        ``home`` is the serving partition the request was routed to
        (default: the majority home partition of the roots); edges read
        from any other partition count as halo crossings in the stats and
        the ``sample.edges_halo`` counter.
        """
        pg = self.pg
        roots = np.asarray(roots, np.int64).reshape(-1)
        if home is None:
            homes = pg.home_of(roots)
            homes = homes[homes >= 0]
            home = int(np.bincount(homes).argmax()) if len(homes) else 0
        tracer, registry = obs.get_tracer(), obs.get_registry()
        with tracer.span("sample.minibatch", cat="sample",
                         roots=len(roots), hops=len(self.fanouts),
                         home=home):
            out = self._sample_inner(roots, home)
        valid = out["edge_mask"] > 0
        halo = int((out["edge_part"][valid] != home).sum())
        local = int(valid.sum()) - halo
        registry.counter("sample.minibatches").inc()
        registry.counter("sample.edges_local").inc(local)
        registry.counter("sample.edges_halo").inc(halo)
        out["home"] = home
        out["stats"] = {"local_edges": local, "halo_edges": halo,
                        "nodes": len(out["node_ids"])}
        return out

    def _sample_inner(self, roots, home):
        frontier = np.unique(roots)
        expanded = np.empty(0, np.int64)         # full-fan-out dedupe set
        all_src, all_dst, all_eid, all_part, all_ok = [], [], [], [], []
        for f in self.fanouts:
            if f == -1:
                fresh = frontier[~np.isin(frontier, expanded)]
                expanded = np.union1d(expanded, fresh)
                seg, src, eid, tag = self._gather_in_edges(fresh)
                dst = np.repeat(fresh, np.diff(seg))
                ok = np.ones(len(src), bool)
            else:
                seg, src, eid, tag = self._gather_in_edges(frontier)
                deg = np.diff(seg)
                has = deg > 0
                u = self.rng.random((len(frontier), f))
                off = (u * np.maximum(deg, 1)[:, None]).astype(np.int64)
                rows = np.where(has[:, None], seg[:-1, None] + off, 0)
                if len(src) == 0:
                    rows = np.zeros_like(rows)
                    src = np.zeros(1, np.int64)
                    eid = np.full(1, -1, np.int64)
                    tag = np.full(1, -1, np.int32)
                ok = np.repeat(has, f)
                src = src[rows.reshape(-1)]
                eid = eid[rows.reshape(-1)]
                tag = tag[rows.reshape(-1)]
                dst = np.repeat(frontier, f)
            all_src.append(np.where(ok, src, -1))
            all_dst.append(dst)
            all_eid.append(np.where(ok, eid, -1))
            all_part.append(np.where(ok, tag, -1))
            all_ok.append(ok)
            nxt = src[ok]
            frontier = np.unique(nxt) if len(nxt) else frontier[:0]
            if not len(frontier):
                frontier = np.zeros(1, np.int64)

        src_g = np.concatenate(all_src)
        dst_g = np.concatenate(all_dst)
        eid_g = np.concatenate(all_eid)
        part_g = np.concatenate(all_part)
        valid = np.concatenate(all_ok)
        if all(f == -1 for f in self.fanouts):
            # dense edge order -> bit-consistent segment accumulation
            order = np.argsort(eid_g, kind="stable")
            src_g, dst_g = src_g[order], dst_g[order]
            eid_g, part_g = eid_g[order], part_g[order]
            valid = valid[order]

        roots = np.asarray(roots, np.int64).reshape(-1)
        uniq = np.unique(np.concatenate(
            [roots, src_g[valid], dst_g[valid]]))
        loc = lambda a: np.searchsorted(uniq, a)
        src_l = np.where(valid, loc(np.where(valid, src_g, uniq[0])), 0)
        dst_l = np.where(valid, loc(np.where(valid, dst_g, uniq[0])), 0)
        return {
            "node_ids": uniq.astype(np.int64),
            "edges": np.stack([src_l, dst_l], 1).astype(np.int32),
            "edge_mask": valid.astype(np.float32),
            "edge_eid": eid_g.astype(np.int64),
            "edge_part": part_g.astype(np.int32),
            "root_local": loc(roots).astype(np.int32),
        }

    # -- GraphBatch assembly --------------------------------------------
    def padded_batch(self, roots: np.ndarray, node_feats, labels=None,
                     *, max_nodes: int, max_edges: int, coords=None,
                     home: int | None = None, sample=None):
        """Fixed-shape GraphBatch dict for a dense-model forward (padded to
        the reference's static caps; ``sample()``'s own node and edge
        counts are the valid prefix).

        ``node_feats`` is either the (V, d) feature array or a callable
        ``fetch(global_ids) -> (n, d)`` — the serving path passes the
        partition's feature store (local shard + hot-vertex cache) here.
        Pass ``sample=`` to reuse an already-drawn ``sample()`` result
        (the cache-parity suites batch the same subgraph twice).
        """
        s = sample if sample is not None else self.sample(roots, home=home)
        n, e = len(s["node_ids"]), len(s["edges"])
        if n > max_nodes or e > max_edges:
            raise ValueError(f"sample exceeded caps: nodes {n}/{max_nodes} "
                             f"edges {e}/{max_edges}")
        rows = node_feats(s["node_ids"]) if callable(node_feats) \
            else np.asarray(node_feats)[s["node_ids"]]
        nodes = np.zeros((max_nodes, rows.shape[1]), np.float32)
        nodes[:n] = rows
        node_mask = np.zeros(max_nodes, np.float32)
        node_mask[:n] = 1.0
        edges = np.zeros((max_edges, 2), np.int32)
        edges[:e] = s["edges"]
        edge_mask = np.zeros(max_edges, np.float32)
        edge_mask[:e] = s["edge_mask"]
        lab = np.zeros(max_nodes, np.int32)
        if labels is not None:
            lab[:n] = np.asarray(labels)[s["node_ids"]]
        loss_mask = np.zeros(max_nodes, np.float32)
        loss_mask[s["root_local"]] = 1.0
        batch = {
            "nodes": nodes, "edges": edges, "edge_attr": None,
            "node_mask": node_mask, "edge_mask": edge_mask,
            "graph_ids": np.zeros(max_nodes, np.int32),
            "labels": lab, "loss_mask": loss_mask,
            "root_local": s["root_local"],
        }
        if coords is not None:
            crd = np.zeros((max_nodes, 3), np.float32)
            crd[:n] = np.asarray(coords)[s["node_ids"]]
            batch["coords"] = crd
        return batch


def minibatch_halo_plan(sample: dict, k: int, *, pair_cap_quantile=1.0):
    """Re-plan a sampled subgraph as a halo exchange.

    Each sampled edge carries the partition its CSC row came from
    (``edge_part``); using that as the minibatch's edge assignment makes
    the ``dist.partitioned_gnn`` planner take sampled minibatches
    unmodified — the plan is over subgraph-local vertex ids
    (positions in ``sample['node_ids']``).
    """
    from ..dist.partitioned_gnn import plan_halo_exchange
    valid = sample["edge_mask"] > 0
    edges = sample["edges"][valid].astype(np.int64)
    asg = sample["edge_part"][valid].astype(np.int64)
    return plan_halo_exchange(edges, asg, len(sample["node_ids"]), k,
                              pair_cap_quantile=pair_cap_quantile)
