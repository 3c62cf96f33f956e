"""Partitioner -> distributed-compute integration (a numpy copy of the
reference's module; ``bipartite_partition`` runs the port's engine).

This is where the paper's output becomes a *system feature*: the edge
partition produced by 2PS-L (or any baseline) is turned into per-device edge
shards for distributed GNN training, and into a communication-volume model
that feeds the roofline analysis (§Perf): every replicated vertex must have
its partial aggregate synchronized once per message-passing layer, so

    collective_bytes_per_layer ≈ (RF - 1) * |V_covered| * d_hidden * dtype_bytes

which is exactly why the paper optimizes the replication factor.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import bitops


@dataclass
class DeviceShards:
    """Fixed-shape device-major edge shards for shard_map consumption."""
    edges: np.ndarray          # (k, cap, 2) int32, padded with (0, 0)
    counts: np.ndarray         # (k,) int32 valid edges per shard
    cap: int
    replication_factor: float
    sync_vertices: np.ndarray  # (V,) int32: #partitions vertex appears in


def build_device_shards(edges: np.ndarray, assignment: np.ndarray,
                        num_vertices: int, k: int) -> DeviceShards:
    """Scatter the edge list into k fixed-size shards (stream order kept)."""
    counts = np.bincount(assignment, minlength=k).astype(np.int32)
    cap = int(counts.max())
    out = np.zeros((k, cap, 2), np.int32)
    order = np.argsort(assignment, kind="stable")
    sorted_edges = edges[order]
    offs = np.zeros(k + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    for p in range(k):
        out[p, :counts[p]] = sorted_edges[offs[p]:offs[p + 1]]
    bm = bitops.alloc_np(num_vertices, k)
    bitops.set_np(bm, edges[:, 0].astype(np.int64), assignment)
    bitops.set_np(bm, edges[:, 1].astype(np.int64), assignment)
    replicas = bitops.popcount_np(bm)
    covered = max(int((replicas > 0).sum()), 1)
    return DeviceShards(
        edges=out, counts=counts, cap=cap,
        replication_factor=float(replicas.sum()) / covered,
        sync_vertices=replicas.astype(np.int32))


def comm_volume_per_layer(shards: DeviceShards, d_hidden: int,
                          dtype_bytes: int = 4) -> int:
    """Bytes synchronized per GNN message-passing layer under vertex-cut
    execution (PowerGraph-style gather/apply/scatter): each extra replica
    ships its partial aggregate to the master and receives the result."""
    extra = np.maximum(shards.sync_vertices - 1, 0).sum()
    return int(2 * extra * d_hidden * dtype_bytes)


def partition_speedup_report(edges: np.ndarray, assignments: dict[str, np.ndarray],
                             num_vertices: int, k: int, d_hidden: int = 128
                             ) -> dict[str, dict]:
    """Compare partitioners by the distributed-processing cost they induce
    (Table IV's 'partitioning quality drives processing time' argument)."""
    report = {}
    for name, asg in assignments.items():
        sh = build_device_shards(edges, asg, num_vertices, k)
        report[name] = {
            "replication_factor": sh.replication_factor,
            "max_shard": int(sh.counts.max()),
            "balance": float(sh.counts.max() / max(sh.counts.mean(), 1)),
            "comm_bytes_per_layer": comm_volume_per_layer(sh, d_hidden),
        }
    return report


def bipartite_partition(user_hist: np.ndarray, num_users: int,
                        num_items: int, k: int, partitioner, *,
                        device="cuda", **kw):
    """Recsys adapter: treat the user->item interaction multiset as a
    bipartite graph (items offset past users) and edge-partition it, so that
    a user's history edges co-locate with the embedding shards that serve
    them.  ``user_hist``: (n_interactions, 2) of (user_id, item_id).

    ``partitioner`` is either a ``PartitionerSpec`` (run through the
    streaming engine on ``device``; extra kwargs override spec fields) or a
    ``run_*`` callable of ``core/pipeline.py``, called with ``device``."""
    from .specs import PartitionerSpec
    from .stream import InMemoryEdgeStream
    edges = user_hist.copy().astype(np.int32)
    edges[:, 1] += num_users
    stream = InMemoryEdgeStream(edges, num_vertices=num_users + num_items)
    if isinstance(partitioner, PartitionerSpec):
        from .engine import run_spec
        if kw:
            partitioner = partitioner.replace(**kw)
        return run_spec(partitioner, stream, k, device=device)
    return partitioner(stream, k, device=device, **kw)
