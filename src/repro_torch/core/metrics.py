"""Partitioning quality metrics (paper §II-A)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import bitops


@dataclass
class PartitionQuality:
    replication_factor: float      # RF = (1/|V|) sum_i |V(p_i)|
    balance: float                 # max_i |p_i| / (|E|/k)  (the measured alpha)
    max_partition: int
    min_partition: int
    part_sizes: np.ndarray
    num_vertices_covered: int

    def __repr__(self):
        return (f"PartitionQuality(rf={self.replication_factor:.4f}, "
                f"alpha={self.balance:.4f}, sizes=[{self.min_partition}"
                f"..{self.max_partition}])")


def quality_from_bitmatrix(v2p_bits: np.ndarray, part_sizes: np.ndarray,
                           num_edges: int) -> PartitionQuality:
    k = len(part_sizes)
    replicas = bitops.popcount_np(v2p_bits)
    covered = int((replicas > 0).sum())
    denom = max(covered, 1)
    rf = float(replicas.sum()) / denom
    return PartitionQuality(
        replication_factor=rf,
        balance=float(part_sizes.max()) / (num_edges / k) if num_edges else 0.0,
        max_partition=int(part_sizes.max()),
        min_partition=int(part_sizes.min()),
        part_sizes=np.asarray(part_sizes),
        num_vertices_covered=covered,
    )


def quality_from_assignment(edges: np.ndarray, assignment: np.ndarray,
                            num_vertices: int, k: int) -> PartitionQuality:
    """Recompute quality from scratch given edge->partition assignment.

    This is the *oracle* metric path: it does not trust any incrementally
    maintained state, so tests can cross-check the streaming bookkeeping.
    """
    assert assignment.min() >= 0 and assignment.max() < k
    bm = bitops.alloc_np(num_vertices, k)
    bitops.set_np(bm, edges[:, 0].astype(np.int64), assignment)
    bitops.set_np(bm, edges[:, 1].astype(np.int64), assignment)
    sizes = np.bincount(assignment, minlength=k)
    return quality_from_bitmatrix(bm, sizes, len(edges))


def capacity(num_edges: int, k: int, alpha: float) -> int:
    """Hard per-partition edge cap  ceil(alpha * |E| / k)."""
    return int(np.ceil(alpha * num_edges / k))


# ---------------------------------------------------------------------------
# hierarchy-aware quality: cross-host replication
# ---------------------------------------------------------------------------

def host_assignment(k: int, num_hosts: int) -> np.ndarray:
    """(k,) int32 partition -> host group id under the contiguous
    equal-block layout (partition ``p`` on host ``p // (k/H)`` — the same
    layout ``repro.dist.multihost.normalize_host_groups`` canonicalizes
    to).  ``num_hosts`` must divide ``k``."""
    if num_hosts < 1 or k % num_hosts:
        raise ValueError(f"num_hosts={num_hosts} must divide k={k}")
    return np.repeat(np.arange(num_hosts, dtype=np.int32), k // num_hosts)


def cross_host_replicas(v2p_bits: np.ndarray, k: int,
                        num_hosts: int) -> np.ndarray:
    """(V,) number of HOST GROUPS each vertex is replicated on — every
    count above 1 is a vertex whose halo state must cross the DCN.  Uses
    the contiguous equal-block layout of ``host_assignment``.  One
    O(V * words) masked sweep per host, so the metric stays linear."""
    host_of = host_assignment(k, num_hosts)
    n_words = v2p_bits.shape[1]
    counts = np.zeros(v2p_bits.shape[0], np.int64)
    for h in range(num_hosts):
        mask = np.zeros(n_words, np.uint32)
        for p in np.nonzero(host_of == h)[0]:
            mask[p // bitops.WORD_BITS] |= np.uint32(1) << np.uint32(
                p % bitops.WORD_BITS)
        counts += (v2p_bits & mask[None, :]).any(axis=1)
    return counts


def cross_host_replication_factor(v2p_bits: np.ndarray, k: int,
                                  num_hosts: int) -> float:
    """Cross-host RF = mean number of host groups per covered vertex — the
    hierarchy-aware analogue of the paper's replication factor, because it
    IS the per-layer DCN synchronization volume of the downstream graph
    computation (each extra host holding a vertex is one more aggregated
    DCN lane entry).

    Invariants (tested): equals the flat RF when every partition is its
    own host (``num_hosts == k``); equals 1.0 with a single host group;
    and for any grouping sits in ``[RF / (k/num_hosts), RF]`` — a host
    holds a vertex at most once however many of its partitions do."""
    hosts = cross_host_replicas(v2p_bits, k, num_hosts)
    covered = int((hosts > 0).sum())
    return float(hosts.sum()) / max(covered, 1)
