"""Host-grouped, DCN-aware halo-exchange layout for multi-host meshes.

A copy of the reference package's ``dist/multihost.py`` (numpy and ``obs``
only): the port persists the same ``host_plan.npz``.

``HaloPlan`` (dist.partitioned_gnn) assumes one partition per device on a
single process: every replica pair exchanges over one flat all_to_all.  On a
multi-host ``(pod, data, model)`` mesh that is wrong twice over — the
per-pair lanes crossing hosts ride the slow DCN, and a vertex replicated on
three partitions of a remote host crosses the DCN three times.  Following
the hierarchy-aware placement argument of Hybrid Edge Partitioning
(arXiv:2103.12594) and Scalable Edge Partitioning (arXiv:1808.06411), a
``HostHaloPlan`` splits the exchange into two levels:

1. **intra-host** (ICI): the base plan's pairwise lanes restricted to
   partition pairs on the same host — one tiled all_to_all over the
   trailing (device) mesh axes.  After it, every replica holds its *host
   partial* ``S_A(v)`` (the sum over the host's partitions holding v).
2. **inter-host** (DCN): per ordered host pair ``(A, B)`` one aggregated
   lane holding each shared vertex exactly once (sorted by global id).  A
   unique *leader* partition per (host, vertex) contributes ``S_A(v)``;
   the lane is host-replicated with a psum over the device axes, crosses
   the DCN in one tiled all_to_all over the leading (host) axes, and
   scatter-adds into every local replica on the receiving host.

The quantile-capped psum overflow lane of the base plan is untouched (it
is already a full-mesh reduction).  With a single host group the plan
collapses exactly to the base ``HaloPlan``: the intra tables ARE the full
pair tables and the host lanes are empty — bit-identical execution.

Aggregation bounds each (host pair, vertex) to ONE crossing, but the
number of crossings is fixed by the partitioning itself.  The partitioner
can shrink it at the source: ``PartitionerSpec(host_groups=H,
dcn_penalty=P)`` penalizes candidates whose host group holds no replica
of an endpoint during the scoring pass (``core/scoring.py``), lowering
``dcn_summary()['cross_host_rf']`` — and with it every lane below —
before this module ever slices tables.  See docs/multihost.md for the
three levels together.

Layout constraint: host ``A`` must own partitions ``[A*D, (A+1)*D)`` (the
mesh places partition ``p`` on flat device ``p``), so ``host_groups`` is
either a host count ``H`` dividing ``k`` or that exact contiguous
equal-size grouping spelled out.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import obs


def normalize_host_groups(k: int, host_groups) -> tuple[tuple[int, ...], ...]:
    """``host_groups`` (an int host count, or explicit groups) -> the
    canonical contiguous equal-size grouping; raises on anything the mesh
    placement (partition p on flat device p) could not execute."""
    if isinstance(host_groups, (int, np.integer)):
        h = int(host_groups)
        if h < 1 or k % h:
            raise ValueError(f"host count {h} must divide k={k}")
        d = k // h
        return tuple(tuple(range(a * d, (a + 1) * d)) for a in range(h))
    groups = tuple(tuple(int(p) for p in g) for g in host_groups)
    flat = [p for g in groups for p in g]
    if sorted(flat) != list(range(k)):
        raise ValueError(f"host groups must partition range({k})")
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError("host groups must be equal-size (rectangular mesh)")
    if flat != list(range(k)):
        raise ValueError("host groups must be contiguous, in order: the "
                         "mesh places partition p on flat device p")
    return groups


@dataclass
class HostHaloPlan:
    """Two-level halo-exchange plan (see module docstring).

    ``base`` is the untouched single-level ``HaloPlan`` — its edge arrays,
    vertex maps and overflow lane are shared; only the exchange tables are
    re-sliced into the two levels below.
    """
    base: object                # HaloPlan
    num_hosts: int
    parts_per_host: int
    hb_cap: int                 # widest aggregated inter-host lane
    host_of: np.ndarray         # (k,) int32  partition -> host
    intra_send: np.ndarray      # (k, D, b_cap) int32, -1 padded
    intra_recv: np.ndarray      # (k, D, b_cap) int32, -1 padded
    hsend_idx: np.ndarray       # (k, H, hb_cap) int32, leader-only, -1 pad
    hrecv_idx: np.ndarray       # (k, H, hb_cap) int32, every holder, -1 pad
    host_pair_sizes: np.ndarray  # (H, H) int64 aggregated DCN lane sizes

    # -- base-plan delegation -------------------------------------------
    @property
    def k(self) -> int:
        return self.base.k

    @property
    def v_cap(self) -> int:
        return self.base.v_cap

    @property
    def e_cap(self) -> int:
        return self.base.e_cap

    @property
    def b_cap(self) -> int:
        return self.base.b_cap

    @property
    def o_cap(self) -> int:
        return self.base.o_cap

    @property
    def replication_factor(self) -> float:
        return self.base.replication_factor

    @property
    def vmap_global(self) -> np.ndarray:
        return self.base.vmap_global

    def device_arrays(self) -> dict:
        """The arrays the SPMD step consumes.  ``send_idx``/``recv_idx``
        are the *intra-host* tables (full tables when num_hosts == 1), and
        the presence of ``hsend_idx`` is what routes ``_halo_combine`` onto
        the two-level path."""
        return {"edges": self.base.edges, "edge_mask": self.base.edge_mask,
                "node_mask": self.base.node_mask,
                "send_idx": self.intra_send, "recv_idx": self.intra_recv,
                "ov_idx": self.base.ov_idx,
                "hsend_idx": self.hsend_idx, "hrecv_idx": self.hrecv_idx}

    def cross_host_replication_factor(self) -> float:
        """Mean number of host groups holding each covered vertex — the
        hierarchy-aware analogue of the flat RF (and the quantity the
        spec-level ``dcn_penalty`` shrinks at partition time).  Computed
        from the base plan's vertex maps, so it agrees with
        ``repro_torch.core.metrics.cross_host_replication_factor`` on the
        bit matrix of the same assignment."""
        d = self.parts_per_host
        per_host = []
        for h in range(self.num_hosts):
            vs = self.vmap_global[h * d:(h + 1) * d]
            per_host.append(np.unique(vs[vs >= 0]))
        pairs = sum(len(held) for held in per_host)
        covered = len(np.unique(np.concatenate(per_host)))
        return pairs / max(covered, 1)

    def dcn_summary(self) -> dict:
        """How much the host layout saves on the DCN: rows any naive
        per-partition-pair exchange would ship across hosts versus the
        aggregated lanes (each shared vertex crosses once per ordered host
        pair), plus the cross-host replication factor — the knob a
        ``dcn_penalty`` partition run shrinks at the source (compare this
        block across artifacts to see the lane reduction)."""
        k, d = self.k, self.parts_per_host
        cross = self.host_of[:, None] != self.host_of[None, :]
        naive = int(((self.base.send_idx >= 0).sum(axis=-1) * cross).sum())
        agg = int(self.host_pair_sizes.sum())
        return {
            "num_hosts": int(self.num_hosts),
            "parts_per_host": int(d),
            "hb_cap": int(self.hb_cap),
            "dcn_rows_naive": naive,
            "dcn_rows_aggregated": agg,
            "dcn_aggregation_ratio": (naive / agg) if agg else 1.0,
            "cross_host_rf": float(self.cross_host_replication_factor()),
            "flat_rf": float(self.replication_factor),
        }


def host_plan_from_halo(plan, host_groups) -> HostHaloPlan:
    """Re-slice a built ``HaloPlan`` into the two-level host layout.

    Pure table surgery over the finished plan — works identically on a
    fresh plan and on one reloaded from a ``PartitionArtifact``, and the
    in-memory/streamed planners therefore stay bit-identical by
    construction (they already agree on the base plan)."""
    groups = normalize_host_groups(plan.k, host_groups)
    with obs.get_tracer().span("host_plan", cat="halo", num_hosts=len(groups)):
        return _host_plan_from_halo(plan, groups)


def _host_plan_from_halo(plan, groups) -> HostHaloPlan:
    h, d = len(groups), len(groups[0])
    k, b_cap = plan.k, plan.b_cap
    host_of = np.repeat(np.arange(h, dtype=np.int32), d)
    part_counts = (plan.vmap_global >= 0).sum(axis=1)

    # level 1: the base pair tables restricted to same-host peers, indexed
    # by device position within the host (all_to_all over the device axes)
    intra_send = np.empty((k, d, b_cap), np.int32)
    intra_recv = np.empty((k, d, b_cap), np.int32)
    for p in range(k):
        lo = int(host_of[p]) * d
        intra_send[p] = plan.send_idx[p, lo:lo + d]
        intra_recv[p] = plan.recv_idx[p, lo:lo + d]

    # level 2: aggregated per-host-pair lanes — the union of the cross-host
    # pair lanes, each shared vertex once, ascending global order
    lanes = [[np.empty(0, np.int64)] * h for _ in range(h)]
    host_pair_sizes = np.zeros((h, h), np.int64)
    for a in range(h):
        for b in range(h):
            if a == b:
                continue
            vs = []
            for p in groups[a]:
                row = plan.send_idx[p, groups[b][0]:groups[b][-1] + 1]
                sel = row[row >= 0]
                if len(sel):
                    vs.append(plan.vmap_global[p][sel])
            if vs:
                lanes[a][b] = np.unique(np.concatenate(vs))
            host_pair_sizes[a, b] = len(lanes[a][b])
    hb_cap = int(host_pair_sizes.max()) if h > 1 else 0

    hsend = np.full((k, h, hb_cap), -1, np.int32)
    hrecv = np.full((k, h, hb_cap), -1, np.int32)
    for a in range(h):
        for b in range(h):
            lane = lanes[a][b]
            if not len(lane):
                continue
            # leader = lowest partition in a holding the vertex; every
            # holder in a receives the (b -> a) lane (same vertex set,
            # exchange symmetry) at the same slot
            unled = np.ones(len(lane), bool)
            for p in groups[a]:
                n = int(part_counts[p])
                if n == 0:
                    continue
                vm = plan.vmap_global[p, :n]
                pos = np.searchsorted(vm, lane)
                held = (pos < n) & (vm[np.minimum(pos, n - 1)] == lane)
                lead = held & unled
                hsend[p, b, np.nonzero(lead)[0]] = pos[lead]
                hrecv[p, b, np.nonzero(held)[0]] = pos[held]
                unled &= ~lead
            assert not unled.any(), "lane vertex with no holder in host"

    hp = HostHaloPlan(
        base=plan, num_hosts=h, parts_per_host=d, hb_cap=hb_cap,
        host_of=host_of, intra_send=intra_send, intra_recv=intra_recv,
        hsend_idx=hsend, hrecv_idx=hrecv, host_pair_sizes=host_pair_sizes)
    reg = obs.get_registry()
    if reg.enabled:
        s = hp.dcn_summary()
        reg.gauge("halo.dcn_rows_aggregated").set(s["dcn_rows_aggregated"])
        reg.gauge("halo.dcn_rows_naive").set(s["dcn_rows_naive"])
        reg.gauge("halo.intra_rows").set(
            int((hp.intra_send >= 0).sum()))
    return hp


def split_mesh_axes(mesh, num_hosts: int) -> tuple[tuple, tuple]:
    """(host_axes, device_axes): the leading mesh axes whose sizes multiply
    to ``num_hosts`` form the host (DCN) group; the trailing axes are the
    intra-host device group.  Raises when no prefix matches."""
    names = tuple(mesh.axis_names)
    sizes = [int(s) for s in np.shape(mesh.devices)]
    prod, i = 1, 0
    while i < len(names) and prod < num_hosts:
        prod *= sizes[i]
        i += 1
    if prod != num_hosts:
        raise ValueError(
            f"mesh axes {dict(zip(names, sizes))} have no leading prefix of "
            f"size num_hosts={num_hosts}; reorder the mesh so the host "
            f"(DCN) axes come first")
    return names[:i], names[i:]
