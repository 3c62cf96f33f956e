"""``repro_torch.dist`` — the bridge from a partition to distributed
execution: the halo-exchange planner (``partitioned_gnn``: ``HaloPlan``,
``plan_halo_exchange{,_stream}``, ``plan_capacities{,_stream}``) and its
host-grouped, DCN-aware re-slicing (``multihost``: ``HostHaloPlan``).
Both are numpy copies of the reference package's planners; plans persist
inside a ``repro_torch.core.PartitionArtifact`` and reload through
``load_halo_plan`` without re-reading the edge stream.
"""
from .multihost import (HostHaloPlan, host_plan_from_halo,
                        normalize_host_groups, split_mesh_axes)
from .partitioned_gnn import (HaloPlan, capacities_from_plan,
                              load_halo_plan, plan_capacities,
                              plan_capacities_stream, plan_halo_exchange,
                              plan_halo_exchange_stream)

__all__ = [
    "HaloPlan", "HostHaloPlan", "capacities_from_plan",
    "host_plan_from_halo", "load_halo_plan", "normalize_host_groups",
    "plan_capacities", "plan_capacities_stream", "plan_halo_exchange",
    "plan_halo_exchange_stream", "split_mesh_axes",
]
