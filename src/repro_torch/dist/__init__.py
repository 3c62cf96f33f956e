"""``repro_torch.dist`` — distributed execution: the sharding rules
(``sharding``: the reference's spec rules, ``constrain``, and the specs as
DTensor ``placements`` on a ``torch.distributed`` ``DeviceMesh``, under
which the LM train step runs sharded) and the bridge from a partition to
distributed execution: the halo-exchange planner (``partitioned_gnn``: ``HaloPlan``,
``plan_halo_exchange{,_stream}``, ``plan_capacities{,_stream}``) and its
host-grouped, DCN-aware re-slicing (``multihost``: ``HostHaloPlan``),
numpy copies of the reference package's planners; plans persist inside a
``repro_torch.core.PartitionArtifact`` and reload through
``load_halo_plan`` without re-reading the edge stream.

The execution half (``partitioned_gnn``: ``partitioned_{gin,gatedgcn,
egnn}_loss``, ``partitioned_egnn_forward`` and
``make_partitioned_{gnn,gin,gatedgcn,egnn}_step``) trains a GNN over the
partitions with the reference's signatures and batch layout, on one of
two routes: all k partitions in one process on one device
(``launch.mesh.make_host_mesh``; every exchange a fixed-order ``spmm``),
or one partition a ``torch.distributed`` rank (a ``DeviceMesh``; the
exchange ``all_to_all_single`` and ``all_reduce``).
"""
from .sharding import (P, PartitionSpec, best_spec, constrain, fsdp_axes,
                       gnn_batch_specs, lm_batch_specs, lm_cache_specs,
                       lm_param_specs, opt_state_specs, placements,
                       recsys_batch_specs, recsys_param_specs)
from .multihost import (HostHaloPlan, host_plan_from_halo,
                        normalize_host_groups, split_mesh_axes)
from .partitioned_gnn import (HaloPlan, capacities_from_plan,
                              load_halo_plan,
                              make_partitioned_egnn_step,
                              make_partitioned_gatedgcn_step,
                              make_partitioned_gin_step,
                              make_partitioned_gnn_step,
                              partitioned_egnn_forward,
                              partitioned_egnn_loss,
                              partitioned_gatedgcn_loss,
                              partitioned_gin_loss, plan_capacities,
                              plan_capacities_stream, plan_halo_exchange,
                              plan_halo_exchange_stream)

__all__ = [
    "P", "PartitionSpec", "best_spec", "constrain", "fsdp_axes",
    "gnn_batch_specs", "lm_batch_specs", "lm_cache_specs", "lm_param_specs",
    "opt_state_specs", "placements", "recsys_batch_specs",
    "recsys_param_specs",
    "HaloPlan", "HostHaloPlan", "capacities_from_plan",
    "host_plan_from_halo", "load_halo_plan",
    "make_partitioned_egnn_step", "make_partitioned_gatedgcn_step",
    "make_partitioned_gin_step", "make_partitioned_gnn_step",
    "normalize_host_groups", "partitioned_egnn_forward",
    "partitioned_egnn_loss", "partitioned_gatedgcn_loss",
    "partitioned_gin_loss", "plan_capacities", "plan_capacities_stream",
    "plan_halo_exchange", "plan_halo_exchange_stream", "split_mesh_axes",
]
