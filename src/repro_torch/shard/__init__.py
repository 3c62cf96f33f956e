"""repro_torch.shard — sharded multi-worker partitioning (docs/distributed.md),
the reference package's ``repro.shard`` in PyTorch.

N workers each stream a disjoint share of the edge chunks through the
same pass pipeline as the sequential engine; the O(|V|) partitioner
state is exchanged and merged at round boundaries
(``StreamingPartitioner.merge_rules`` — commutative + associative, so
every rank computes the identical merge locally).  ``run_spec_sharded``
is the in-process emulated run; ``repro_torch.launch.dist_partition``
drives real multi-process runs over the same ``run_worker``.  The
assignments are the reference's at the same worker count and round
geometry.
"""
from .backends import (ExchangeTimeout, FileExchange, ThreadExchange,
                       TorchDistributedExchange)
from .engine import (ShardLayout, ShardWorkerResult, finalize_shard_run,
                     run_spec_sharded, run_worker)
from .state import ShardState

__all__ = ["ExchangeTimeout", "FileExchange", "ShardLayout", "ShardState",
           "ShardWorkerResult", "ThreadExchange", "TorchDistributedExchange",
           "finalize_shard_run", "run_spec_sharded", "run_worker"]
