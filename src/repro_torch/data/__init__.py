from .recsys_data import InteractionStream
from .synthetic_graphs import (planted_partition_graph, rmat_graph,
                               scaled_benchmark_graphs)
