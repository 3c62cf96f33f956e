from .ops import (ROUTES, SPLIT_EDGES, BoundEdges, TilePrep,
                  abstract_tiles, backward_launches, launches,
                  prepare_tiles, route, segment_sum_tiles, spmm)
from .ref import segment_sum_ref, sorted_sum_ref, spmm_ref
