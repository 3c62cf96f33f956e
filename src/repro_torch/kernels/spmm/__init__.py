from .ops import (SPLIT_EDGES, TilePrep, launches, prepare_tiles,
                  segment_sum_tiles, spmm)
from .ref import segment_sum_ref, spmm_ref
