from .ops import edge_score_choose, edge_score_choose_bits, launches
from .ref import edge_score_choose_bits_ref, edge_score_choose_ref
