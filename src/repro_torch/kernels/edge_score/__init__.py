from .ops import edge_score_choose, launches
from .ref import edge_score_choose_ref
