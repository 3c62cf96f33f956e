from .ops import embedding_bag, launches
from .ref import embedding_bag_ref
