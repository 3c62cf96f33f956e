from .ops import augru, augru_backward, backward_launches, du_product, launches
from .ref import augru_backward_ref, augru_ref
