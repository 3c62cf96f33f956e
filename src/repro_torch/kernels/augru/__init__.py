from .ops import augru, launches
from .ref import augru_ref
