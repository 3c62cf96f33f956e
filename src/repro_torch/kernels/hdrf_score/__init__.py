from .ops import hdrf_choose, launches
from .ref import hdrf_choose_ref
