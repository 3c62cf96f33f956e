from .ops import hdrf_choose, hdrf_choose_bits, launches
from .ref import hdrf_choose_bits_ref, hdrf_choose_ref
