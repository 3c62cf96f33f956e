from .ops import BLOCKWISE_KV_THRESHOLD, flash_attention, launches
from .ref import attention_ref, gqa_attention
