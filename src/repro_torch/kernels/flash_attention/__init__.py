from .ops import (BLOCKWISE_KV_THRESHOLD, bf16_output_bound, flash_attention,
                  launches)
from .ref import attention_ref, gqa_attention
