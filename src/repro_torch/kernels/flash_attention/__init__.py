from .ops import (BLOCKWISE_KV_THRESHOLD, backward_launches,
                  bf16_gradient_bound, bf16_output_bound, flash_attention,
                  flash_attention_backward, launches)
from .ref import attention_ref, gqa_attention, gqa_attention_backward
