"""Optimizer substrate of the port, the counterpart of ``repro.optim``:
functional AdamW with global-norm clipping, learning-rate schedules and
int8 gradient compression with error feedback."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .grad_compress import (compress_int8, compressed_psum, decompress_int8,
                            error_feedback_update)
from .schedules import constant_lr, linear_warmup_cosine
