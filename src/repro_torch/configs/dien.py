"""dien [recsys] — embed_dim=18 seq_len=100 gru_dim=108 mlp=200-80
interaction=augru.  [arXiv:1809.03672]"""
from ..models.recsys import DIENConfig
from .base import ArchSpec, RECSYS_SHAPES, register

N_ITEMS_FULL = 2_097_152     # production-scale sparse table rows (2^21)


def full() -> DIENConfig:
    return DIENConfig(name="dien", n_items=N_ITEMS_FULL, embed_dim=18,
                      seq_len=100, gru_dim=108, mlp_dims=(200, 80))


def smoke() -> DIENConfig:
    return DIENConfig(name="dien-smoke", n_items=500, embed_dim=8,
                      seq_len=12, gru_dim=24, mlp_dims=(32, 16))


register(ArchSpec(
    arch_id="dien", family="recsys", make_config=full,
    make_smoke_config=smoke, shapes=RECSYS_SHAPES,
    notes="embedding lookup is the hot path; AUGRU recurrence serialized "
          "over seq_len=100 (kernels/augru keeps U in shared memory)"))
