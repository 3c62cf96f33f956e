"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (kv=16) d_ff=1024
vocab=50304, MoE 64 routed top-8, QK-norm.  [arXiv:2409.02060; hf]"""
from ..models.transformer import MoEConfig, TransformerConfig
from .base import ArchSpec, LM_SHAPES, register


def full() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1024, vocab=50304, qk_norm=True,
        norm="rmsnorm", act="silu", gated_mlp=True, rope_theta=1e4,
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                      dispatch_groups=32),
        dtype="bfloat16", remat="full")


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-smoke", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
        d_ff=64, vocab=128, qk_norm=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16))


register(ArchSpec(
    arch_id="olmoe-1b-7b", family="lm", make_config=full,
    make_smoke_config=smoke,
    shapes={**LM_SHAPES,
            "train_4k": {**LM_SHAPES["train_4k"], "microbatches": 8}},
    notes="64 experts top-8: highest dispatch fan-out; experts divide "
          "model=16 -> true expert parallelism"))
