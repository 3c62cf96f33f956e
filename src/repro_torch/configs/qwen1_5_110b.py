"""qwen1.5-110b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-110B; hf]

Registered for its smoke configuration and the tests only: the published
configuration is ~111B parameters, ~222 GB in bf16, which one 80 GB card
does not hold.
"""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, LM_SHAPES, register


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=49152, vocab=152064, qkv_bias=True,
        norm="rmsnorm", act="silu", gated_mlp=True, rope_theta=1e6,
        dtype="bfloat16", remat="full")


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen1.5-110b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=192, vocab=128, qkv_bias=True,
        norm="rmsnorm", act="silu", gated_mlp=True)


register(ArchSpec(
    arch_id="qwen1.5-110b", family="lm", make_config=full,
    make_smoke_config=smoke,
    shapes={**LM_SHAPES,
            "train_4k": {**LM_SHAPES["train_4k"], "microbatches": 8}},
    notes="largest dense LM cell; one card holds its smoke config only"))
