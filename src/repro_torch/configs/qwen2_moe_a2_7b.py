"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (kv=16) d_ff=1408
vocab=151936, MoE 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from ..models.transformer import MoEConfig, TransformerConfig
from .base import ArchSpec, LM_SHAPES, register


def full() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=151936, qkv_bias=True,
        norm="rmsnorm", act="silu", gated_mlp=True, rope_theta=1e6,
        moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                      num_shared=4,
                      dispatch_groups=32),
        dtype="bfloat16", remat="full")


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-smoke", n_layers=2, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab=128, qkv_bias=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16, num_shared=2))


register(ArchSpec(
    arch_id="qwen2-moe-a2.7b", family="lm", make_config=full,
    make_smoke_config=smoke,
    shapes={**LM_SHAPES,
            "train_4k": {**LM_SHAPES["train_4k"], "microbatches": 8}},
    notes="60 experts NOT divisible by model=16: expert dim falls back to "
          "FSDP sharding, TP on the expert FFN dim (see dist/sharding)"))
