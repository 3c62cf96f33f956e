"""starcoder2-3b [dense] — 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152 — GQA, RoPE, LayerNorm + GELU, biases.  [arXiv:2402.19173; hf]"""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, LM_SHAPES, register


def full() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24,
        n_kv_heads=2, d_ff=12288, vocab=49152, qkv_bias=True, mlp_bias=True,
        norm="layernorm", act="gelu", gated_mlp=False, rope_theta=1e5,
        tie_embeddings=True, dtype="bfloat16", remat="full")


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-3b-smoke", n_layers=2, d_model=48, n_heads=4,
        n_kv_heads=2, d_ff=96, vocab=128, qkv_bias=True, mlp_bias=True,
        norm="layernorm", act="gelu", gated_mlp=False, tie_embeddings=True)


register(ArchSpec(
    arch_id="starcoder2-3b", family="lm", make_config=full,
    make_smoke_config=smoke,
    shapes={**LM_SHAPES,
            "train_4k": {**LM_SHAPES["train_4k"], "microbatches": 4}},
    notes="small dense code LM; extreme GQA (kv=2)"))
