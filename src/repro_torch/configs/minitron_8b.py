"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 — pruned Nemotron-4 (squared-ReLU, no bias).
[arXiv:2407.14679; hf]"""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, LM_SHAPES, register


def full() -> TransformerConfig:
    return TransformerConfig(
        name="minitron-8b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_ff=16384, vocab=256000, qkv_bias=False,
        norm="layernorm", act="relu2", gated_mlp=False, rope_theta=1e4,
        dtype="bfloat16", remat="full")


def smoke() -> TransformerConfig:
    return TransformerConfig(
        name="minitron-8b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=256, norm="layernorm", act="relu2",
        gated_mlp=False)


register(ArchSpec(
    arch_id="minitron-8b", family="lm", make_config=full,
    make_smoke_config=smoke,
    shapes={**LM_SHAPES,
            "train_4k": {**LM_SHAPES["train_4k"], "microbatches": 4}},
    notes="huge vocab (256k): embedding/softmax dominate at small seq"))
