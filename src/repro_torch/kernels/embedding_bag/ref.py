"""Plain torch version of the ``embedding_bag`` kernel: the CPU path of
``embedding_bag`` and the yardstick the CUDA kernel is held to on the card.

The gather follows JAX's index semantics (``wrap_clamp_index``); the
weighted sum is float32 (an einsum of float32 operands, as the
reference's); ``mean`` divides by ``max(sum of weights, 1e-9)`` with the
weights summed in float32, as the reference's Pallas kernel does (its
``ref.py`` sums bf16 weights in bf16); the output is in the table's dtype.
"""
from __future__ import annotations

import torch

from .. import wrap_clamp_index

MODES = ("sum", "mean")


def embedding_bag_ref(table, indices, weights=None, *, mode: str = "sum"):
    """table: (V, D); indices: (B, L); weights: (B, L) or None (ones)
    -> (B, D)."""
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode {mode!r} (expected one of "
                         f"{MODES})")
    g = table[wrap_clamp_index(indices, table.shape[0])].float()
    w = (torch.ones(indices.shape, dtype=torch.float32,
                    device=table.device)
         if weights is None else weights.float())
    acc = torch.einsum("bld,bl->bd", g, w)
    if mode == "mean":
        acc = acc / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    return acc.to(table.dtype)
