"""Public EmbeddingBag op: dispatch on the device.

``impl="auto"`` sends a CUDA tensor to the hand-written kernel, which
launches or raises, and a CPU tensor to the plain torch version in
``ref.py``; ``impl="ref"`` forces the plain version.  The reference's
``pallas`` and ``pallas_interpret`` have no meaning here and raise, as
does any other value.  Nothing falls back from the kernel to the plain
version.
"""
from __future__ import annotations

import torch

from .. import LaunchCounter
from . import kernel
from .ref import MODES, embedding_bag_ref

launches = LaunchCounter()

IMPLS = ("auto", "ref")

_MAX_BLOCKS = 2**31 - 1


def _check(table, indices, weights):
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"embedding_bag: table must be (V, D) and indices "
                         f"(B, L), got {tuple(table.shape)} and "
                         f"{tuple(indices.shape)}")
    for name, t in (("indices", indices), ("weights", weights)):
        if t is not None and t.device != table.device:
            raise ValueError(f"embedding_bag: {name} is on {t.device}, the "
                             f"table on {table.device}")
    if weights is not None and tuple(weights.shape) != tuple(indices.shape):
        raise ValueError(f"embedding_bag: weights {tuple(weights.shape)} "
                         f"do not match indices {tuple(indices.shape)}")
    if table.dtype not in kernel.DTYPES:
        raise TypeError(f"embedding_bag: table dtype {table.dtype} (the "
                        f"kernel takes float32 or bf16)")
    if indices.dtype not in kernel.INDEX_DTYPES:
        raise TypeError(f"embedding_bag: indices dtype {indices.dtype}, "
                        f"expected int32 or int64")
    if weights is not None and not weights.is_floating_point():
        raise TypeError(f"embedding_bag: weights dtype {weights.dtype}")
    if not table.is_contiguous():
        raise ValueError("embedding_bag: table is not contiguous")
    B, L = indices.shape
    if L and table.shape[0] == 0:
        raise ValueError("embedding_bag: lookups into an empty table")
    if -(-B // 8) > _MAX_BLOCKS:
        raise ValueError(f"embedding_bag: {B} bags beyond the kernel's "
                         f"grid (8 a block)")


def embedding_bag(table, indices, weights=None, *, mode: str = "sum",
                  impl: str = "auto"):
    """table: (V, D); indices: (B, L); weights: (B, L) or None -> (B, D) in
    the table's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"embedding_bag: impl {impl!r} (expected one of "
                         f"{IMPLS})")
    if mode not in MODES:
        raise ValueError(f"embedding_bag: mode {mode!r} (expected one of "
                         f"{MODES})")
    if impl == "ref" or table.device.type != "cuda":
        return embedding_bag_ref(table, indices, weights, mode=mode)
    _check(table, indices, weights)
    indices = indices.contiguous()
    if weights is not None:
        weights = weights.float().contiguous()
    out = torch.empty((indices.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    kernel.launch(table, indices, weights, mean=mode == "mean", out=out)
    launches.add()
    return out
