"""Packed replication bit-matrix (the paper's ``v2p`` state, O(|V|*k) bits).

Row ``v`` holds ``ceil(k/32)`` 32-bit words; bit ``p`` of the row says that
vertex ``v`` has a replica on partition ``p``.  The numpy half (host folds,
oracles, metrics) is a copy of the reference's and works on ``uint32``.
The torch half stores the same words as ``int32`` (torch lacks shifts and
scatters for ``uint32``); ``convert.py`` views them as ``uint32`` at the
numpy boundary, so the two layouts are the same bytes.

The hard part is the scatter-OR with duplicate indices: within one chunk
many edges may set bits in the same word.  The reference sorts and
segment-ORs with an associative scan; torch has neither that scan nor a
scatter-OR, so ``set_`` sorts the (word, bit) keys, keeps each distinct key
once, drops the bits already set and adds the rest into their words with
one ``index_add_`` (a sum of distinct powers of two that are not yet set IS
their OR, and never carries).  Every step is exact and needs
no host synchronisation, on the CPU and on the card alike.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32


def num_words(k: int) -> int:
    return (k + WORD_BITS - 1) // WORD_BITS


def alloc_np(num_vertices: int, k: int) -> np.ndarray:
    return np.zeros((num_vertices, num_words(k)), dtype=np.uint32)


# --------------------------------------------------------------------------
# numpy (host / oracle) side
# --------------------------------------------------------------------------

def get_np(bm: np.ndarray, v: np.ndarray, p: np.ndarray) -> np.ndarray:
    """bm[v] bit p, vectorized."""
    w = (p // WORD_BITS).astype(np.int64)
    b = (p % WORD_BITS).astype(np.uint32)
    return (bm[v, w] >> b) & np.uint32(1) != 0


def set_np(bm: np.ndarray, v: np.ndarray, p: np.ndarray) -> None:
    """In-place OR of bit p into row v (handles duplicates)."""
    w = (p // WORD_BITS).astype(np.int64)
    b = (np.uint32(1) << (p % WORD_BITS).astype(np.uint32))
    np.bitwise_or.at(bm, (v, w), b)


def popcount_np(bm: np.ndarray) -> np.ndarray:
    """Per-row population count (number of partitions each vertex touches)."""
    x = bm.astype(np.uint64)
    # SWAR popcount per uint32 word.
    x = x - ((x >> np.uint64(1)) & np.uint64(0x55555555))
    x = (x & np.uint64(0x33333333)) + ((x >> np.uint64(2)) & np.uint64(0x33333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
    # in 64-bit arithmetic the byte-sum trick leaks product bytes above
    # bit 31 — mask them off (uint32 hardware would wrap them away)
    x = ((x * np.uint64(0x01010101)) >> np.uint64(24)) & np.uint64(0xFF)
    return x.sum(axis=1).astype(np.int64)


# --------------------------------------------------------------------------
# torch (device) side
# --------------------------------------------------------------------------

def get(bm: torch.Tensor, v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """bm[v] bit p as bool.  An arithmetic shift of the int32 word keeps
    bit ``b`` at position 0 for every ``b``, sign bit included."""
    w = p // WORD_BITS
    b = p % WORD_BITS
    return ((bm[v, w] >> b) & 1) != 0


def set_(bm: torch.Tensor, v: torch.Tensor, p: torch.Tensor,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """In-place, duplicate-safe OR of bit ``p`` into row ``v`` of the int32
    word matrix ``bm`` (where the reference returns a new matrix, this
    updates ``bm`` and returns it).  ``mask`` disables individual updates.
    """
    # key = word * 32 + bit, with word = v * n_words + p // 32
    key = v.to(torch.int64) * (bm.shape[1] * WORD_BITS) + p.to(torch.int64)
    if mask is not None:
        key = torch.where(mask, key, -1)
    key, _ = torch.sort(key)
    fresh = key >= 0
    fresh[1:] &= key[1:] != key[:-1]
    word = (key >> 5).clamp_min(0)          # masked keys read word 0, add 0
    b = key & 31
    flat = bm.view(-1)
    fresh &= ((flat[word] >> b) & 1) == 0
    # bit 31 is the int32 sign bit
    bit = torch.where(b == 31, -(1 << 31), torch.ones_like(b) << b)
    flat.index_add_(0, word, torch.where(fresh, bit, 0).to(torch.int32))
    return bm


def popcount(bm: torch.Tensor) -> torch.Tensor:
    """Per-row population count as int64 (equals ``popcount_np``)."""
    x = bm.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(dim=1)
