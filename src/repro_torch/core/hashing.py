"""Deterministic integer hashing used by 2PS-L's capacity-overflow fallback
and the cluster-id defaults of the LPT mapping.

The `lowbias32` murmur-style finalizer over 32-bit vertex ids, bit-identical
to the reference package's numpy and jax versions.  The numpy half is a
copy.  The torch half works in int64 masked to 32 bits: torch has no
``>>`` or ``%`` for uint32 on the CPU, and each 32x32-bit product is split
into two 16-bit halves so that no intermediate leaves int64's signed range.
"""
from __future__ import annotations

import numpy as np
import torch

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_MASK = 0xFFFFFFFF


def hash_u32_np(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """lowbias32 finalizer over uint32, numpy."""
    h = x.astype(np.uint32) ^ np.uint32(seed * 0x9E3779B9 & 0xFFFFFFFF)
    h ^= h >> np.uint32(16)
    h = (h * np.uint32(_M1)) & np.uint32(0xFFFFFFFF)
    h ^= h >> np.uint32(15)
    h = (h * np.uint32(_M2)) & np.uint32(0xFFFFFFFF)
    h ^= h >> np.uint32(16)
    return h


def hash_mod_np(x: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    return (hash_u32_np(x, seed) % np.uint32(k)).astype(np.int32)


def _mul_u32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``(h * m) mod 2^32`` for ``0 <= h < 2^32`` held in int64."""
    lo = h * (m & 0xFFFF)                               # < 2^48
    hi = ((h * (m >> 16)) & 0xFFFF) << 16               # < 2^32
    return (lo + hi) & _MASK


def hash_u32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """lowbias32 finalizer; ``x`` holds ids in ``[0, 2^32)`` (any integer
    dtype).  Returns int64 values in ``[0, 2^32)``, bit-identical to
    ``hash_u32_np``."""
    h = (x.to(torch.int64) & _MASK) ^ (seed * 0x9E3779B9 & _MASK)
    h = h ^ (h >> 16)
    h = _mul_u32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul_u32(h, _M2)
    h = h ^ (h >> 16)
    return h


def hash_mod(x: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """``hash_u32(x, seed) % k`` as int32, equal to ``hash_mod_np``."""
    return (hash_u32(x, seed) % k).to(torch.int32)
