"""Carry 2PS-L chunk state between the reference's numpy layout and the
port's tensors.

The reference's per-chunk state is a dict of arrays: ``sizes``, ``d``,
``vol``, ``v2c``, ``c2p``, ``host_of`` (int32) and the packed replication
matrices ``bits`` / ``hbits`` (uint32 words).  The port keeps the same
arrays as tensors, with the word matrices as int32 — the same bytes, viewed
as signed.  Feeding identical state through both packages is how the
chunk-level tests compare them; it is this system's counterpart of
carrying weights across.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_KEYS = ("bits", "hbits")


def words_to_torch(words: np.ndarray, device) -> torch.Tensor:
    """uint32 word matrix -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy matrix with the same bits."""
    return words.detach().cpu().numpy().view(np.uint32)


def state_to_torch(state: dict, device) -> dict:
    """numpy state dict (reference layout) -> tensors on ``device``."""
    out = {}
    for key, arr in state.items():
        if key in WORD_KEYS:
            out[key] = words_to_torch(arr, device)
        else:
            out[key] = torch.from_numpy(
                np.array(arr, dtype=np.int32)).to(device)
    return out


def state_to_numpy(state: dict) -> dict:
    """Port state dict -> numpy arrays in the reference's layout."""
    return {key: (words_to_numpy(t) if key in WORD_KEYS
                  else t.detach().cpu().numpy())
            for key, t in state.items()}
