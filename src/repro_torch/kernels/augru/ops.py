"""Public wrapper of the ``augru`` kernel: dispatch on the device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain torch version in ``ref.py``.  Nothing falls
back from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from .. import LaunchCounter
from . import kernel
from .ref import augru_ref

launches = LaunchCounter()

_INT_MAX = 2**31 - 1


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"augru: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"augru: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"augru: {name} has dtype {t.dtype}, expected "
                        f"torch.float32")
    if tuple(t.shape) != shape:
        raise ValueError(f"augru: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"augru: {name} is not contiguous")


def augru(x_gates, u, att, h0):
    """x_gates: (B, T, 3H) precomputed input gates (layout r|z|n);
    u: (H, 3H) recurrent weights; att: (B, T); h0: (B, H).
    Returns hidden states (B, T, H)."""
    if x_gates.device.type != "cuda":
        return augru_ref(x_gates, u, att, h0)
    if x_gates.dim() != 3 or h0.dim() != 2:
        raise ValueError(f"augru: x_gates must be (B, T, 3H) and h0 (B, H), "
                         f"got {tuple(x_gates.shape)} and "
                         f"{tuple(h0.shape)}")
    B, T, H = x_gates.shape[0], x_gates.shape[1], h0.shape[1]
    if max(B, T, H) > _INT_MAX:
        raise ValueError(f"augru: B, T, H must fit in int32, got "
                         f"{(B, T, H)}")
    dev = x_gates.device
    _check("x_gates", x_gates, (B, T, 3 * H), dev)
    _check("u", u, (H, 3 * H), dev)
    _check("att", att, (B, T), dev)
    _check("h0", h0, (B, H), dev)
    out = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    kernel.launch(x_gates, u, att, h0, out=out)
    launches.count += 1
    return out
