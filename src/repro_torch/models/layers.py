"""Shared dense layer, the port's counterpart of ``repro.models.layers``.

Parameters are plain dicts of tensors, as the reference's pytrees.  The
weight keeps the reference's ``(d_in, d_out)`` layout, so ``x @ w + b`` is
the same product (``nn.Linear`` would store the transpose).  Only what DIEN
needs is here; the norms come with the LM slice.
"""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float | None = None,
               dtype=torch.float32, device=None) -> dict:
    """``w ~ N(0, 1) * scale`` (default ``1/sqrt(d_in)``) drawn from
    ``generator``, zero bias.  ``device`` defaults to the generator's."""
    device = generator.device if device is None else device
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p = {"w": torch.randn((d_in, d_out), generator=generator, dtype=dtype,
                          device=device) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y
