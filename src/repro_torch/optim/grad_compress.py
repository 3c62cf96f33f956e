"""Int8 gradient compression with error feedback, the counterpart of
``repro.optim.grad_compress``: each worker quantizes its gradient to int8
and one float32 scale, and carries the quantization residual into the next
step (error feedback keeps the accumulated update unbiased).

``compressed_psum`` all-reduces the int8 payload over a mesh axis; the
port has no mesh yet, so it raises (ROADMAP.md Queue 1 item 12, the mesh
and sharding slice)."""
from __future__ import annotations

import torch


def compress_int8(g):
    """g: float tensor -> (int8 payload, float32 scale)."""
    g32 = g.float()
    amax = torch.max(torch.abs(g32))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127)
    return q.to(torch.int8), scale


def decompress_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def error_feedback_update(g, residual):
    """Compress (g + residual); return the dequantized gradient (in g's
    dtype) and the new float32 residual."""
    if residual is None:
        residual = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    corrected = g.float() + residual
    q, scale = compress_int8(corrected)
    deq = decompress_int8(q, scale)
    return deq.to(g.dtype), corrected - deq


def compressed_psum(g, axis_name: str, residual):
    """The error-feedback int8 all-reduce over a mesh axis: not ported
    yet."""
    raise NotImplementedError(
        "compressed_psum needs the mesh, which is not ported to repro_torch "
        "yet: see ROADMAP.md Queue 1 item 12 (mesh and sharding)")
