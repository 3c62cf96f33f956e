"""Int8 gradient compression with error feedback, the counterpart of
``repro.optim.grad_compress``: each worker quantizes its gradient to int8
and one float32 scale, and carries the quantization residual into the next
step (error feedback keeps the accumulated update unbiased).

``compressed_psum`` all-reduces the int8 payload over one axis of the
ambient ``DeviceMesh`` (``with mesh:``), on each rank's local gradient, as
the reference's runs inside ``shard_map``."""
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
    """Error-feedback int8 all-reduce of this rank's gradient ``g`` over
    mesh axis ``axis_name`` of the ambient mesh.  Returns (mean gradient,
    new residual), the reference's arithmetic: the error-feedback
    dequantized gradient compressed again, its payload summed in int32,
    the scales and the rank count summed, and tot * (scale_sum / n) / n
    (every rank's payload taken at the mean scale)."""
    import torch.distributed as dist
    from ..dist.sharding import _current_mesh
    mesh = _current_mesh()
    if mesh is None:
        raise RuntimeError("compressed_psum: no ambient mesh (call it "
                           "inside `with mesh:`)")
    group = mesh.get_group(axis_name)
    deq, new_residual = error_feedback_update(g, residual)
    q, scale = compress_int8(deq)
    tot = q.to(torch.int32)
    scale_sum = scale.clone()
    n = torch.ones((), dtype=torch.float32, device=g.device)
    for t in (tot, scale_sum, n):
        dist.all_reduce(t, group=group)
    mean = tot.float() * (scale_sum / n) / n
    return mean.to(g.dtype), new_residual
