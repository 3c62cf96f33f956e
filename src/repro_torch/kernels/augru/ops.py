"""Public wrapper of the ``augru`` kernel: dispatch on the device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain torch version in ``ref.py``.  Nothing falls
back from the kernel to the plain version.

When grad is enabled and an operand requires it, ``augru`` runs through an
autograd ``Function`` whose backward is the backward kernel on the card
(``augru_backward``, counted in ``backward_launches``) and its plain
version, ``augru_backward_ref``, on the CPU; the plain forward's autograd
never runs on a CUDA tensor.  The backward kernel takes the route
``kernel.backward_plan`` picks by shape (``tile`` for large batches,
``rows`` for small ones and large H) and writes every gradient but du,
which ``du_product`` forms afterwards as one large product.
"""
from __future__ import annotations

import torch

from .. import LaunchCounter
from . import kernel
from .ref import augru_backward_ref, augru_ref

launches = LaunchCounter()
backward_launches = LaunchCounter()

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
    Returns hidden states (B, T, H).  Differentiable (see the module
    docstring) when grad is enabled and an operand requires it."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x_gates, u, att, h0)):
        return _Augru.apply(x_gates, u, att, h0)
    return _forward(x_gates, u, att, h0)


def _forward(x_gates, u, att, h0):
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
    launches.add()
    return out


def augru_backward(x_gates, u, att, h0, out, dout, *, use_plan=None):
    """(dx_gates, du, datt, dh0) of ``augru(x_gates, u, att, h0)`` for the
    output gradient ``dout``, given its output ``out``: on a CUDA tensor
    the backward kernel on the route ``kernel.backward_plan`` picks (or
    ``use_plan``, to force either route on any shape) and then
    ``du_product``, launched or raised; ``augru_backward_ref`` on the CPU.
    All float32."""
    if out.device.type != "cuda":
        return augru_backward_ref(x_gates, u, att, h0, out, dout)
    B, T, H = out.shape
    dev = out.device
    dout = dout.float().contiguous()
    _check("x_gates", x_gates, (B, T, 3 * H), dev)
    _check("u", u, (H, 3 * H), dev)
    _check("att", att, (B, T), dev)
    _check("h0", h0, (B, H), dev)
    _check("out", out, (B, T, H), dev)
    dxg = torch.empty((B, T, 3 * H), dtype=torch.float32, device=dev)
    dhu_n = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    datt = torch.empty((B, T), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return dxg.zero_(), torch.zeros_like(u), datt, dh0.zero_()
    kernel.launch_backward(x_gates, u, att, h0, out, dout, dx_gates=dxg,
                           dhu_n=dhu_n, datt=datt, dh0=dh0,
                           use_plan=use_plan)
    backward_launches.add()
    return dxg, du_product(h0, out, dxg, dhu_n), datt, dh0


def du_product(h0, out, dx_gates, dhu_n):
    """du = sum_t h_{t-1}^T [dx_r, dx_z, dx_n r] over all (B, T) rows, from
    the backward kernel's ``dx_gates`` and ``dhu_n``: one large product
    (two ``torch.matmul`` calls into the halves of du), as the reference
    leaves it to XLA."""
    B, T, H = out.shape
    h_prev = torch.cat([h0[:, None], out[:, :-1]], dim=1).reshape(B * T, H)
    du = torch.empty((H, 3 * H), dtype=torch.float32, device=out.device)
    torch.matmul(h_prev.T, dx_gates.reshape(B * T, 3 * H)[:, :2 * H],
                 out=du[:, :2 * H])
    torch.matmul(h_prev.T, dhu_n.reshape(B * T, H), out=du[:, 2 * H:])
    return du


class _Augru(torch.autograd.Function):
    """The op under autograd: the forward as ``augru``, the backward
    ``augru_backward`` from the saved operands and states."""

    @staticmethod
    def forward(ctx, x_gates, u, att, h0):
        out = _forward(x_gates, u, att, h0)
        ctx.save_for_backward(x_gates, u, att, h0, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        dxg, du, datt, dh0 = augru_backward(*ctx.saved_tensors, dout)
        return dxg, du, datt, dh0
