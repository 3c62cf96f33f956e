"""Shared dense layer, the port's counterpart of ``repro.models.layers``.

Parameters are plain dicts of tensors, as the reference's pytrees.  The
weight keeps the reference's ``(d_in, d_out)`` layout, so ``x @ w + b`` is
the same product (``nn.Linear`` would store the transpose).  The norms,
RoPE and activations follow the reference's arithmetic: both norms and RoPE
compute in float32 and cast back to the input's dtype, ``gelu`` is the tanh
approximation (``jax.nn.gelu``'s default) and RoPE rotates halves.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)   # population variance
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm_init(kind: str, d: int, dtype=torch.float32, device=None) -> dict:
    return (rmsnorm_init(d, dtype, device) if kind == "rmsnorm"
            else layernorm_init(d, dtype, device))


def norm_apply(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D); positions: broadcastable to (..., S).  Rotates the
    halves x1 = x[..., :D/2], x2 = x[..., D/2:] (not interleaved pairs)."""
    D = x.shape[-1]
    inv = rope_frequencies(D, theta, device=x.device)
    ang = positions[..., None].float() * inv                # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def activation(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    if kind == "silu":
        return F.silu(x)
    if kind == "relu":
        return F.relu(x)
    if kind == "relu2":          # squared ReLU (Nemotron/Primer)
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool, bias: bool = False, dtype=torch.float32) -> dict:
    p = {"up": dense_init(generator, d_model, d_ff, bias=bias, dtype=dtype),
         "down": dense_init(generator, d_ff, d_model, bias=bias,
                            dtype=dtype)}
    if gated:
        p["gate"] = dense_init(generator, d_model, d_ff, bias=bias,
                               dtype=dtype)
    return p


def mlp(p: dict, x: torch.Tensor, *, act: str) -> torch.Tensor:
    up = dense(p["up"], x)
    if "gate" in p:
        h = activation(act, dense(p["gate"], x)) * up
    else:
        h = activation(act, up)
    return dense(p["down"], h)


def embedding_init(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> dict:
    return {"table": torch.randn((vocab, d), generator=generator,
                                 dtype=dtype, device=generator.device)
            * 0.02}


def cross_entropy_loss(logits, labels, *, z_loss: float = 0.0):
    """logits: (..., V) any float dtype; labels: (...,) integer.  The
    reference's arithmetic: the row max (no gradient) subtracted in the
    logits' dtype, exp and the sums in float32, the label's logit picked
    in float32 (a gather at the label clamped into [0, V), zeroed where the
    label lies outside: the reference's one-hot masked sum, which finds no
    match there); mean of lse - label logit, plus ``z_loss`` * mean lse^2.
    The only (tokens x vocab) float32 tensor kept is what autograd saves of
    the exp."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    sumexp = torch.sum(torch.exp(shifted.float()), dim=-1)
    lse = torch.log(sumexp) + m[..., 0].float()
    V = logits.shape[-1]
    labels = labels.long()
    picked = torch.gather(logits, -1, labels.clamp(0, V - 1)[..., None])
    ll = torch.where((labels >= 0) & (labels < V), picked[..., 0].float(),
                     0.0)
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * torch.square(lse).mean()
    return loss


def abstract_tree(fn, *args):
    """The tree ``fn(*args)`` returns, built without allocating: run under
    ``FakeTensorMode``, each tensor leaf returned as a meta tensor of its
    shape and dtype (the counterpart of ``jax.eval_shape``).  ``fn`` draws
    from a CPU ``torch.Generator`` as the real init does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def meta(t):
        if isinstance(t, dict):
            return {k: meta(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(meta(v) for v in t)
        if isinstance(t, torch.Tensor):
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return t

    with FakeTensorMode():
        return meta(fn(*args))
