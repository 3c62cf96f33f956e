"""Public wrapper of the ``flash_attention`` kernel: dispatch on the device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain torch version in ``ref.py``, as the
reference's ``ops.py`` sends every non-TPU call to ``gqa_attention``
(blockwise above ``BLOCKWISE_KV_THRESHOLD`` key positions).  Nothing falls
back from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from .. import LaunchCounter
from . import kernel
from .ref import gqa_attention

launches = LaunchCounter()

# above this many kv positions the plain path switches to the blockwise
# online-softmax loop so S x S scores are never materialized
BLOCKWISE_KV_THRESHOLD = 8192

#: the largest head dimension the kernel takes
MAX_HEAD_DIM = 256

_MAX_GRID_YZ = 65_535
_INT_MAX = 2**31 - 1


def plain_attention(q, k, v, *, causal: bool = True):
    """What the wrapper runs on the CPU: ``gqa_attention`` at scale
    1/sqrt(D), blockwise (512 keys) above ``BLOCKWISE_KV_THRESHOLD``."""
    Skv = k.shape[2]
    block_kv = 512 if Skv > BLOCKWISE_KV_THRESHOLD else None
    return gqa_attention(q, k, v, causal=causal,
                         scale=1.0 / (q.shape[-1] ** 0.5), block_kv=block_kv)


#: the bf16 elementwise bound's terms: one bf16 rounding of each p_j
#: (weighted by |v_j|), one rounding of the output, float32 slack
BF16_P_REL, BF16_OUT_REL, BF16_ABS = 2.0 ** -8, 2.0 ** -7, 1e-5


def bf16_output_bound(q, k, v, *, causal: bool = True):
    """How far the bf16 kernel's output may lie from ``plain_attention``'s,
    element by element, in float32:

        2^-8 * plain_attention(q, k, |v|) + 2^-7 * |plain_attention(q, k, v)|
        + 1e-5

    Derivation.  Both sides form the same float32 scores and softmax weights
    p_j = exp(s_j - m) up to float32 rounding, and the same denominator l =
    sum_j p_j (the kernel sums its float32 p).  The plain version then
    computes sum_j p_j v_j / l in float32; the tensor-core kernel feeds P to
    a bf16 product, so it sums bf16(p_j) v_j, where |bf16(p_j) - p_j| <=
    2^-9 p_j (round to nearest, 8 significant bits).  The numerators thus
    differ by at most 2^-9 sum_j p_j |v_j|, the outputs by 2^-9 sum_j p_j
    |v_j| / l, which is 2^-9 plain_attention(q, k, |v|); the bound takes
    2^-8, twice that.  Each side then rounds its float32 result to bf16
    once, so the two roundings differ by at most one unit in the last of
    bf16's 8 bits, 2^-7 of the value.  1e-5 covers the float32 arithmetic
    of the two summation orders (float32 outputs agree below 1e-6).  The
    earlier check, 2^-7 |plain| + 1e-5, assumed both sides round one float32
    result once; P in bf16 breaks that assumption (a CPU emulation of the
    kernel's arithmetic exceeds it, and stays within this bound, in
    ``tests/test_torch_flash_attention.py``)."""
    want = plain_attention(q, k, v, causal=causal).float()
    weighted = plain_attention(q, k, v.abs(), causal=causal).float()
    return BF16_P_REL * weighted + BF16_OUT_REL * want.abs() + BF16_ABS


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be a 4-d "
                             f"tensor (B, H, S, D)")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}, "
                            f"q {q.dtype}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last axis is not "
                             f"contiguous")
    if q.dtype not in kernel.DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} (the kernel "
                        f"takes {sorted(map(str, kernel.DTYPES))})")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if (Bk != B or Dk != D or tuple(v.shape) != tuple(k.shape)
            or Hkv < 1 or Hq % Hkv):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"form a GQA call")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} outside [1, "
                         f"{MAX_HEAD_DIM}]")
    if Sq < 1 or Skv < 1:
        raise ValueError(f"flash_attention: empty sequence (Sq={Sq}, "
                         f"Skv={Skv})")
    if max(B, Hq) > _MAX_GRID_YZ or max(Sq, Skv) > _INT_MAX:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} beyond "
                         f"the kernel's grid")


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D) in q's
    dtype, at scale 1/sqrt(D); causal in global coordinates (key j visible
    to query i iff j <= i + Skv - Sq)."""
    if q.device.type != "cuda":
        return plain_attention(q, k, v, causal=causal)
    _check(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel.launch(q, k, v, out=out, causal=causal,
                  scale=1.0 / (q.shape[-1] ** 0.5))
    launches.add()
    return out
