"""Plain torch versions of the ``flash_attention`` kernel: the CPU path of
``flash_attention`` and of the LM's decode attention, and the yardstick the
CUDA kernel is held to on the card.

``attention_ref``  — materialized-scores oracle (kernel tests).
``gqa_attention``  — reshape-based GQA (never materializes repeated KV
                     heads), with an optional blockwise (online-softmax)
                     loop over keys so a long prefill never materializes
                     S x S scores.
``gqa_attention_backward`` — its gradient, formed explicitly from the
                     forward's output (the plain version of the backward
                     kernel).

Scores and the softmax are float32 whatever the operands' dtype: the
reference asks its einsums for float32 results from bf16 operands
(``preferred_element_type``), which here is a float32 product of operands
widened per block; products of two bf16 values are exact in float32, so
only the summation order differs.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D). Returns (B, Hq, Sq, D)."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    kk = torch.repeat_interleave(k, group, dim=1)
    vv = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    if causal:
        offset = Skv - Sq
        rows = torch.arange(Sq, device=q.device)[:, None]
        cols = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(cols <= rows + offset, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)


def _score_block(q5, kb, scale, *, causal, offset, col0, kv_valid_len):
    """q5: (B, Hkv, g, Sq, D); kb: (B, Hkv, Bk, D) -> float32 scores
    (B, Hkv, g, Sq, Bk), masked with -1e30."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", q5.float(), kb.float()) * scale
    Sq, Bk = s.shape[3], s.shape[4]
    cols = col0 + torch.arange(Bk, device=s.device)[None, :]
    mask = torch.ones((Sq, Bk), dtype=torch.bool, device=s.device)
    if causal:
        rows = torch.arange(Sq, device=s.device)[:, None]
        mask &= cols <= rows + offset
    if kv_valid_len is not None:
        mask &= cols < kv_valid_len
    return torch.where(mask, s, NEG_INF)


def gqa_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                  kv_valid_len=None, block_kv: int | None = None):
    """GQA attention.  q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).

    kv_valid_len: keys at positions >= it are masked (a decode cache's
    unwritten tail).  block_kv: if set, evaluate with an online-softmax loop
    over kv blocks (O(Sq * block) score memory).
    """
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    offset = Skv - Sq
    q5 = q.reshape(B, Hkv, group, Sq, D)

    if block_kv is None or block_kv >= Skv:
        s = _score_block(q5, k, scale, causal=causal, offset=offset,
                         col0=0, kv_valid_len=kv_valid_len)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = p / p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
        return o.reshape(B, Hq, Sq, D).to(q.dtype)

    # ---- blockwise online softmax over kv ----
    valid = kv_valid_len if kv_valid_len is not None else Skv
    m = torch.full((B, Hkv, group, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, group, Sq, 1), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((B, Hkv, group, Sq, D), dtype=torch.float32,
                      device=q.device)
    for col0 in range(0, Skv, block_kv):
        # the reference pads the last block with zeros; its padded columns
        # are masked (col >= valid), so they only add exp(-1e30 - m) == 0
        kblk = k[:, :, col0:col0 + block_kv]
        vblk = v[:, :, col0:col0 + block_kv]
        pad = block_kv - kblk.shape[2]
        if pad:
            kblk = torch.nn.functional.pad(kblk, (0, 0, 0, pad))
            vblk = torch.nn.functional.pad(vblk, (0, 0, 0, pad))
        s = _score_block(q5, kblk, scale, causal=causal, offset=offset,
                         col0=col0, kv_valid_len=valid)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                         vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def gqa_attention_backward(q, k, v, o, dout, *, causal: bool = True,
                           scale: float | None = None):
    """The gradients (dq, dk, dv) of ``gqa_attention(q, k, v)`` (unblocked)
    for the output gradient ``dout``, given its output ``o``, formed
    explicitly in float32 and returned in the operands' dtype:

        p = softmax(s),  dv = p^T do,  dp = do v^T,
        ds = p (dp - delta) with delta = rowsum(do * o),
        dq = scale ds k,  dk = scale ds^T q,

    dk and dv summed over the query heads of each kv head."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    q5 = q.float().reshape(B, Hkv, group, Sq, D)
    do5 = dout.float().reshape(B, Hkv, group, Sq, D)
    kf, vf = k.float(), v.float()
    s = _score_block(q5, kf, scale, causal=causal, offset=Skv - Sq, col0=0,
                     kv_valid_len=None)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, do5)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", do5, vf)
    delta = (do5 * o.float().reshape(B, Hkv, group, Sq, D)).sum(
        dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, q5) * scale
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
