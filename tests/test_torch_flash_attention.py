"""The port's ``flash_attention`` against the reference's.

On the CPU the wrapper runs the plain torch version (``gqa_attention``,
blockwise above 8,192 keys), as the reference's op does off the TPU.  The
port's ``attention_ref`` and ``gqa_attention`` are held to the reference's
on the same numpy inputs, and to the reference's Pallas kernel in
interpret mode (``flash_attention(..., impl="pallas_interpret")``) at the
reference test's small cases.  Tolerances are the reference test's own:
atol 2e-5 for float32, 2e-2 for bfloat16 (the frameworks sum in other
orders; bf16 outputs are one rounding of a float32 result).  The CUDA
kernel is held to the plain version by the ``gpu`` cases, which need a
card and are skipped without one (``chip_smoke.py`` runs the same check on
the card).  The bf16 kernel feeds P to its tensor-core products in bf16,
so each bf16 output is also held to ``ops.bf16_output_bound``; a plain
emulation of that arithmetic shows here, on the CPU, that the rounding of P
alone moves outputs past the earlier one-rounding bound and stays within
the re-derived one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as r_attention_ref
from repro.kernels.flash_attention import flash_attention as r_flash
from repro.kernels.flash_attention.ref import gqa_attention as r_gqa
from repro_torch.kernels.flash_attention import (BLOCKWISE_KV_THRESHOLD,
                                                 attention_ref,
                                                 flash_attention,
                                                 gqa_attention, launches)
from repro_torch.kernels.flash_attention import kernel, ops

#: the reference test's seven cases (tests/test_kernels.py)
CASES = [
    (1, 2, 2, 128, 128, 64, True, "float32"),
    (2, 4, 2, 256, 256, 32, True, "float32"),      # GQA
    (1, 8, 1, 64, 64, 128, False, "float32"),      # MQA / bidirectional
    (1, 2, 2, 100, 100, 16, True, "float32"),      # ragged
    (1, 4, 2, 1, 512, 64, True, "float32"),        # decode
    (1, 2, 1, 130, 390, 32, True, "float32"),      # chunked prefill
    (1, 2, 2, 128, 128, 64, True, "bfloat16"),     # low precision
]
#: starcoder2-3b's 12:1 GQA, causal and not, both dtypes
GQA12 = [(1, 24, 2, 70, 70, 32, True, "float32"),
         (1, 24, 2, 33, 97, 16, False, "bfloat16")]

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _jnp(arrays, dtype):
    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,dtype", CASES + GQA12)
def test_cpu_path_matches_reference(B, Hq, Hkv, Sq, Skv, D, causal, dtype):
    """The wrapper on CPU tensors against the reference's ``attention_ref``
    and its op off the TPU (``impl="ref"``)."""
    args = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq * 7 + Skv + D)
    launches.reset()
    got = flash_attention(*_torch(args, dtype), causal=causal)
    assert launches.count == 0                 # the CPU runs no kernel
    assert got.shape == (B, Hq, Sq, D)
    assert got.dtype == getattr(torch, dtype)
    want = r_attention_ref(*_jnp(args, dtype), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    want_op = r_flash(*_jnp(args, dtype), causal=causal, impl="ref")
    np.testing.assert_allclose(_np(got), _np(want_op), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,dtype", CASES)
def test_plain_versions_match_the_pallas_kernel(B, Hq, Hkv, Sq, Skv, D,
                                                causal, dtype):
    """The port's ``attention_ref`` and ``gqa_attention`` against the
    reference's Pallas kernel, run in interpret mode."""
    args = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq + Skv * 3 + D)
    want = r_flash(*_jnp(args, dtype), causal=causal,
                   impl="pallas_interpret")
    t = _torch(args, dtype)
    np.testing.assert_allclose(_np(attention_ref(*t, causal=causal)),
                               _np(want), rtol=0, atol=TOL[dtype])
    np.testing.assert_allclose(_np(gqa_attention(*t, causal=causal)),
                               _np(want), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_path_matches_reference(causal, dtype):
    """Above ``BLOCKWISE_KV_THRESHOLD`` keys the op goes blockwise (512);
    Skv is not a multiple of the block, so the last block is padded."""
    Skv = BLOCKWISE_KV_THRESHOLD + 300
    args = _inputs(1, 4, 2, 24, Skv, 8, seed=11)
    got = flash_attention(*_torch(args, dtype), causal=causal)
    want = r_flash(*_jnp(args, dtype), causal=causal, impl="ref")
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL[dtype])
    dense = r_attention_ref(*_jnp(args, dtype), causal=causal)
    np.testing.assert_allclose(_np(got), _np(dense), rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("block_kv", [None, 64, 100])
@pytest.mark.parametrize("valid", [1, 37, 200])
def test_kv_valid_len_matches_reference(valid, block_kv):
    """The decode path's mask: keys at positions >= kv_valid_len do not
    count, dense or blockwise (a block of 100 pads the last block)."""
    args = _inputs(2, 6, 2, 1, 200, 32, seed=valid)
    got = gqa_attention(*_torch(args, "float32"), causal=False,
                        kv_valid_len=valid, block_kv=block_kv)
    want = r_gqa(*_jnp(args, "float32"), causal=False, kv_valid_len=valid,
                 block_kv=block_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL["float32"])


def test_plain_attention_picks_the_reference_block(monkeypatch):
    seen = []

    def spy(q, k, v, **kw):
        seen.append(kw["block_kv"])
        return q

    monkeypatch.setattr(ops, "gqa_attention", spy)
    t = _torch(_inputs(1, 2, 1, 4, 16, 8, seed=0), "float32")
    ops.plain_attention(*t)
    long_k = torch.zeros(1, 1, BLOCKWISE_KV_THRESHOLD + 1, 8)
    ops.plain_attention(t[0], long_k, long_k)
    assert seen == [None, 512]


#: the tensor-core kernel's edges in bf16: head dims padded to 64, 128 and
#: 256 and an odd one (element staging), a query run that is not a multiple
#: of the 64-row tile, non-causal 8:1 GQA, decode and chunked prefill
BF16_EDGES = [(1, 2, 2, 100, 100, 16, True, "bfloat16"),
              (2, 4, 2, 256, 256, 32, True, "bfloat16"),
              (1, 4, 1, 65, 65, 80, False, "bfloat16"),
              (1, 4, 2, 300, 300, 256, True, "bfloat16"),
              (1, 4, 2, 130, 130, 33, True, "bfloat16"),
              (1, 8, 1, 1000, 1000, 128, False, "bfloat16"),
              (1, 4, 2, 1, 512, 64, True, "bfloat16"),
              (1, 2, 1, 130, 390, 32, True, "bfloat16")]


def _emulate_tensor_core_kernel(q, k, v, *, causal, p_dtype, block=64):
    """The bf16 kernel's arithmetic in plain torch: float32 scores in the
    exp2 domain, an online softmax over ``block``-key tiles with a float32
    max and denominator, P rounded to ``p_dtype`` before P V, one rounding
    of the output."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, Hkv, g, Sq, D)
    scale = D ** -0.5 * 1.4426950408889634
    m = torch.full((B, Hkv, g, Sq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, g, Sq, D))
    rows = torch.arange(Sq)[:, None] + (Skv - Sq)
    for j0 in range(0, Skv, block):
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf,
                         k[:, :, j0:j0 + block].float()) * scale
        cols = j0 + torch.arange(s.shape[-1])[None, :]
        if causal:
            s = torch.where(cols <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(getattr(torch, p_dtype)).float(),
            v[:, :, j0:j0 + block].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


@pytest.mark.parametrize("p_dtype", ["bfloat16", "float32"])
def test_bf16_p_needs_the_rederived_bound(p_dtype):
    """At (1, 4/2, 2,048, 64), causal: P rounded to bf16 keeps every output
    within ``bf16_output_bound`` and the reference's 2e-2, but breaks the
    one-rounding bound 2^-7 |plain| + 1e-5 that held before; with P kept in
    float32 the one-rounding bound holds.  So the re-derived bound answers
    the arithmetic, not a fault."""
    q, k, v = _torch(_inputs(1, 4, 2, 2048, 2048, 64, seed=0), "bfloat16")
    got = _emulate_tensor_core_kernel(q, k, v, causal=True, p_dtype=p_dtype)
    want = ops.plain_attention(q, k, v, causal=True)
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= TOL["bfloat16"]
    assert float((diff / ops.bf16_output_bound(q, k, v)).max()) <= 1.0
    one_rounding = float((diff / (ops.BF16_OUT_REL * want.float().abs()
                                  + ops.BF16_ABS)).max())
    if p_dtype == "bfloat16":
        assert one_rounding > 1.0
    else:
        assert one_rounding <= 1.0


def test_bf16_output_bound_is_its_formula():
    q, k, v = _torch(_inputs(2, 4, 2, 40, 70, 16, seed=3), "bfloat16")
    plain = attention_ref(q, k, v, causal=True).float()
    weighted = attention_ref(q, k, v.abs(), causal=True).float()
    want = 2.0 ** -8 * weighted + 2.0 ** -7 * plain.abs() + 1e-5
    torch.testing.assert_close(ops.bf16_output_bound(q, k, v), want,
                               rtol=0, atol=1e-6)


def test_rows_aligned_picks_the_staging():
    """cp.async staging only where every row start lies on 16 bytes: the
    model's layouts (v a transposed view) yes; an odd D, an odd position
    stride or a base pointer off 16 bytes take the element staging."""
    def bf16(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    q, k = bf16(1, 24, 64, 128), bf16(1, 2, 64, 128)
    v = bf16(1, 64, 2, 128).transpose(1, 2)
    assert kernel.rows_aligned(q, k, v)
    odd = bf16(1, 2, 8, 33)
    assert not kernel.rows_aligned(odd, odd, odd)
    wide = bf16(1, 2, 8, 41)[..., :40]             # position stride 41
    assert not kernel.rows_aligned(wide, wide, wide)
    shifted = bf16(1, 2, 8, 65)[..., 1:]           # base 2 bytes off
    assert not kernel.rows_aligned(q, shifted, shifted)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,dtype",
                         CASES + GQA12 + BF16_EDGES + [
                             (1, 24, 2, 1, 9000, 128, True, "bfloat16"),
                             (1, 24, 2, 1000, 5000, 128, True, "bfloat16"),
                             (1, 4, 2, 300, 300, 256, True, "float32"),
                             (1, 4, 1, 65, 65, 80, False, "float32")])
def test_cuda_kernel_matches_plain_version(B, Hq, Hkv, Sq, Skv, D, causal,
                                           dtype):
    """Within the reference's tolerance; bf16 also each element within
    ``bf16_output_bound``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    t = [x.cuda() for x in _torch(_inputs(B, Hq, Hkv, Sq, Skv, D, seed=D),
                                  dtype)]
    before = launches.count
    got = flash_attention(*t, causal=causal)
    want = ops.plain_attention(*t, causal=causal)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= TOL[dtype]
    if dtype == "bfloat16":
        bound = ops.bf16_output_bound(*t, causal=causal)
        assert float((diff / bound).max()) <= 1.0


@pytest.mark.gpu
def test_cuda_kernel_in_the_model_layout():
    """starcoder2-3b's prefill heads (24 over 2, D 128) at 4,096 tokens in
    bf16, v the transposed view of a (B, S, Hkv, D) projection."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = _torch(_inputs(1, 24, 2, 4096, 4096, 128, seed=5), "bfloat16")
    v = v.transpose(1, 2).contiguous().transpose(1, 2)
    q, k, v = q.cuda(), k.cuda(), v.cuda()
    assert v.stride(2) == 2 * 128
    got = flash_attention(q, k, v)
    want = ops.plain_attention(q, k, v)
    diff = (got.float() - want.float()).abs()
    assert float(diff.max()) <= TOL["bfloat16"]
    assert float((diff / ops.bf16_output_bound(q, k, v)).max()) <= 1.0


@pytest.mark.gpu
def test_cuda_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q = torch.zeros(1, 2, 4, 300, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 4, 8, device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, q, q)
