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
the card).
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
from repro_torch.kernels.flash_attention import ops

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


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal,dtype",
                         CASES + GQA12 + [
                             (1, 24, 2, 1, 9000, 128, True, "bfloat16"),
                             (1, 24, 2, 1000, 5000, 128, True, "bfloat16"),
                             (1, 4, 2, 300, 300, 256, True, "float32"),
                             (1, 4, 1, 65, 65, 80, False, "float32")])
def test_cuda_kernel_matches_plain_version(B, Hq, Hkv, Sq, Skv, D, causal,
                                           dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    t = [x.cuda() for x in _torch(_inputs(B, Hq, Hkv, Sq, Skv, D, seed=D),
                                  dtype)]
    before = launches.count
    got = flash_attention(*t, causal=causal)
    want = ops.plain_attention(*t, causal=causal)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert float((got.float() - want.float()).abs().max()) <= TOL[dtype]


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
