"""The port's ``embedding_bag`` against the reference's.

On the CPU the op runs the plain torch version; it must give the
reference's ``embedding_bag(..., impl="pallas_interpret")`` (its Pallas
kernel in interpret mode) and its ``embedding_bag_ref`` within rtol 1e-5,
atol 1e-6, the reference test's own tolerance.  A bf16 table is compared
in float32 within one bf16 rounding of the output (2^-7 of its magnitude)
plus 1e-6: both round the same float32 sum once.  Inputs are drawn with
numpy from fixed seeds.  The CUDA kernel is held to the plain version by
the ``gpu`` cases, which need a card and skip without one
(``chip_smoke.py`` runs the same checks on the card).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag as r_embedding_bag
from repro.kernels.embedding_bag import embedding_bag_ref as r_ref
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_ref, launches)

RTOL, ATOL = 1e-5, 1e-6
#: the reference test's four cases
CASES = [(100, 16, 4, 10, "sum"), (1000, 18, 33, 100, "mean"),
         (50, 128, 8, 5, "sum"), (10, 260, 1, 3, "mean")]


def _inputs(V, D, B, L, seed):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    w = rng.random((B, L)).astype(np.float32)
    return t, idx, w


@pytest.mark.parametrize("V,D,B,L,mode", CASES)
def test_matches_reference(V, D, B, L, mode):
    t, idx, w = _inputs(V, D, B, L, seed=V + D + B + L)
    want_k = np.asarray(r_embedding_bag(jnp.asarray(t), jnp.asarray(idx),
                                        jnp.asarray(w), mode=mode,
                                        impl="pallas_interpret"))
    want_r = np.asarray(r_ref(jnp.asarray(t), jnp.asarray(idx),
                              jnp.asarray(w), mode=mode))
    got = embedding_bag(torch.from_numpy(t), torch.from_numpy(idx),
                        torch.from_numpy(w), mode=mode)
    assert got.shape == (B, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_k, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_weights_none_are_ones(mode):
    t, idx, _ = _inputs(100, 16, 4, 10, seed=1)
    want = np.asarray(r_ref(jnp.asarray(t), jnp.asarray(idx), None,
                            mode=mode))
    got = embedding_bag(torch.from_numpy(t), torch.from_numpy(idx),
                        mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_mean_with_all_zero_weights_is_zero():
    t, idx, w = _inputs(100, 16, 4, 10, seed=2)
    w[1] = 0.0
    want = np.asarray(r_ref(jnp.asarray(t), jnp.asarray(idx),
                            jnp.asarray(w), mode="mean"))
    got = embedding_bag(torch.from_numpy(t), torch.from_numpy(idx),
                        torch.from_numpy(w), mode="mean")
    assert torch.equal(got[1], torch.zeros(16))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_indices_follow_jax_semantics():
    """[-1, 5, 100] on V = 10 reads rows 9, 5 and 9, as JAX's gather."""
    t, _, _ = _inputs(10, 8, 1, 3, seed=3)
    idx = np.array([[-1, 5, 100], [-100, -11, 0]], np.int32)
    want = np.asarray(r_ref(jnp.asarray(t), jnp.asarray(idx), None))
    np.testing.assert_allclose(want[0], t[9] + t[5] + t[9], rtol=RTOL,
                               atol=ATOL)
    for i in (torch.from_numpy(idx), torch.from_numpy(idx).long()):
        got = embedding_bag(torch.from_numpy(t), i)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bf16_table(mode):
    t, idx, w = _inputs(1000, 18, 33, 100, seed=4)
    tb = jnp.asarray(t, jnp.bfloat16)
    want = np.asarray(r_ref(tb, jnp.asarray(idx), jnp.asarray(w),
                            mode=mode), np.float32)
    got = embedding_bag(torch.from_numpy(np.array(tb.astype(jnp.float32)))
                        .to(torch.bfloat16), torch.from_numpy(idx),
                        torch.from_numpy(w), mode=mode)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["pallas", "pallas_interpret", "jnp"])
def test_unknown_impl_raises(impl):
    t, idx, w = _inputs(100, 16, 4, 10, seed=5)
    with pytest.raises(ValueError, match="impl"):
        embedding_bag(torch.from_numpy(t), torch.from_numpy(idx), impl=impl)


def test_ref_impl_and_cpu_path_count_no_launch():
    t, idx, w = _inputs(100, 16, 4, 10, seed=6)
    args = (torch.from_numpy(t), torch.from_numpy(idx), torch.from_numpy(w))
    launches.reset()
    a = embedding_bag(*args)
    b = embedding_bag(*args, impl="ref")
    assert launches.count == 0
    assert torch.equal(a, b) and torch.equal(a, embedding_bag_ref(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,B,L,dtype,idx,weighted", [
    (100, 16, 4, 10, "float32", "int32", True),
    (1000, 18, 33, 100, "float32", "int64", True),
    (50, 128, 8, 5, "float32", "int32", False),
    (10, 260, 1, 3, "float32", "int32", True),
    (2_097_152, 18, 512, 100, "float32", "int32", True),
    (1000, 18, 33, 100, "bfloat16", "int32", True)])
def test_cuda_kernel_matches_plain_version(V, D, B, L, dtype, idx, weighted,
                                           mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    t, i, w = _inputs(V, D, B, L, seed=V + B)
    i[0, :2] = (-1, V + 5)                   # wrapped and clamped lookups
    t = torch.from_numpy(t).to("cuda", getattr(torch, dtype))
    i = torch.from_numpy(i).to("cuda", getattr(torch, idx))
    w = torch.from_numpy(w).cuda() if weighted else None
    before = launches.count
    got = embedding_bag(t, i, w, mode=mode)
    want = embedding_bag_ref(t, i, w, mode=mode)
    scale = embedding_bag_ref(t.float().abs(), i, w, mode=mode)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    rel = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= 1e-5 * scale + 1e-6 + rel * want.float().abs())
                .all())
