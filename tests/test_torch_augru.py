"""The port's ``augru`` against the reference's AUGRU.

On the CPU the wrapper runs the plain torch version; it must give the
states of the reference's jitted ``augru_ref`` (``lax.scan``) and of
``augru(..., impl="ref")``, the path the reference itself takes off the
TPU, within atol 1e-5 (rtol 0): the products and the transcendental
functions of the two frameworks round differently, and the differences
measured here stay below 1e-6.  The reference's Pallas kernel does not
run under the installed jax (its ``pl.load`` is gone), so it is not the
yardstick here.  The CUDA kernel is held to the plain version by the
``gpu`` cases, which need a card and are skipped without one
(``chip_smoke.py`` runs the same check on the card).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.augru import augru as r_augru
from repro.kernels.augru import augru_ref as r_augru_ref
from repro_torch.kernels.augru import augru, augru_ref, launches

ATOL = 1e-5
SHAPES = [(4, 7, 16), (33, 50, 108), (8, 100, 128), (1, 1, 1),
          (512, 100, 108)]

_r_ref_jit = jax.jit(r_augru_ref)


def _inputs(B, T, H, att, seed):
    """The reference test's distributions (u at DIEN's init scale
    1/sqrt(H) beyond H = 1000, where 0.2 makes |hU| ~ 10 and summation
    order alone moves states by ~4e-5); ``att`` "ones" is the GRU stage,
    "random" the interest evolution."""
    rng = np.random.default_rng(seed)
    xg = (rng.standard_normal((B, T, 3 * H)) * 0.5).astype(np.float32)
    u_scale = 0.2 if H <= 1000 else 1.0 / np.sqrt(H)
    u = (rng.standard_normal((H, 3 * H)) * u_scale).astype(np.float32)
    a = (np.ones((B, T)) if att == "ones" else rng.random((B, T)))
    h0 = (rng.standard_normal((B, H)) * 0.1).astype(np.float32)
    return xg, u, a.astype(np.float32), h0


@pytest.mark.parametrize("att", ["ones", "random"])
@pytest.mark.parametrize("B,T,H", SHAPES)
def test_cpu_path_matches_reference(B, T, H, att):
    args = _inputs(B, T, H, att, seed=B * 1000 + T + H)
    got = augru(*(torch.from_numpy(a) for a in args))
    assert got.shape == (B, T, H) and got.dtype == torch.float32
    got = got.numpy()
    want = np.asarray(_r_ref_jit(*args))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    want_op = np.asarray(r_augru(*args, impl="ref"))
    np.testing.assert_allclose(got, want_op, rtol=0, atol=ATOL)


def test_cpu_path_counts_no_launch():
    launches.reset()
    augru(*(torch.from_numpy(a) for a in _inputs(4, 7, 16, "random", 0)))
    assert launches.count == 0


def test_att_zero_keeps_the_state():
    """att == 0 gates every update off: each state is h0."""
    xg, u, _, h0 = _inputs(3, 5, 8, "ones", seed=2)
    out = augru_ref(torch.from_numpy(xg), torch.from_numpy(u),
                    torch.zeros(3, 5), torch.from_numpy(h0))
    assert torch.equal(out, torch.from_numpy(h0)[:, None].expand(3, 5, 8))


@pytest.mark.gpu
@pytest.mark.parametrize("att", ["ones", "random"])
@pytest.mark.parametrize("B,T,H", SHAPES + [(5, 9, 160), (64, 100, 108),
                                            (2000, 10, 108), (2, 4, 3000)])
def test_cuda_kernel_matches_plain_version(B, T, H, att):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    t = [torch.from_numpy(a).cuda()
         for a in _inputs(B, T, H, att, seed=B + T + H)]
    before = launches.count
    got = augru(*t)
    want = augru_ref(*t)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert float((got - want).abs().max()) <= ATOL
