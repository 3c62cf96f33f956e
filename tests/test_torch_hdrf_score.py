"""The port's ``hdrf_choose`` against the reference's two paths.

On the CPU the wrapper runs the plain torch version; it must choose what
the reference's Pallas kernel (interpret mode) and its jitted jnp oracle
choose, with ``best`` bit-equal to the jitted oracle, flat and host-aware,
for HDRF and for Greedy (``degree_weighted=False``, which the reference
scores only with the jnp ``hdrf_score``).  The CUDA kernel is held to the
plain version by the ``gpu`` cases, which need a card and are skipped
without one (``chip_smoke.py`` runs the same check on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.scoring import hdrf_score as r_hdrf_score
from repro.core.scoring import host_any as r_host_any
from repro.kernels.hdrf_score import hdrf_choose as r_choose
from repro.kernels.hdrf_score import hdrf_choose_ref as r_ref
from repro_torch.core.scoring import host_any
from repro_torch.kernels.hdrf_score import (hdrf_choose, hdrf_choose_ref,
                                            launches)

LAM = 1.1
_r_ref_jit = jax.jit(r_ref, static_argnames=("lam", "dcn_penalty"))


@jax.jit
def _r_greedy(du, dv, ru, rv, sizes):
    s = r_hdrf_score(du, dv, ru != 0, rv != 0, sizes, lam=LAM,
                     degree_weighted=False)
    return jnp.argmax(s, axis=1).astype(jnp.int32), jnp.max(s, axis=1)


def _inputs(E, k, seed, n_valid=None, equal_sizes=False):
    rng = np.random.default_rng(seed)
    n_valid = E if n_valid is None else n_valid
    du = rng.integers(1, 100, E).astype(np.int32)
    dv = rng.integers(1, 100, E).astype(np.int32)
    ru = rng.integers(0, 2, (E, k)).astype(np.int8)
    rv = rng.integers(0, 2, (E, k)).astype(np.int8)
    sizes = (np.full(k, 250, np.int32) if equal_sizes
             else rng.integers(0, 500, k).astype(np.int32))
    for a in (du, dv, ru, rv):     # the engine's zero-padded tail
        a[n_valid:] = 0
    return du, dv, ru, rv, sizes


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def _check(du, dv, ru, rv, sizes, hosts=0, pen=0.0):
    """Port (CPU) vs the Pallas kernel in interpret mode and the jitted
    oracle: ``chosen`` equal, ``best`` bit-equal to the oracle."""
    t = [torch.from_numpy(a) for a in (du, dv, ru, rv, sizes)]
    r = [jnp.asarray(du, jnp.float32), jnp.asarray(dv, jnp.float32),
         jnp.asarray(ru), jnp.asarray(rv), jnp.asarray(sizes)]
    th, rh = [], []
    if pen:
        th = [host_any(t[2] != 0, hosts), host_any(t[3] != 0, hosts)]
        rh = [r_host_any(r[2] != 0, hosts), r_host_any(r[3] != 0, hosts)]
        for a, b in zip(th, rh):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    c, b = hdrf_choose(*t, *th, lam=LAM, dcn_penalty=pen)
    c_p, b_p = r_choose(*r, *rh, lam=LAM, dcn_penalty=pen, interpret=True)
    c_j, b_j = _r_ref_jit(*r, *rh, lam=LAM, dcn_penalty=pen)
    c, b = c.numpy(), b.numpy()
    assert c.dtype == np.int32 and b.dtype == np.float32
    assert np.all(np.isfinite(b))
    np.testing.assert_array_equal(c, np.asarray(c_p))
    np.testing.assert_array_equal(c, np.asarray(c_j))
    np.testing.assert_array_equal(b.view(np.int32), _bits(b_j))
    np.testing.assert_array_equal(b.view(np.int32), _bits(b_p))
    return c, b


@pytest.mark.parametrize("E,k", [(1, 2), (16, 4), (64, 32), (256, 200),
                                 (100, 256), (37, 7)])
def test_matches_reference(E, k):
    _check(*_inputs(E, k, seed=E * 1000 + k))


@pytest.mark.parametrize("n_valid", [0, 3, 64])
def test_padded_micro_batch(n_valid):
    """The engine's 64-edge micro-batch with a zero-padded tail (all
    padding when n_valid=0): every row finite and equal to the reference."""
    _check(*_inputs(64, 8, seed=n_valid, n_valid=n_valid))


@pytest.mark.parametrize("E,k,hosts,pen", [(16, 4, 2, 1.0), (64, 32, 4, 0.7),
                                           (100, 256, 2, 2.0),
                                           (50, 12, 3, 1.0)])
def test_host_variant_matches_reference(E, k, hosts, pen):
    du, dv, ru, rv, sizes = _inputs(E, k, seed=E + k)
    _check(du, dv, ru, rv, sizes, hosts, pen)
    # penalty 0: the host flags are ignored, the flat expression runs
    t = [torch.from_numpy(a) for a in (du, dv, ru, rv, sizes)]
    h = [host_any(t[2] != 0, hosts), host_any(t[3] != 0, hosts)]
    c0, b0 = hdrf_choose(*t, *h, lam=LAM, dcn_penalty=0.0)
    cf, bf = hdrf_choose(*t, lam=LAM)
    assert torch.equal(c0, cf) and torch.equal(b0, bf)


@pytest.mark.parametrize("E,k,hosts,pen", [(64, 8, 0, 0.0), (256, 200, 0, 0.0),
                                           (64, 32, 4, 0.7)])
def test_greedy_matches_jnp_hdrf_score(E, k, hosts, pen):
    """PowerGraph Greedy: the reference has no kernel for it and scores it
    with the jnp ``hdrf_score``; the port runs the same wrapper with
    ``degree_weighted=False``."""
    du, dv, ru, rv, sizes = _inputs(E, k, seed=E - k)
    t = [torch.from_numpy(a) for a in (du, dv, ru, rv, sizes)]
    th = []
    if pen:
        th = [host_any(t[2] != 0, hosts), host_any(t[3] != 0, hosts)]

        @jax.jit
        def ref(du, dv, ru, rv, sizes):
            s = r_hdrf_score(du, dv, ru != 0, rv != 0, sizes, lam=LAM,
                             degree_weighted=False,
                             hrep_u=r_host_any(ru != 0, hosts),
                             hrep_v=r_host_any(rv != 0, hosts),
                             dcn_penalty=pen)
            return jnp.argmax(s, axis=1).astype(jnp.int32), jnp.max(s, 1)
    else:
        ref = _r_greedy
    c, b = hdrf_choose(*t, *th, lam=LAM, dcn_penalty=pen,
                       degree_weighted=False)
    c_r, b_r = ref(*(jnp.asarray(a) for a in (du, dv, ru, rv, sizes)))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_r))
    np.testing.assert_array_equal(b.numpy().view(np.int32), _bits(b_r))


@pytest.mark.parametrize("k", [2, 7, 32, 200])
def test_exact_ties_go_to_partition_zero(k):
    """Rows with no replica anywhere, under equal partition sizes, score
    every partition the same: the first index wins, as ``jnp.argmax``
    picks it.  Rows with replicas tie among their replica partitions and
    must pick the lowest of those."""
    du, dv, ru, rv, sizes = _inputs(128, k, seed=k, equal_sizes=True)
    ru[:40], rv[:40] = 0, 0
    c, _ = _check(du, dv, ru, rv, sizes)
    assert (c[:40] == 0).all()
    c_g, _ = hdrf_choose(*(torch.from_numpy(a)
                           for a in (du, dv, ru, rv, sizes)),
                         lam=LAM, degree_weighted=False)
    both = (ru != 0) & (rv != 0)
    first_both = np.where(both.any(1), both.argmax(1), -1)
    live = first_both >= 0
    np.testing.assert_array_equal(c_g.numpy()[live], first_both[live])


def test_cpu_path_counts_no_launch():
    launches.reset()
    _check(*_inputs(64, 8, seed=3))
    assert launches.count == 0


@pytest.mark.gpu
@pytest.mark.parametrize("E,k,dw,pen", [(1, 2, True, 0.0),
                                        (64, 32, True, 0.0),
                                        (64, 32, False, 0.7),
                                        (65536, 32, True, 0.0),
                                        (65537, 200, True, 0.7),
                                        (1000, 5000, False, 0.0)])
def test_cuda_kernel_matches_plain_version(E, k, dw, pen):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    hosts = 4 if pen else 0
    t = [torch.from_numpy(a).cuda() for a in _inputs(E, k, seed=E + k)]
    h = ([host_any(t[2] != 0, hosts), host_any(t[3] != 0, hosts)]
         if pen else [])
    kw = dict(lam=LAM, dcn_penalty=pen, degree_weighted=dw)
    before = launches.count
    c, b = hdrf_choose(*t, *h, **kw)
    c_p, b_p = hdrf_choose_ref(*t, *h, **kw)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert torch.equal(c, c_p)
    assert torch.equal(b.view(torch.int32), b_p.view(torch.int32))
