"""The port's ``hdrf_choose`` and ``hdrf_choose_bits`` against the
reference's two paths.

On the CPU the wrapper runs the plain torch version; it must choose what
the reference's Pallas kernel (interpret mode) and its jitted jnp oracle
choose, with ``best`` bit-equal to the jitted oracle, flat and host-aware,
for HDRF and for Greedy (``degree_weighted=False``, which the reference
scores only with the jnp ``hdrf_score``).  The CUDA kernel is held to the
plain version by the ``gpu`` cases, which need a card and are skipped
without one (``chip_smoke.py`` runs the same check on the card).

``hdrf_choose_bits`` reads the packed bit matrix, the degree table and the
endpoints; on the CPU it must choose what the reference's ``bitops.get_jnp``
gather followed by its ``hdrf_choose`` (interpret mode) and its jitted
oracle choose.  ``kernel.plan`` (pure Python) is pinned here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bitops import get_jnp as r_get
from repro.core.scoring import hdrf_score as r_hdrf_score
from repro.core.scoring import host_any as r_host_any
from repro.kernels.hdrf_score import hdrf_choose as r_choose
from repro.kernels.hdrf_score import hdrf_choose_ref as r_ref
from repro_torch.core.scoring import host_any
from repro_torch.core import bitops
from repro_torch.kernels.hdrf_score import (hdrf_choose, hdrf_choose_bits,
                                            hdrf_choose_bits_ref,
                                            hdrf_choose_ref, kernel, launches)

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
                                        (1000, 5000, False, 0.0),
                                        (64, 12160, True, 0.7),
                                        (64, 12288, False, 0.0),
                                        (64, 13000, True, 0.7)])
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


# ---------------------------------------------------------------------------
# hdrf_choose_bits: the packed bit matrix, the degree table, the endpoints
# ---------------------------------------------------------------------------

def _bits_inputs(V, E, k, seed, n_valid=None, equal_sizes=False):
    """A packed (V, ceil(k/32)) uint32 bit matrix (some vertices without a
    replica), int32 degrees, endpoints ``uv`` = [u..., v...] with the
    engine's zero-padded tail, and sizes."""
    rng = np.random.default_rng(seed)
    n_valid = E if n_valid is None else n_valid
    bm = bitops.alloc_np(V, k)
    v, p = rng.integers(0, V, V * k // 3), rng.integers(0, k, V * k // 3)
    bitops.set_np(bm, v, p)
    bm[::5] = 0                     # rows with no replica anywhere
    d = rng.integers(0, 200, V).astype(np.int32)
    uv = rng.integers(0, V, (2, E))
    uv[:, n_valid:] = 0
    sizes = (np.full(k, 250, np.int32) if equal_sizes
             else rng.integers(0, 500, k).astype(np.int32))
    return bm, d, uv.reshape(-1), sizes


def _r_bits_choose(bm, d, uv, sizes, k, hosts, pen, dw):
    """The reference's composition: ``get_jnp`` gathers, ``host_any``, then
    its Pallas ``hdrf_choose`` in interpret mode and the jitted oracle (or,
    for Greedy, which the reference scores only with the jnp
    ``hdrf_score``, that function jitted)."""
    E = len(uv) // 2
    parts = jnp.arange(k)
    rep = r_get(jnp.asarray(bm), jnp.asarray(uv)[:, None], parts[None, :])
    du, dv = jnp.asarray(d[uv[:E]]), jnp.asarray(d[uv[E:]])
    h = ([r_host_any(rep[:E], hosts), r_host_any(rep[E:], hosts)]
         if pen else [])
    sz = jnp.asarray(sizes)
    if not dw:
        kw = dict(hrep_u=h[0], hrep_v=h[1], dcn_penalty=pen) if pen else {}

        @jax.jit
        def greedy(du, dv, ru, rv, sz):
            s = r_hdrf_score(du, dv, ru, rv, sz, lam=LAM,
                             degree_weighted=False, **kw)
            return jnp.argmax(s, axis=1).astype(jnp.int32), jnp.max(s, 1)
        return [greedy(du, dv, rep[:E], rep[E:], sz)]
    fu, fv = du.astype(jnp.float32), dv.astype(jnp.float32)
    ru, rv = rep[:E].astype(jnp.int8), rep[E:].astype(jnp.int8)
    hi = [x.astype(jnp.int8) for x in h]
    return [r_choose(fu, fv, ru, rv, sz, *hi, lam=LAM, dcn_penalty=pen,
                     interpret=True),
            _r_ref_jit(fu, fv, ru, rv, sz, *hi, lam=LAM, dcn_penalty=pen)]


@pytest.mark.parametrize("dw", [True, False])
@pytest.mark.parametrize("k,hosts", [(2, 0), (7, 0), (33, 0), (48, 0),
                                     (200, 0), (2, 2), (48, 4), (200, 4),
                                     (33, 3)])
def test_bits_entry_matches_reference(k, hosts, dw):
    """``hdrf_choose_bits`` on the CPU against the reference's gather and
    choice: ``chosen`` equal, ``best`` bit-equal; k = 48 with 4 hosts has
    host groups of 12 bits that straddle a word, k = 33 with 3 hosts
    groups of 11 across a word's end."""
    pen = 0.7 if hosts else 0.0
    bm, d, uv, sizes = _bits_inputs(300, 64, k, seed=k * 10 + hosts,
                                    n_valid=50)
    c, b = hdrf_choose_bits(torch.from_numpy(bm.view(np.int32)),
                            torch.from_numpy(d), torch.from_numpy(uv),
                            torch.from_numpy(sizes), k=k, lam=LAM,
                            num_hosts=hosts, dcn_penalty=pen,
                            degree_weighted=dw)
    assert c.dtype == torch.int32 and b.dtype == torch.float32
    for c_r, b_r in _r_bits_choose(bm, d, uv, sizes, k, hosts, pen, dw):
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_r))
        np.testing.assert_array_equal(b.numpy().view(np.int32), _bits(b_r))


@pytest.mark.parametrize("k", [2, 32, 200])
def test_bits_entry_equals_flag_entry(k):
    """The two entries on the same state: the bits entry's plain version
    is the flag entry on ``bitops.get``'s rows and ``d[uv]``, ties to
    partition 0 under equal sizes."""
    bm, d, uv, sizes = _bits_inputs(128, 100, k, seed=k, equal_sizes=True)
    bits, td = torch.from_numpy(bm.view(np.int32)), torch.from_numpy(d)
    tuv, ts = torch.from_numpy(uv).long(), torch.from_numpy(sizes)
    rep = bitops.get(bits, tuv[:, None], torch.arange(k)[None, :])
    c_f, b_f = hdrf_choose(td[tuv[:100]], td[tuv[100:]], rep[:100],
                           rep[100:], ts, lam=LAM)
    c_b, b_b = hdrf_choose_bits(bits, td, tuv, ts, k=k, lam=LAM)
    assert torch.equal(c_f, c_b) and torch.equal(b_f, b_b)
    empty = ~rep[:100].any(1) & ~rep[100:].any(1)
    assert bool(empty.any()) and bool((c_b[empty] == 0).all())


def test_bits_entry_host_settings():
    """Hosts need the penalty and more than one group; a k that the hosts
    do not divide raises; the CPU path counts no launch."""
    bm, d, uv, sizes = _bits_inputs(64, 32, 8, seed=1)
    args = [torch.from_numpy(a) for a in (bm.view(np.int32), d, uv, sizes)]
    launches.reset()
    flat = hdrf_choose_bits(*args, k=8, lam=LAM)
    for hosts, pen in ((4, 0.0), (1, 1.0), (0, 1.0)):
        got = hdrf_choose_bits(*args, k=8, lam=LAM, num_hosts=hosts,
                               dcn_penalty=pen)
        assert all(torch.equal(a, b) for a, b in zip(got, flat))
    with pytest.raises(ValueError, match="multiple"):
        hdrf_choose_bits(*args, k=8, lam=LAM, num_hosts=3, dcn_penalty=1.0)
    assert launches.count == 0 and launches.by_entry == {"bits": 0,
                                                         "flags": 0}


@pytest.mark.parametrize("E,k,vec,lanes,span", [
    (65536, 32, None, 1, 32), (65536, 64, None, 2, 32),
    (65536, 65, None, 4, 17), (65536, 200, None, 8, 25),
    (65536, 32, 16, 1, 32), (65536, 200, 8, 8, 32), (65536, 7, 1, 1, 7),
    (65536, 48, 16, 2, 32), (65536, 64, 4, 2, 32),
    (4096, 2, None, 1, 2), (4095, 32, None, 32, 1), (64, 32, None, 32, 1),
    (64, 32, 16, 32, 1), (64, 7, None, 8, 1), (1, 1, None, 1, 1),
    (1, 2, None, 2, 1), (100, 33, None, 32, 2),
    (10**6, 5000, None, 32, 160)])
def test_plan_routes(E, k, vec, lanes, span):
    """From ``MANY_EDGES`` edges a lane scores up to 32 partitions, below
    them one partition each, at most a warp; spans of whole units (a word,
    or a flag vector) once they reach one; the grid covers the edges, at
    most ``BLOCKS_PER_SM`` blocks per SM."""
    p = kernel.plan(E, k, 132, vec)
    assert (p.lanes, p.span, p.vec_bytes) == (lanes, span, vec or 1)
    assert p.lanes * p.span >= k
    assert p.route == {1: "thread", 32: "warp"}.get(lanes, "group")
    per_block = kernel.THREADS // lanes
    assert p.blocks == min(-(-E // per_block), kernel.BLOCKS_PER_SM * 132)
    forced = kernel.plan(E, k, 132, vec, lanes=4)
    assert forced.lanes == 4 and 4 * forced.span >= k


@pytest.mark.parametrize("k,address,vec", [
    (32, 0, 16), (32, 256, 16), (32, 8, 8), (48, 0, 16), (200, 0, 8),
    (7, 0, 1), (2, 0, 2), (12, 0, 4), (32, 3, 1), (64, 1 | 256, 1)])
def test_plan_flag_loads(k, address, vec):
    """The flag entry reads the widest of 16, 8, 4, 2, 1 bytes that divides
    k and every flag matrix's address (ORed)."""
    assert kernel.flag_vec(k, address) == vec


def test_plan_refuses_empty():
    for args in ((0, 32, 132), (64, 0, 132), (64, 32, 0)):
        with pytest.raises(ValueError):
            kernel.plan(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("E,k,hosts,dw", [
    (1, 1, 0, True), (64, 32, 0, True), (64, 32, 4, False),
    (65536, 32, 0, True), (65536, 32, 4, True), (65536, 48, 4, False),
    (65537, 200, 4, True), (1000, 5000, 0, False), (4096, 33, 3, True),
    (64, 12160, 4, True), (64, 12288, 0, False), (64, 12288, 4, True),
    (64, 13000, 4, True)])
def test_cuda_bits_entry_matches_plain_version(E, k, hosts, dw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    pen = 0.7 if hosts else 0.0
    bm, d, uv, sizes = _bits_inputs(4096, E, k, seed=E + k,
                                    n_valid=E - E // 10)
    t = [torch.from_numpy(a).cuda()
         for a in (bm.view(np.int32), d, uv, sizes)]
    kw = dict(k=k, lam=LAM, num_hosts=hosts, dcn_penalty=pen,
              degree_weighted=dw)
    launches.reset()
    c, b = hdrf_choose_bits(*t, **kw)
    c_p, b_p = hdrf_choose_bits_ref(*t, **kw)
    c32, b32 = hdrf_choose_bits(t[0], t[1], t[2].int(), t[3], **kw)
    torch.cuda.synchronize()
    assert launches.by_entry == {"bits": 2, "flags": 0}
    assert torch.equal(c, c_p) and torch.equal(c32, c_p)
    assert torch.equal(b.view(torch.int32), b_p.view(torch.int32))
    assert torch.equal(b32.view(torch.int32), b_p.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_cuda_every_lane_count(lanes):
    """Each lane count on both entries, k = 48 with 4 hosts, equal to the
    plain version and to the previous design."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    k, E = 48, 3000
    bm, d, uv, sizes = _bits_inputs(2048, E, k, seed=lanes)
    bits, td, tuv, ts = (torch.from_numpy(a).cuda()
                         for a in (bm.view(np.int32), d, uv, sizes))
    p = kernel.plan(E, k, 1, lanes=lanes)
    c_p, b_p = hdrf_choose_bits_ref(bits, td, tuv, ts, k=k, lam=LAM,
                                    num_hosts=4, dcn_penalty=0.7)
    out = [torch.empty(E, dtype=torch.int32, device="cuda"),
           torch.empty(E, device="cuda")]
    kernel.launch_bits(bits, td, tuv, ts, k=k, lam=LAM, dcn_penalty=0.7,
                       group=12, degree_weighted=True, chosen=out[0],
                       best=out[1], use_plan=p)
    rep = bitops.get(bits, tuv[:, None], torch.arange(k, device="cuda"))
    h = host_any(rep, 4)
    du, dv = td[tuv[:E]], td[tuv[E:]]
    flags = [rep[:E], rep[E:], ts, h[:E], h[E:]]
    f_out = [torch.empty_like(x) for x in out]
    prev = [torch.empty_like(x) for x in out]
    kernel.launch_flags(du, dv, *flags, lam=LAM, dcn_penalty=0.7,
                        degree_weighted=True, chosen=f_out[0],
                        best=f_out[1], use_plan=p)
    kernel.launch_previous(du, dv, *flags, lam=LAM, dcn_penalty=0.7,
                           degree_weighted=True, chosen=prev[0],
                           best=prev[1])
    torch.cuda.synchronize()
    for c, b in (out, f_out, prev):
        assert torch.equal(c, c_p)
        assert torch.equal(b.view(torch.int32), b_p.view(torch.int32))
