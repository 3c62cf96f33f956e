"""The port's ``augru`` against the reference's AUGRU.

On the CPU the wrapper runs the plain torch version; it must give the
states of the reference's jitted ``augru_ref`` (``lax.scan``) and of
``augru(..., impl="ref")``, the path the reference itself takes off the
TPU, within atol 1e-5 (rtol 0): the products and the transcendental
functions of the two frameworks round differently, and the differences
measured here stay below 1e-6.  The reference's Pallas kernel does not
run under the installed jax (its ``pl.load`` is gone), so it is not the
yardstick here.  The launch plan (``kernel.plan``: which route, rows and
threads a shape takes, and which plans the kernels refuse) is pure Python
and is pinned here.  The CUDA kernels are held to the plain version by the
``gpu`` cases, which need a card and are skipped without one
(``chip_smoke.py`` runs the same checks on the card).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.augru import augru as r_augru
from repro.kernels.augru import augru_ref as r_augru_ref
from repro_torch.kernels.augru import augru, augru_ref, kernel, launches

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


#: an H100's SM count and opt-in shared memory per block
H100 = (132, 232_448)


@pytest.mark.parametrize("B,H,route", [
    (1, 108, "small"), (512, 108, "small"), (65_536, 108, "large"),
    (160, 160, "general"), (2, 3000, "general"), (8, 128, "general"),
    (1, 1, "small"), (1, 37, "small"), (8000, 108, "large"),
    (8000, 37, "large")])
def test_plan_routes(B, H, route):
    """DIEN's retrieval (1 row) and serve_p99 (512) take the small route,
    serve_bulk (65,536) the large one, as do the ``gpu`` cases' T = 1 and
    H = 37 shapes at 8,000 rows; an H whose U does not fit in registers
    the general route (the previous design)."""
    p = kernel.plan(B, H, *H100)
    assert p.route == route
    kernel.check(p, H, H100[1])


@pytest.mark.parametrize("B,rows,blocks", [
    (1, 1, 1), (2, 1, 2), (132, 1, 132), (133, 2, 67), (264, 2, 132),
    (265, 4, 67), (512, 4, 128), (528, 4, 132), (529, 4, 132)])
def test_plan_small_route_rows_per_sm(B, rows, blocks):
    """The least R of 1, 2, 4 that puts at most one tile on each SM: a
    block computes only rows that exist; beyond 4 rows per SM, R = 4 over
    several tiles a block."""
    p = kernel.plan(B, 108, *H100)
    assert (p.route, p.rows, p.blocks) == ("small", rows, blocks)
    assert p.threads == kernel.reg_threads(108, rows)


def test_plan_large_route_edge():
    """The large route starts at ``LARGE_ROWS_PER_SM`` rows per SM; every
    tile plan stays within 8 warps and the shared memory."""
    first = kernel.LARGE_ROWS_PER_SM * H100[0]
    assert kernel.plan(first - 1, 108, *H100).route == "small"
    p = kernel.plan(first, 108, *H100)
    assert p.route == "large" and p.rows % kernel.TILE_ROWS == 0
    assert p.threads <= kernel.TILE_MAX_THREADS
    assert kernel.shared_bytes(p, 108) <= H100[1]
    assert p.blocks == H100[0]


@pytest.mark.parametrize("B,T,H", [(1, 1, 1), (1, 7, 1), (5, 1, 3),
                                   (1, 1, 108)])
def test_plan_accepts_unit_sizes(B, T, H):
    """B, T and H of 1 are planned and accepted (T does not enter the
    plan); the CPU path runs them."""
    p = kernel.plan(B, H, *H100)
    kernel.check(p, H, H100[1])
    got = augru(*(torch.from_numpy(a) for a in _inputs(B, T, H, "random",
                                                       1)))
    assert got.shape == (B, T, H)


def _refused(p, H, max_smem=H100[1]):
    with pytest.raises(ValueError, match="refused"):
        kernel.check(p, H, max_smem)


def test_check_refuses_plans_over_the_limits():
    """Shared memory over the card's limit, rows or threads beyond what
    the registers hold, and U's slice beyond H = 108 on the register routes
    are refused, as the C entries refuse them."""
    small = kernel.plan(512, 108, *H100)
    large = kernel.plan(65_536, 108, *H100)
    general = kernel.plan(8, 128, *H100)
    # shared memory over the limit
    for p, H in ((small, 108), (large, 108), (general, 128)):
        kernel.check(p, H, kernel.shared_bytes(p, H))
        _refused(p, H, max_smem=kernel.shared_bytes(p, H) - 4)
    # the register limit: rows the small route was not compiled for, a
    # large tile beyond 8 warps
    _refused(small._replace(rows=8), 108)
    assert large.groups == 9        # 27 unit groups x 9 = 243 threads
    _refused(large._replace(groups=10, rows=80, threads=288), 108)
    # U's slice does not fit in registers beyond H = 108
    _refused(kernel.small_plan(1, 109, 1, H100[0]), 109)
    _refused(large, 109)
    _refused(small._replace(route="tiny"), 108)


def test_previous_plan_is_the_first_ports_plan():
    """The previous design's plan as its C code made it: 4 k slices for at
    most one 4-row block per SM, 16-row blocks at 65,536 with U (140 KB)
    in shared memory, U in global memory at H = 160, the state in global
    scratch at H = 3000."""
    p = kernel.previous_plan(512, 108, *H100)
    assert (p.groups, p.splits, p.rows, p.blocks, p.u_shared) == (
        1, 4, 4, 128, True)
    p = kernel.previous_plan(65_536, 108, *H100)
    assert (p.groups, p.splits, p.rows, p.blocks, p.u_shared) == (
        4, 1, 16, 4096, True)
    p = kernel.previous_plan(5, 160, *H100)
    assert (p.u_shared, p.state_shared, p.scratch_floats) == (False, True,
                                                              0)
    p = kernel.previous_plan(2, 3000, *H100)
    # h twice and one slice of partial products, 4 rows each
    assert (p.groups, p.splits, p.state_shared) == (1, 1, False)
    assert p.scratch_floats == p.blocks * (2 * 4 * 3000 + 4 * 3 * 3000)


def _cuda_inputs(B, T, H, att, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return [torch.from_numpy(a).cuda() for a in _inputs(B, T, H, att, seed)]


def _holds(B, T, H, att):
    """One launch within ATOL of the plain version on the card, counted."""
    t = _cuda_inputs(B, T, H, att, seed=B + T + H)
    before = launches.count
    got = augru(*t)
    want = augru_ref(*t)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert float((got - want).abs().max()) <= ATOL


#: the small route's edges at DIEN's H (one row; one, two and four rows
#: per SM on 132 SMs), T = 1, an H that is not a multiple of 4 on both
#: register routes, U beyond shared memory (H = 160) and the state in
#: global scratch (H = 3000) on the general route
GPU_SHAPES = SHAPES + [
    (5, 9, 160), (64, 100, 108), (2000, 10, 108), (2, 4, 3000),
    (1, 100, 108), (2, 100, 108), (131, 100, 108), (132, 100, 108),
    (133, 100, 108), (511, 100, 108), (513, 100, 108), (3, 1, 108),
    (8000, 1, 108), (7, 20, 37), (8000, 5, 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("att", ["ones", "random"])
@pytest.mark.parametrize("B,T,H", GPU_SHAPES)
def test_cuda_kernel_matches_plain_version(B, T, H, att):
    _holds(B, T, H, att)


@pytest.mark.gpu
@pytest.mark.parametrize("below", [1, 0])
def test_cuda_large_route_edge(below):
    """The first B the plan sends to the large route on this card, and the
    B just below it (the small route over several tiles a block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    sms, smem = kernel.device_limits(torch.cuda.current_device())
    B = kernel.LARGE_ROWS_PER_SM * sms - below
    assert kernel.plan(B, 108, sms, smem).route == ("small" if below
                                                    else "large")
    _holds(B, 100, 108, "random")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", [(1, 100, 108), (512, 100, 108),
                                   (65_536, 100, 108), (7, 20, 37),
                                   (5, 9, 160)])
def test_cuda_two_launches_bit_equal(B, T, H):
    """A fixed summation order and no atomics: the same inputs give the
    same bits on every route."""
    t = _cuda_inputs(B, T, H, "random", seed=3)
    assert torch.equal(augru(*t), augru(*t))


@pytest.mark.gpu
@pytest.mark.parametrize("B", [1, 512, 65_536])
def test_cuda_previous_design_agrees(B):
    """The previous design (the first port's kernel, ``launch_previous``)
    and the new routes within ATOL on the retrieval and serve shapes."""
    t = _cuda_inputs(B, 100, 108, "random", seed=4)
    got = augru(*t)
    prev = torch.empty_like(got)
    kernel.launch_previous(*t, out=prev)
    torch.cuda.synchronize()
    assert float((got - prev).abs().max()) <= ATOL
