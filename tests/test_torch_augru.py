"""The port's ``augru`` against the reference's AUGRU.

On the CPU the wrapper runs the plain torch version; it must give the
states of the reference's jitted ``augru_ref`` (``lax.scan``) and of
``augru(..., impl="ref")``, the path the reference itself takes off the
TPU, within atol 1e-5 (rtol 0): the products and the transcendental
functions of the two frameworks round differently, and the differences
measured here stay below 1e-6.  The reference's Pallas kernel does not
run under the installed jax (its ``pl.load`` is gone), so it is not the
yardstick here.  The launch plans (``kernel.plan`` and, for the backward,
``kernel.backward_plan``: which route, rows and threads a shape takes, and
which plans the kernels refuse) are pure Python and are pinned here.
The CUDA kernels are held to the plain version by the ``gpu`` cases,
which need a card and are skipped without one
(``chip_smoke.py`` runs the same checks on the card).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.augru import augru as r_augru
from repro.kernels.augru import augru_ref as r_augru_ref
from repro_torch.kernels.augru import (augru, augru_backward, augru_ref,
                                       kernel, launches)

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


# ---------------------------------------------------------------------------
# the backward's launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,route", [
    (65_536, 108, "tile"), (512, 108, "rows"), (65_536, 160, "rows"),
    (65_536, 1000, "rows"), (512, 160, "rows"), (2, 3, "rows"),
    (65_536, 128, "tile"), (65_536, 129, "rows"), (65_536, 37, "tile"),
    (65_536, 1, "tile")])
def test_backward_plan_routes(B, H, route):
    """DIEN's train rows (65,536) take the tile route, its serve rows (512)
    and an H whose U and one 8-row group do not fit in shared memory (above
    128 on the H100) the rows route, the previous design."""
    p = kernel.backward_plan(B, H, *H100)
    assert p.route == route
    kernel.backward_check(p, H, H100[1])


def test_backward_plan_tile_route_edge():
    """The tile route starts at ``BACKWARD_TILE_ROWS_PER_SM`` rows per SM
    (one round of tiles: a block for each, at most one per SM)."""
    first = kernel.BACKWARD_TILE_ROWS_PER_SM * H100[0]
    assert kernel.backward_plan(first - 1, 108, *H100).route == "rows"
    p = kernel.backward_plan(first, 108, *H100)
    assert p.route == "tile"
    assert p.blocks == -(-first // p.rows) <= H100[0]


def test_backward_tile_plan_at_the_train_rows():
    """At (65,536, 108): 4 row groups of 8 (108 threads, 4 warps: one on
    each of an SM's schedulers) beside U (139,968 bytes and pads), 132
    blocks; 227,424 bytes of shared memory, the most groups that fit."""
    p = kernel.backward_plan(65_536, 108, *H100)
    assert (p.groups, p.rows, p.threads, p.blocks) == (4, 32, 128, 132)
    assert kernel.backward_shared_bytes(p, 108) == 227_424 <= H100[1]
    assert kernel.backward_tile_smem(108, 40) > H100[1]


@pytest.mark.parametrize("H", [1, 3, 37, 64, 105, 108, 112, 128, 129, 133,
                               160, 1000])
@pytest.mark.parametrize("B", [1, 7, 512, 4223, 4224, 65_536, 100_003])
def test_backward_plans_fit_the_card(B, H):
    """Every plan either route gives fits the H100's shared memory and
    thread limits; a tile plan has rows a multiple of 8 and at most 256
    threads in whole warps, at least one per (row group, unit group)."""
    tile = kernel.backward_tile_plan(B, H, *H100)
    plans = [kernel.backward_plan(B, H, *H100),
             kernel.backward_rows_plan(B, H, *H100)]
    assert (tile is None) == (H > 128)
    if tile is not None:
        plans.append(tile)
        ug = -(-H // kernel.BACKWARD_TILE_UNITS)
        assert tile.rows % kernel.BACKWARD_TILE_ROWS == 0
        assert ug * tile.groups <= tile.threads <= (
            kernel.BACKWARD_TILE_MAX_THREADS)
        assert tile.threads % 32 == 0
        assert tile.blocks == min(H100[0], -(-B // tile.rows))
    for p in plans:
        assert kernel.backward_shared_bytes(p, H) <= H100[1]
        kernel.backward_check(p, H, H100[1])


def _backward_refused(p, H, max_smem=H100[1]):
    with pytest.raises(ValueError, match="refused"):
        kernel.backward_check(p, H, max_smem)


def test_backward_check_refuses_plans_over_the_limits():
    """Shared memory over the card's limit, threads beyond the register
    limit (tile) or the launch bound (rows), fewer threads than (row group,
    unit group) pairs, part of a warp and an unknown route are refused, as
    the C entries refuse them."""
    tile = kernel.backward_plan(65_536, 108, *H100)
    rows = kernel.backward_plan(512, 108, *H100)
    for p in (tile, rows):
        kernel.backward_check(p, 108, kernel.backward_shared_bytes(p, 108))
        _backward_refused(p, 108,
                          max_smem=kernel.backward_shared_bytes(p, 108) - 4)
    # 5 groups of 8 rows: 135 threads fit the register limit, the shared
    # memory does not
    _backward_refused(tile._replace(groups=5, rows=40, threads=160), 108)
    # at H = 37 (10 unit groups) 26 groups would take 260 threads
    small = kernel.backward_tile_plan(65_536, 37, *H100)
    kernel.backward_check(small, 37, H100[1])
    _backward_refused(small._replace(groups=26, rows=208, threads=288), 37)
    _backward_refused(tile._replace(threads=96), 108)       # < 4 x 27
    _backward_refused(tile._replace(threads=120), 108)      # part of a warp
    _backward_refused(tile._replace(rows=40), 108)          # rows != 8 x 4
    _backward_refused(tile._replace(groups=0, rows=0), 108)
    # U and one 8-row group do not fit beyond H = 128
    _backward_refused(kernel.backward_tile_plan(65_536, 128, *H100), 129)
    _backward_refused(rows._replace(rows=8), 108)           # 1,024 threads
    _backward_refused(rows._replace(threads_per_row=100), 108)
    _backward_refused(tile._replace(route="tiny"), 108)
    _backward_refused(tile._replace(blocks=0), 108)


@pytest.mark.parametrize("B,T,H", [(1, 1, 1), (1, 5, 37), (3, 4, 105),
                                   (1, 2, 108), (2, 3, 1)])
def test_backward_plan_accepts_odd_and_unit_sizes(B, T, H):
    """B, T and H of 1 and H % 4 != 0 are planned on both routes and
    accepted (T does not enter the plan); the CPU path runs them through
    the plain backward."""
    for p in (kernel.backward_plan(B, H, *H100),
              kernel.backward_tile_plan(B, H, *H100),
              kernel.backward_rows_plan(B, H, *H100)):
        kernel.backward_check(p, H, H100[1])
    xg, u, a, h0 = (torch.from_numpy(x)
                    for x in _inputs(B, T, H, "random", 5))
    out = augru_ref(xg, u, a, h0)
    grads = augru_backward(xg, u, a, h0, out, torch.ones_like(out))
    assert [tuple(g.shape) for g in grads] == [
        (B, T, 3 * H), (H, 3 * H), (B, T), (B, H)]
    assert all(bool(torch.isfinite(g).all()) for g in grads)


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
