"""ctypes binding of the CUDA ``augru`` kernels (``csrc/augru.cu``) and
their launch plan.

The port of the reference's Pallas ``augru_pallas``.  The TPU kernel padded
each gate section to 128 lanes and the batch to blocks of 8 rows; on Hopper
the kernels take the unpadded ``(B, T, 3H)`` gates, ``(H, 3H)`` recurrent
weights, ``(B, T)`` attention and ``(B, H)`` initial state as they are.
``plan`` picks the route by shape before the launch (see the source
comment for each route's bound and design):

* ``small`` (H <= 108, B below 56 rows per SM): U in registers, a block
  of R = 1, 2 or 4 rows per SM, only the rows that exist;
* ``large`` (H <= 108, larger B): register-tiled outer products with U and
  h in shared memory, one persistent block per SM over tiles of rows;
* ``general`` (H > 108): the previous design, U in shared memory or L2.

The C entries derive the shared memory and scratch a plan needs and refuse
one that does not fit; nothing falls back when a launch fails.

The backward (``csrc/augru_backward.cu``, a library of its own) has two
routes, planned by ``backward_plan`` before the launch:

* ``tile`` (from ``BACKWARD_TILE_ROWS_PER_SM`` rows per SM, H up to 128
  on the H100): register-tiled outer products over U resident in shared
  memory, dh kept in registers, one persistent block per SM over tiles of
  8 x groups rows;
* ``rows`` (smaller batches and larger H): the previous design, R batch
  rows a block, TP threads a row, U in shared memory where it fits.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from .. import cuda_build

NAME = "augru"
SOURCE = Path(__file__).resolve().parent / "csrc" / "augru.cu"
BACKWARD_NAME = "augru_backward"
BACKWARD_SOURCE = SOURCE.parent / "augru_backward.cu"

#: route codes of the C ``Plan``
ROUTES = {"small": 0, "large": 1, "general": 2}
#: the small route holds U's slice (3 x 108 / S words, S k slices per
#: unit) in registers, for H up to 108; the large route covers the same H
MAX_H = 108
#: rows per block the small route is compiled for (8 spilled)
ROWS = (1, 2, 4)
#: the large route: rows and units a thread computes, threads per block at
#: most (8 warps leave 255 registers a thread)
TILE_ROWS, TILE_UNITS, TILE_MAX_THREADS = 8, 4, 256
#: the large route from B >= LARGE_ROWS_PER_SM * SMs, where the two meet:
#: ``chip_smoke.py``'s ``route_edge`` times both at 8 to 64 rows per SM.
#: On the H100 at (., 100, 108) the large route stays near 2.2 ms from 48
#: rows per SM up and the small one adds ~0.154 ms for every 4 rows per
#: SM (PERF.md section 6)
LARGE_ROWS_PER_SM = 56
#: the previous design: rows per row group, threads per block at most
PREV_ROWS, PREV_MAX_THREADS = 4, 512

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64


class Plan(NamedTuple):
    """One launch: the route, the rows a block serves at once, blocks and
    threads; on the large route the 8-row groups of a tile; on the general
    route its 4-row groups, k slices, whether U and the state sit in
    shared memory, and the floats of global scratch allocated for the
    state when it does not."""
    route: str
    rows: int
    blocks: int
    threads: int
    groups: int = 0
    splits: int = 0
    u_shared: bool = False
    state_shared: bool = False
    scratch_floats: int = 0


class CPlan(ctypes.Structure):
    """The C ``AugruPlan`` the entry points receive."""
    _fields_ = [("route", _I), ("rows", _I), ("groups", _I),
                ("splits", _I), ("u_shared", _I), ("state_shared", _I),
                ("threads", _I), ("blocks", _I64), ("scratch_floats", _I64)]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def reg_threads(H: int, rows: int) -> int:
    """Threads of a small-route block at R = ``rows``: S k slices per unit,
    4 at R = 4 (what 128 registers a thread hold beside 12 accumulators),
    else 2 (255 registers; one row's step is 0.70 us against 0.85 at 4
    slices, PERF.md section 6)."""
    return 32 * _ceil_div((4 if rows == 4 else 2) * H, 32)


def small_plan(B: int, H: int, rows: int, sm_count: int) -> Plan:
    """The small route at ``rows`` per tile, at most one block per SM."""
    return Plan("small", rows, min(sm_count, _ceil_div(B, rows)),
                reg_threads(H, rows))


def tile_smem(H: int, rows: int) -> int:
    """The large route's shared memory: U as (H, unit groups, 12) and h
    twice as (H, rows + 4), float32."""
    ug = _ceil_div(H, TILE_UNITS)
    return 4 * (H * ug * 3 * TILE_UNITS + 2 * H * (rows + 4))


def tile_plan(B: int, H: int, sm_count: int, max_smem: int) -> Plan:
    """The large route's plan: the count of 8-row groups per tile that
    minimises rounds x (groups + 1), a round's time growing with its rows
    plus about one group's worth of latency a step, among those within
    ``TILE_MAX_THREADS`` and ``max_smem``."""
    ug = _ceil_div(H, TILE_UNITS)
    fits = [g for g in range(1, TILE_MAX_THREADS // ug + 1)
            if tile_smem(H, TILE_ROWS * g) <= max_smem]
    groups = min(fits, key=lambda g: (_ceil_div(_ceil_div(
        B, TILE_ROWS * g), sm_count) * (g + 1), -g))
    rows = TILE_ROWS * groups
    return Plan("large", rows, min(sm_count, _ceil_div(B, rows)),
                32 * _ceil_div(ug * groups, 32), groups)


def _state_floats(H: int, groups: int, splits: int) -> int:
    return (2 * groups * PREV_ROWS * _round4(H)
            + groups * splits * PREV_ROWS * 3 * H)


def shared_bytes(p: Plan, H: int) -> int:
    """The dynamic shared memory of a launch, as the C entries derive it."""
    if p.route == "small":
        return 4 * 2 * MAX_H * p.rows          # h twice, (MAX_H, R)
    if p.route == "large":
        return tile_smem(H, TILE_ROWS * p.groups)
    return 4 * ((_state_floats(H, p.groups, p.splits) if p.state_shared
                 else 0) + (_round4(3 * H * H) if p.u_shared else 0))


def previous_plan(B: int, H: int, sm_count: int, max_smem: int) -> Plan:
    """The previous design's plan (the first port's C ``make_plan``): at
    most one 4-row block per SM gets 4 k slices, larger batches 2 or 4 row
    groups; the state and then U go to shared memory as far as they fit."""
    per_wave = PREV_ROWS * sm_count
    groups = 1 if B <= per_wave else 2 if B <= 2 * per_wave else 4
    splits = 4 // groups
    if 4 * _state_floats(H, groups, splits) > max_smem:
        groups = splits = 1
    state = _state_floats(H, groups, splits)
    state_shared = 4 * state <= max_smem
    u_shared = (state_shared
                and 4 * (_round4(3 * H * H) + state) <= max_smem)
    rows = PREV_ROWS * groups
    blocks = _ceil_div(B, rows)
    return Plan("general", rows, blocks,
                min(PREV_MAX_THREADS, 32 * _ceil_div(groups * splits * H, 32)),
                groups, splits, u_shared, state_shared,
                0 if state_shared else blocks * state)


@functools.lru_cache(maxsize=256)
def plan(B: int, H: int, sm_count: int, max_smem: int) -> Plan:
    """The launch of (B, T, H) on a card with ``sm_count`` SMs and
    ``max_smem`` bytes of opt-in shared memory per block (T does not
    matter).  H <= 108: ``large`` from ``LARGE_ROWS_PER_SM`` rows per SM,
    else ``small`` with the least R of ``ROWS`` that puts at most one
    tile of R rows on each SM (R = 4 over several tiles a block beyond 4
    rows per SM); larger H: ``general``."""
    if B < 1 or H < 1 or sm_count < 1:
        raise ValueError(f"augru plan: B, H and sm_count must be >= 1, got "
                         f"{(B, H, sm_count)}")
    if H > MAX_H:
        return previous_plan(B, H, sm_count, max_smem)
    if B >= LARGE_ROWS_PER_SM * sm_count:
        return tile_plan(B, H, sm_count, max_smem)
    rows = next((r for r in ROWS if _ceil_div(B, r) <= sm_count), ROWS[-1])
    return small_plan(B, H, rows, sm_count)


@functools.lru_cache(maxsize=256)
def check(p: Plan, H: int, max_smem: int) -> None:
    """Raise ValueError for a plan over the card's limits, as the C entry
    points refuse it: shared memory over ``max_smem``; on the register
    routes an H whose U does not fit in registers, rows the small route was
    not compiled for, or a large tile beyond ``TILE_MAX_THREADS`` (the
    register limit).  The C entries also refuse threads, blocks or scratch
    that the kernel cannot run with."""
    def refuse(why):
        raise ValueError(f"augru: plan {p} refused for H={H}: {why}")

    if p.route not in ROUTES:
        refuse("unknown route")
    if p.route != "general" and H > MAX_H:
        refuse(f"the small and large routes cover H up to {MAX_H}")
    if p.route == "small" and p.rows not in ROWS:
        refuse(f"rows must be one of {ROWS} (the register limit)")
    if p.route == "large" and not (
            1 <= p.groups
            and _ceil_div(H, TILE_UNITS) * p.groups <= TILE_MAX_THREADS):
        refuse(f"at most {TILE_MAX_THREADS} threads (the register limit)")
    if shared_bytes(p, H) > max_smem:
        refuse(f"{shared_bytes(p, H)} bytes of shared memory, the card has "
               f"{max_smem}")


def c_plan(p: Plan) -> CPlan:
    return CPlan(ROUTES[p.route], p.rows, p.groups, p.splits,
                 int(p.u_shared), int(p.state_shared), p.threads, p.blocks,
                 p.scratch_floats)


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.augru_launch
    if fn.argtypes is None:
        plan_p = ctypes.POINTER(CPlan)
        fn.argtypes = [_P] * 5 + [_I] * 3 + [plan_p, _P]
        fn.restype = _I
        prev = lib.augru_previous_launch
        prev.argtypes = [_P] * 6 + [_I] * 3 + [plan_p, _P]
        prev.restype = _I
        lim = lib.augru_device_limits
        lim.argtypes = [ctypes.POINTER(_I)] * 2
        lim.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> tuple[int, int]:
    """(SM count, opt-in shared memory bytes per block) of CUDA device
    ``index``, the inputs of ``plan``."""
    sms, smem = _I(0), _I(0)
    with torch.cuda.device(index):
        rc = library().augru_device_limits(ctypes.byref(sms),
                                           ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"augru: CUDA error {rc} reading the device's "
                           f"limits")
    return sms.value, smem.value


def plan_for(out: torch.Tensor) -> Plan:
    """The plan ``launch`` takes for ``out`` (B, T, H) on its card."""
    B, _, H = out.shape
    return plan(int(B), int(H), *device_limits(out.device.index))


def _launch(p: Plan, x_gates, u, att, h0, out: torch.Tensor) -> None:
    B, T, H = (int(n) for n in out.shape)
    check(p, H, device_limits(out.device.index)[1])
    with torch.cuda.device(out.device):
        lib = library()
        scratch = (torch.empty(p.scratch_floats, dtype=torch.float32,
                               device=out.device)
                   if p.scratch_floats else None)
        stream = torch.cuda.current_stream(out.device).cuda_stream
        ptrs = (x_gates.data_ptr(), u.data_ptr(), att.data_ptr(),
                h0.data_ptr(), out.data_ptr())
        cp = ctypes.byref(c_plan(p))
        if p.route == "general":
            rc = lib.augru_previous_launch(
                *ptrs, scratch.data_ptr() if scratch is not None else None,
                B, T, H, cp, stream)
        else:
            rc = lib.augru_launch(*ptrs, B, T, H, cp, stream)
    if rc != 0:
        raise RuntimeError(f"augru kernel launch failed: CUDA error {rc} "
                           f"(B={B}, T={T}, H={H}, {p})")


def launch(x_gates, u, att, h0, *, out: torch.Tensor,
           use_plan: Plan | None = None) -> None:
    """Launch on the current stream of ``out``'s device, by ``plan_for``
    (or by ``use_plan``, to time one route against another).

    All operands contiguous float32 on one card: ``x_gates`` (B, T, 3H),
    ``u`` (H, 3H), ``att`` (B, T), ``h0`` (B, H); ``out`` (B, T, H).  On
    the general route, when the recurrent state of a block does not fit in
    shared memory (H in the thousands), the kernel keeps it in a global
    scratch buffer allocated here.  Raises if the launch is refused.
    """
    _launch(use_plan or plan_for(out), x_gates, u, att, h0, out)


def launch_previous(x_gates, u, att, h0, *, out: torch.Tensor) -> None:
    """The previous design (the first port's kernel) on the same arguments as
    ``launch``, at any shape, to time it beside the new routes;
    ``ops.augru`` reaches it only on the general route."""
    B, _, H = out.shape
    _launch(previous_plan(int(B), int(H), *device_limits(out.device.index)),
            x_gates, u, att, h0, out)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

class BackwardPlan(NamedTuple):
    """One backward launch: the route, blocks and threads a block.  On the
    tile route the rows of a tile (8 x ``groups``); on the rows route R
    batch rows a block (each block walks over groups of R rows), TP
    ``threads_per_row`` and whether U sits in shared memory."""
    route: str
    rows: int
    blocks: int
    threads: int
    groups: int = 0
    threads_per_row: int = 0
    u_shared: bool = False


BACKWARD_ROUTES = ("tile", "rows")
#: the tile route: rows and units (phase 2: k) a thread computes, threads
#: a block at most (8 warps leave 255 registers a thread)
BACKWARD_TILE_ROWS, BACKWARD_TILE_UNITS = 8, 4
BACKWARD_TILE_MAX_THREADS = 256
#: the tile route from B >= BACKWARD_TILE_ROWS_PER_SM * SMs, where the two
#: routes meet: ``chip_smoke.py --previous-designs`` times both at 4 to 64
#: rows per SM.  On the H100 at (., 100, 108) the tile route takes 2.60 to
#: 2.64 ms for any batch that fits one round of tiles (up to 32 rows per
#: SM), the rows route ~0.29 ms per row per SM: 2.35 ms at 8, 3.51 at 12
#: (PERF.md section 6)
BACKWARD_TILE_ROWS_PER_SM = 10
#: the rows route: at most this many threads a row (a row's units beyond
#: it loop) and a block (the kernel's launch bound)
BACKWARD_MAX_TP, BACKWARD_MAX_THREADS = 256, 512


def backward_tile_smem(H: int, rows: int) -> int:
    """The tile route's shared memory, as its C entry derives it: U as
    4-k-row groups of (unit groups, 12) floats and h as 4-k-row groups of
    ``rows``, each group padded by 4 floats; dhU as (rows, unit groups,
    12), each 8-row group padded by 4 floats; the step's x_n and dout as
    (rows, 2, unit groups, 4); datt's partials as (rows, unit groups | 1);
    att as (rows,)."""
    ug = _ceil_div(H, BACKWARD_TILE_UNITS)
    row = 3 * BACKWARD_TILE_UNITS * ug
    return 4 * (ug * (4 * row + 4) + ug * (4 * rows + 4)
                + rows // BACKWARD_TILE_ROWS * (BACKWARD_TILE_ROWS * row + 4)
                + rows * 2 * BACKWARD_TILE_UNITS * ug + rows * (ug | 1)
                + rows)


def backward_shared_bytes(p: BackwardPlan, H: int) -> int:
    """The backward's dynamic shared memory, as its C entries derive it:
    on the tile route ``backward_tile_smem``; on the rows route a row's 7H
    floats of state and, when shared, U at row stride 3H | 1."""
    if p.route == "tile":
        return backward_tile_smem(H, p.rows)
    return 4 * (p.rows * 7 * H
                + (H * ((3 * H) | 1) if p.u_shared else 0))


def backward_tile_plan(B: int, H: int, sm_count: int, max_smem: int
                       ) -> BackwardPlan | None:
    """The tile route's plan, or None where not even one 8-row group fits
    beside U (H above 128 on the H100's 232,448 bytes): the count of 8-row
    groups a tile that minimises rounds x the warps on each of an SM's 4
    schedulers (a round's time grows with the warps one scheduler issues
    for: at DIEN's H = 108, 4 groups, the most that fit, make 108 threads,
    one warp on each scheduler), the most groups among equals, within
    ``BACKWARD_TILE_MAX_THREADS`` and ``max_smem``; at most one block per
    SM, each walking over tiles."""
    ug = _ceil_div(H, BACKWARD_TILE_UNITS)
    fits = [g for g in range(1, BACKWARD_TILE_MAX_THREADS // ug + 1)
            if backward_tile_smem(H, BACKWARD_TILE_ROWS * g) <= max_smem]
    if not fits:
        return None

    def cost(g):
        rounds = _ceil_div(_ceil_div(B, BACKWARD_TILE_ROWS * g), sm_count)
        return rounds * _ceil_div(_ceil_div(ug * g, 32), 4), -g

    groups = min(fits, key=cost)
    rows = BACKWARD_TILE_ROWS * groups
    return BackwardPlan("tile", rows, min(sm_count, _ceil_div(B, rows)),
                        32 * _ceil_div(ug * groups, 32), groups)


def backward_rows_plan(B: int, H: int, sm_count: int, max_smem: int
                       ) -> BackwardPlan:
    """The rows route's plan (the previous design's): TP, H rounded up to
    a warp, at most ``BACKWARD_MAX_TP``; R the most of 8, 4, 2, 1 rows
    within ``BACKWARD_MAX_THREADS`` that still gives every SM a group of
    rows (at least 1); U in shared memory when it fits beside R rows'
    state, else R such that the state fits and U is read from L2; a block
    per SM when U is shared (it loads U once and walks over the groups),
    else a block per group."""
    tp = min(32 * _ceil_div(H, 32), BACKWARD_MAX_TP)
    fits = [r for r in (8, 4, 2, 1) if r * tp <= BACKWARD_MAX_THREADS]
    rows = next((r for r in fits if _ceil_div(B, r) >= sm_count), 1)

    def plan_of(r, shared):
        return BackwardPlan("rows", r, 0, r * tp, 0, tp, shared)

    u_shared = backward_shared_bytes(plan_of(rows, True), H) <= max_smem
    if not u_shared:
        rows = next((r for r in fits if r <= rows
                     and backward_shared_bytes(plan_of(r, False), H)
                     <= max_smem), None)
        if rows is None:
            raise ValueError(f"augru backward: H={H} leaves no room for a "
                             f"row's state in {max_smem} bytes")
    groups = _ceil_div(B, rows)
    blocks = min(groups, sm_count) if u_shared else min(groups, 2**31 - 1)
    return plan_of(rows, u_shared)._replace(blocks=blocks)


@functools.lru_cache(maxsize=256)
def backward_plan(B: int, H: int, sm_count: int, max_smem: int
                  ) -> BackwardPlan:
    """The backward launch of (B, T, H) on a card with ``sm_count`` SMs
    and ``max_smem`` bytes of opt-in shared memory per block (T does not
    matter): the tile route from ``BACKWARD_TILE_ROWS_PER_SM`` rows per SM
    where U and one 8-row group fit in shared memory (H up to 128 on the
    H100), else the rows route (``backward_rows_plan``)."""
    if B < 1 or H < 1 or sm_count < 1:
        raise ValueError(f"augru backward plan: B, H and sm_count must be "
                         f">= 1, got {(B, H, sm_count)}")
    if B >= BACKWARD_TILE_ROWS_PER_SM * sm_count:
        p = backward_tile_plan(B, H, sm_count, max_smem)
        if p is not None:
            return p
    return backward_rows_plan(B, H, sm_count, max_smem)


@functools.lru_cache(maxsize=256)
def backward_check(p: BackwardPlan, H: int, max_smem: int) -> None:
    """Raise ValueError for a backward plan over the card's limits, as the
    C entries refuse it: shared memory over ``max_smem``; on the tile
    route fewer threads than (row group, unit group) pairs, part of a warp,
    or more than ``BACKWARD_TILE_MAX_THREADS`` (the register limit); on the
    rows route TP not a whole number of warps, or more than
    ``BACKWARD_MAX_THREADS`` threads."""
    def refuse(why):
        raise ValueError(f"augru backward: plan {p} refused for H={H}: "
                         f"{why}")

    if p.route not in BACKWARD_ROUTES:
        refuse("unknown route")
    if p.blocks < 1:
        refuse("no blocks")
    if p.route == "tile":
        ug = _ceil_div(H, BACKWARD_TILE_UNITS)
        if not (p.groups >= 1 and p.rows == BACKWARD_TILE_ROWS * p.groups
                and ug * p.groups <= p.threads <= BACKWARD_TILE_MAX_THREADS
                and p.threads % 32 == 0):
            refuse(f"a thread for each (row group, unit group) in whole "
                   f"warps, at most {BACKWARD_TILE_MAX_THREADS} (the "
                   f"register limit)")
    elif not (p.rows >= 1 and p.threads_per_row >= 32
              and p.threads_per_row % 32 == 0
              and p.rows * p.threads_per_row <= BACKWARD_MAX_THREADS):
        refuse(f"whole warps a row, at most {BACKWARD_MAX_THREADS} threads")
    if backward_shared_bytes(p, H) > max_smem:
        refuse(f"{backward_shared_bytes(p, H)} bytes of shared memory, the "
               f"card has {max_smem}")


def backward_library() -> ctypes.CDLL:
    """Build (first use) and load the backward's library."""
    lib = cuda_build.load(BACKWARD_NAME, BACKWARD_SOURCE)
    fn = lib.augru_backward_tile_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I] * 6 + [_P]
        fn.restype = _I
        rows = lib.augru_backward_rows_launch
        rows.argtypes = [_P] * 10 + [_I] * 7 + [_P]
        rows.restype = _I
    return lib


def launch_backward(x_gates, u, att, h0, out, dout, *, dx_gates, dhu_n,
                    datt, dh0, use_plan: BackwardPlan | None = None) -> None:
    """The backward kernel on the current stream of ``out``'s device, by
    ``backward_plan`` (or by ``use_plan``, to force either route on any
    shape).  All operands contiguous float32 on one card: ``x_gates``
    (B, T, 3H), ``u`` (H, 3H), ``att`` (B, T), ``h0`` (B, H), ``out`` and
    ``dout`` (B, T, H); writes ``dx_gates`` (B, T, 3H), ``dhu_n`` (B, T,
    H), ``datt`` (B, T) and ``dh0`` (B, H).  Raises if the launch is
    refused."""
    B, T, H = (int(n) for n in out.shape)
    limits = device_limits(out.device.index)
    p = use_plan or backward_plan(B, H, *limits)
    backward_check(p, H, limits[1])
    with torch.cuda.device(out.device):
        lib = backward_library()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        ptrs = (x_gates.data_ptr(), u.data_ptr(), att.data_ptr(),
                h0.data_ptr(), out.data_ptr(), dout.data_ptr(),
                dx_gates.data_ptr(), dhu_n.data_ptr(), datt.data_ptr(),
                dh0.data_ptr())
        if p.route == "tile":
            rc = lib.augru_backward_tile_launch(
                *ptrs, B, T, H, p.groups, p.threads, p.blocks, stream)
        else:
            rc = lib.augru_backward_rows_launch(
                *ptrs, B, T, H, p.rows, p.threads_per_row, p.blocks,
                int(p.u_shared), stream)
    if rc != 0:
        raise RuntimeError(f"augru backward kernel launch failed: CUDA "
                           f"error {rc} (B={B}, T={T}, H={H}, {p})")
