"""ctypes binding of the CUDA ``hdrf_score`` kernel (``csrc/hdrf_score.cu``).

The port of the reference's Pallas ``hdrf_pallas``.  The TPU kernel padded
the partitions to 128 lanes and the edges to 8-row blocks and took (E, k)
flag matrices unpacked beforehand; on Hopper one kernel serves two entries
(see the source comment for its bound and design): ``launch_bits`` reads
the packed bit matrix, the degree table and the endpoints itself,
``launch_flags`` takes the (E,) degrees and (E, k) flags as the reference
does.  Both walk many edges per block with ``plan``'s lanes per edge, each
lane scoring a span of consecutive partitions.
``launch_previous`` runs the previous design (one warp per edge, 8 edges a
block) on the flag entry's arguments, to time it beside the new one.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from .. import cuda_build

NAME = "hdrf_score"
SOURCE = Path(__file__).resolve().parent / "csrc" / "hdrf_score.cu"

#: threads of a block (``kThreads`` in the source)
THREADS = 256
#: blocks per SM the grid is capped at; the blocks walk the edges beyond
BLOCKS_PER_SM = 8
#: from this many edges a lane scores up to 32 partitions; below, the lanes
#: split k as finely as a warp allows
MANY_EDGES = 4096
#: flag-row loads of the flag entry, widest first
VEC_BYTES = (16, 8, 4, 2, 1)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float


@dataclass(frozen=True)
class Plan:
    """A launch: ``lanes`` lanes per edge (1 = a thread per edge, 32 = a
    warp), each scoring ``span`` consecutive partitions, ``blocks`` blocks
    of ``THREADS`` walking the edges, flag rows read ``vec_bytes`` at a
    time (the flag entry)."""
    lanes: int
    span: int
    blocks: int
    vec_bytes: int = 1

    @property
    def route(self) -> str:
        return {1: "thread", 32: "warp"}.get(self.lanes, "group")


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def flag_vec(k: int, address: int) -> int:
    """The widest flag load of ``VEC_BYTES`` that divides ``k`` and
    ``address`` (the OR of the flag matrices' addresses)."""
    return next(b for b in VEC_BYTES if k % b == 0 and address % b == 0)


def plan(E: int, k: int, sm_count: int, vec_bytes: int | None = None,
         lanes: int | None = None) -> Plan:
    """The launch for ``E`` edges over ``k`` partitions on a card of
    ``sm_count`` SMs.  From ``MANY_EDGES`` edges, the least power of two
    of lanes that covers k with 32 partitions each (one thread per edge
    at k <= 32); below, the least power of two of lanes covering k one
    partition each, at most a warp (the shortest chain per lane).
    ``lanes`` forces a count.  A lane's span is ceil(k / lanes), rounded
    up to whole units once it reaches one: a word of 32 partitions (the
    bits entry) or a flag load of ``vec_bytes`` (the flag entry); blocks
    enough for the edges, at most ``BLOCKS_PER_SM`` per SM."""
    if E < 1 or k < 1 or sm_count < 1:
        raise ValueError(f"hdrf_score plan: E, k and sm_count must be >= 1, "
                         f"got {(E, k, sm_count)}")
    unit = 32 if vec_bytes is None else vec_bytes
    if lanes is None:
        lanes = min(32, _pow2_at_least(-(-k // 32) if E >= MANY_EDGES
                                       else k))
    span = -(-k // lanes)
    if span >= unit:
        span = -(-span // unit) * unit
    blocks = min(-(-E // (THREADS // lanes)), BLOCKS_PER_SM * sm_count)
    return Plan(lanes=lanes, span=span, blocks=blocks,
                vec_bytes=vec_bytes or 1)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.hdrf_flags_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [_F, _F, _I, _L, _I, _I, _I, _I, _I, _P,
                                  _P, _P]
        fn.restype = _I
        bits = lib.hdrf_bits_launch
        bits.argtypes = [_P, _L, _I, _P, _P, _I, _P, _F, _F, _I, _I, _L, _I,
                         _I, _I, _I, _P, _P, _P]
        bits.restype = _I
        prev = lib.hdrf_score_previous_launch
        prev.argtypes = [_P] * 7 + [_F, _F, _I, _L, _I, _P, _P, _P]
        prev.restype = _I
    return lib


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"hdrf_score kernel launch failed: CUDA error "
                           f"{rc} ({what})")


def launch_flags(du, dv, rep_u, rep_v, sizes, hrep_u, hrep_v, *, lam: float,
                 dcn_penalty: float, degree_weighted: bool,
                 chosen: torch.Tensor, best: torch.Tensor,
                 use_plan: Plan | None = None) -> None:
    """The flag entry, on the current stream of ``chosen``'s device.

    ``du``/``dv``: int32 (E,); ``rep_*``/``hrep_*``: 1-byte (E, k),
    row-major (the host flags None when ``dcn_penalty`` is 0); ``sizes``:
    int32 (k,).  ``use_plan`` overrides ``plan`` (to time one route against
    another).  Raises if the launch is refused.
    """
    n, k = rep_u.shape
    flags = [rep_u, rep_v] + ([hrep_u, hrep_v] if hrep_u is not None else [])
    address = 0
    for t in flags:
        address |= t.data_ptr()
    p = use_plan or plan(n, k, sm_count(chosen.device.index),
                         flag_vec(k, address))
    with torch.cuda.device(chosen.device):
        lib = library()
        stream = torch.cuda.current_stream(chosen.device).cuda_stream
        rc = lib.hdrf_flags_launch(
            du.data_ptr(), dv.data_ptr(), rep_u.data_ptr(), rep_v.data_ptr(),
            sizes.data_ptr(), _ptr(hrep_u), _ptr(hrep_v), lam, dcn_penalty,
            int(bool(degree_weighted)), n, k, p.lanes.bit_length() - 1,
            p.span, p.vec_bytes.bit_length() - 1, p.blocks,
            chosen.data_ptr(), best.data_ptr(), stream)
    _raise(rc, f"flag entry, E={n}, k={k}, {p}")


def launch_bits(bits, d, uv, sizes, *, k: int, lam: float,
                dcn_penalty: float, group: int, degree_weighted: bool,
                chosen: torch.Tensor, best: torch.Tensor,
                use_plan: Plan | None = None) -> None:
    """The bits entry, on the current stream of ``chosen``'s device.

    ``bits``: int32 (V, ceil(k/32)); ``d``: int32 (V,); ``uv``: int32 or
    int64 (2E,), u's then v's; ``sizes``: int32 (k,); ``group``: partitions
    per host group (read when ``dcn_penalty`` != 0).  Raises if the launch
    is refused.
    """
    n = uv.shape[0] // 2
    p = use_plan or plan(n, k, sm_count(chosen.device.index))
    with torch.cuda.device(chosen.device):
        lib = library()
        stream = torch.cuda.current_stream(chosen.device).cuda_stream
        rc = lib.hdrf_bits_launch(
            bits.data_ptr(), bits.shape[0], bits.shape[1], d.data_ptr(),
            uv.data_ptr(), int(uv.dtype == torch.int64), sizes.data_ptr(),
            lam, dcn_penalty, group, int(bool(degree_weighted)), n, k,
            p.lanes.bit_length() - 1, p.span, p.blocks, chosen.data_ptr(),
            best.data_ptr(), stream)
    _raise(rc, f"bits entry, E={n}, k={k}, {p}")


def launch_previous(du, dv, rep_u, rep_v, sizes, hrep_u, hrep_v, *,
                    lam: float, dcn_penalty: float, degree_weighted: bool,
                    chosen: torch.Tensor, best: torch.Tensor) -> None:
    """The previous design on ``launch_flags``' arguments."""
    n, k = rep_u.shape
    with torch.cuda.device(chosen.device):
        lib = library()
        stream = torch.cuda.current_stream(chosen.device).cuda_stream
        rc = lib.hdrf_score_previous_launch(
            du.data_ptr(), dv.data_ptr(), rep_u.data_ptr(), rep_v.data_ptr(),
            sizes.data_ptr(), _ptr(hrep_u), _ptr(hrep_v), lam, dcn_penalty,
            int(bool(degree_weighted)), n, k, chosen.data_ptr(),
            best.data_ptr(), stream)
    _raise(rc, f"previous design, E={n}, k={k}")
