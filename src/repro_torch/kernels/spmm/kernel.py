"""ctypes binding of the CUDA ``spmm`` kernel (``csrc/spmm.cu``).

The port of the reference's Pallas ``segment_sum_pallas``.  The TPU kernel
took messages gathered and padded into 128-edge tiles, one 128-row output
block per tile; on Hopper the kernel takes the unpadded rows (``x`` or the
messages) and the CSR offsets ``row_ptr`` of a ``TilePrep``, gathers the
rows itself, and writes every output row once.  Two routes (see the source
comment for their bound and design): ``launch_bound`` takes the gathered
row ids and weights already in destination order (``TilePrep.with_edges``)
and reads rows as 16- or 8-byte vectors, as ``plan`` chooses; ``launch``
(the previous route) gathers them through ``perm`` in the kernel.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from .. import cuda_build

NAME = "spmm"
SOURCE = Path(__file__).resolve().parent / "csrc" / "spmm.cu"

#: row and output dtypes the kernel takes
DTYPES = (torch.float32, torch.bfloat16)
#: index dtypes the kernel takes (perm and src)
INDEX_DTYPES = (torch.int32, torch.int64)
#: row loads of the bound route wider than one element, widest first
VEC_BYTES = (16, 8)
#: vectors a lane sums per column pass, as compiled
CHUNKS = (1, 2, 4)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


@dataclass(frozen=True)
class Plan:
    """The bound route's launch for rows of ``D`` elements: loads of
    ``vec_bytes`` (16, 8 or one element), ``lanes`` lanes per edge (so
    32 // lanes edges a step), ``chunks`` vectors a lane per column pass."""
    vec_bytes: int
    lanes: int
    chunks: int


def plan(D: int, itemsize: int, address: int) -> Plan:
    """The bound route's plan for rows of ``D`` elements of ``itemsize``
    bytes starting at ``address``: the widest of ``VEC_BYTES`` that divides
    both the row's bytes and the address, else one element; the least
    power of two of lanes that covers a row's vectors (at most 32); the
    least of ``CHUNKS`` that covers them with 32 lanes (column passes
    beyond 128 vectors)."""
    if D < 1 or itemsize not in (2, 4):
        raise ValueError(f"spmm plan: D {D} and itemsize {itemsize}")
    vec = next((b for b in VEC_BYTES
                if (D * itemsize) % b == 0 and address % b == 0), itemsize)
    n = D * itemsize // vec
    return Plan(vec_bytes=vec, lanes=min(32, 1 << (n - 1).bit_length()),
                chunks=next((k for k in CHUNKS if n <= 32 * k), CHUNKS[-1]))


def plan_for(rows: torch.Tensor) -> Plan:
    """The plan ``launch_bound`` takes for ``rows`` (R, D)."""
    return plan(int(rows.shape[1]), rows.element_size(), rows.data_ptr())


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.spmm_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _L, _L, _P, _I, _P, _I, _P, _P, _L, _P, _P,
                       _L, _L, _L, _P, _P, _P, _I, _P]
        fn.restype = ctypes.c_int
        bound = lib.spmm_bound_launch
        bound.argtypes = [_P, _I, _L, _P, _I, _P, _L, _P, _L, _P, _L, _P,
                          _P, _L, _L, _L, _P, _P, _P, _I, _I, _I, _I, _P]
        bound.restype = ctypes.c_int
    return lib


def _hub_args(prep, D: int, dev) -> tuple:
    """The hub arguments of either entry: the hubs' rows and chunk offsets,
    their counts and split, and fresh float32 partial sums and zeroed
    arrival counts (all None without hubs)."""
    n_hubs = int(prep.hub_rows.numel())
    if not n_hubs:
        return None, None, 0, prep.n_chunks, int(prep.split), None, None
    partial = torch.empty((prep.n_chunks, D), dtype=torch.float32,
                          device=dev)
    arrived = torch.zeros(n_hubs, dtype=torch.int32, device=dev)
    return (prep.hub_rows.data_ptr(), prep.hub_chunk_ptr.data_ptr(), n_hubs,
            prep.n_chunks, int(prep.split), partial, arrived)


def _raise(rc: int, rows, prep, out, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"spmm kernel launch failed: CUDA error {rc} "
                           f"({what}; rows {tuple(rows.shape)} {rows.dtype}, "
                           f"E={prep.num_edges}, N={out.shape[0]})")


def launch(rows, src, weights, prep, *, out: torch.Tensor) -> None:
    """The previous route, on the current stream of ``out``'s device.

    ``rows`` (R, D) contiguous float32 or bf16; ``src`` (E,) int32/int64 or
    None (then row ``perm[p]`` is gathered); ``weights`` (E,) float32 or
    None; ``prep`` a ``TilePrep`` on the same card; ``out`` (N, D)
    contiguous float32 or bf16 (bf16 only from bf16 rows).  Allocates the
    hubs' partial sums and arrival counts.  Raises if the launch is
    refused.
    """
    N, D = out.shape
    dev = out.device
    with torch.cuda.device(dev):
        lib = library()
        hub_rows, hub_ptr, n_hubs, n_chunks, split, partial, arrived = \
            _hub_args(prep, D, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.spmm_launch(
            rows.data_ptr(), int(rows.dtype == torch.bfloat16),
            int(rows.shape[0]), int(D), prep.perm.data_ptr(),
            int(prep.perm.dtype == torch.int64),
            src.data_ptr() if src is not None else None,
            int(src is not None and src.dtype == torch.int64),
            weights.data_ptr() if weights is not None else None,
            prep.row_ptr.data_ptr(), int(N), hub_rows, hub_ptr, n_hubs,
            n_chunks, split,
            partial.data_ptr() if partial is not None else None,
            arrived.data_ptr() if arrived is not None else None,
            out.data_ptr(), int(out.dtype == torch.bfloat16), stream)
    _raise(rc, rows, prep, out, "previous route")


def row_blocks(row_ptr: torch.Tensor, edges: int = 256,
               rows: int = 31) -> torch.Tensor:
    """(B + 1,) int64 first rows of the bound route's row blocks (0 first,
    N last), one warp each: consecutive rows whose edges start in the same
    window of ``edges`` edges and in the same run of ``rows`` rows, so at
    most ``rows`` (<= 31) rows and ``edges`` plus the last row's edges."""
    n = row_ptr.numel() - 1
    r = torch.arange(n, device=row_ptr.device)
    key = row_ptr[:-1] // edges + r // rows
    starts = torch.nonzero(key[1:] != key[:-1]).flatten() + 1
    return torch.cat([r.new_zeros(1), starts, r.new_full((1,), n)])


def launch_bound(rows, idx, weights, prep, *, blocks: torch.Tensor,
                 out: torch.Tensor, use_plan: Plan | None = None) -> None:
    """The bound route, on the current stream of ``out``'s device.

    ``rows`` (R, D) contiguous float32 or bf16; ``idx`` (E,) int32/int64
    row ids in destination order, each in [0, R) (not checked); ``weights``
    (E,) float32 in the same order or None; ``blocks`` ``row_blocks`` of
    ``prep.row_ptr``; ``prep``, ``out`` as for ``launch``.  ``use_plan``
    overrides ``plan_for(rows)`` (the tests force plans the entry must
    refuse).  Raises if the launch is refused.
    """
    N, D = out.shape
    p = use_plan or plan_for(rows)
    dev = out.device
    with torch.cuda.device(dev):
        lib = library()
        hub_rows, hub_ptr, n_hubs, n_chunks, split, partial, arrived = \
            _hub_args(prep, D, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.spmm_bound_launch(
            rows.data_ptr(), int(rows.dtype == torch.bfloat16), int(D),
            idx.data_ptr(), int(idx.dtype == torch.int64),
            weights.data_ptr() if weights is not None else None,
            prep.num_edges, prep.row_ptr.data_ptr(), int(N),
            blocks.data_ptr(),
            int(blocks.numel()) - 1, hub_rows, hub_ptr, n_hubs,
            n_chunks, split,
            partial.data_ptr() if partial is not None else None,
            arrived.data_ptr() if arrived is not None else None,
            out.data_ptr(), int(out.dtype == torch.bfloat16), p.vec_bytes,
            p.lanes, p.chunks, stream)
    _raise(rc, rows, prep, out, f"bound route, {p}")
