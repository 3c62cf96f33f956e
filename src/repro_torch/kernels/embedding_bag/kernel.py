"""ctypes binding of the CUDA ``embedding_bag`` kernel
(``csrc/embedding_bag.cu``).

The port of the reference's Pallas ``bag_pool_pallas``.  The TPU kernel
pooled a (B, L, D) block gathered beforehand by XLA, with B padded to 8
rows and D to 128 lanes; on Hopper the kernel reads the table rows itself
from the (B, L) indices, unpadded: a warp per bag, rows read in the
widest load ``plan`` allows (see the source comment for its bound and
design).  ``launch_previous`` runs the previous design (one thread per
(bag, feature)), to time it beside the new one.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from .. import cuda_build

NAME = "embedding_bag"
SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"

#: table dtypes the kernel takes
DTYPES = (torch.float32, torch.bfloat16)
#: index dtypes the kernel takes
INDEX_DTYPES = (torch.int32, torch.int64)
#: row loads, widest first (2 bytes only for a bf16 table)
VEC_BYTES = (16, 8, 4, 2)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


@dataclass(frozen=True)
class Plan:
    """Rows of ``D`` elements read as ``vec_bytes`` loads: ``lanes`` lanes
    a row (at most 32), so ``rows`` = 32 // lanes rows a warp step, and
    ``passes`` column passes for rows of more than 32 vectors."""
    vec_bytes: int
    lanes: int
    rows: int
    passes: int


def plan(D: int, itemsize: int, address: int) -> Plan:
    """The widest of ``VEC_BYTES`` (at least ``itemsize``) that divides the
    row's bytes and the table's ``address``, and the lanes, rows and column
    passes that follow."""
    if D < 1 or itemsize not in (2, 4):
        raise ValueError(f"embedding_bag plan: D {D} and itemsize "
                         f"{itemsize}")
    vec = next(b for b in VEC_BYTES if b >= itemsize
               and (D * itemsize) % b == 0 and address % b == 0)
    n = D * itemsize // vec
    lanes = min(32, n)
    return Plan(vec_bytes=vec, lanes=lanes, rows=32 // lanes,
                passes=-(-n // 32))


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _L, _L, _P, _I, _P, _L, _L, _I, _P, _I, _I,
                       _P]
        fn.restype = _I
        prev = lib.embedding_bag_previous_launch
        prev.argtypes = [_P, _I, _L, _L, _P, _I, _P, _L, _L, _I, _P, _P]
        prev.restype = _I
    return lib


def _args(table, indices, weights, mean, out):
    V, D = table.shape
    B, L = indices.shape
    return (table.data_ptr(), int(table.dtype == torch.bfloat16), int(V),
            int(D), indices.data_ptr(), int(indices.dtype == torch.int64),
            weights.data_ptr() if weights is not None else None, int(B),
            int(L), int(bool(mean)), out.data_ptr())


def _raise(rc: int, table, indices, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error "
                           f"{rc} ({what}; table {tuple(table.shape)} "
                           f"{table.dtype}, indices {tuple(indices.shape)})")


def launch(table, indices, weights, *, mean: bool, out: torch.Tensor,
           use_plan: Plan | None = None) -> None:
    """Launch on the current stream of ``out``'s device.

    ``table`` (V, D) contiguous float32 or bf16; ``indices`` (B, L)
    contiguous int32 or int64; ``weights`` (B, L) contiguous float32 or
    None; ``out`` (B, D) contiguous in the table's dtype.  ``use_plan``
    overrides ``plan`` (the tests force what the entry must refuse).
    Raises if the launch is refused.
    """
    B, L = indices.shape
    D = table.shape[1]
    p = use_plan or plan(int(D), table.element_size(), table.data_ptr())
    with torch.cuda.device(out.device):
        lib = library()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.embedding_bag_launch(
            *_args(table, indices, weights, mean, out), p.vec_bytes, p.lanes,
            stream)
    _raise(rc, table, indices, str(p))


def launch_previous(table, indices, weights, *, mean: bool,
                    out: torch.Tensor) -> None:
    """The previous design on ``launch``'s arguments."""
    with torch.cuda.device(out.device):
        lib = library()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.embedding_bag_previous_launch(
            *_args(table, indices, weights, mean, out), stream)
    _raise(rc, table, indices, "previous design")
