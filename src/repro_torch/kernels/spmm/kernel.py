"""ctypes binding of the CUDA ``spmm`` kernel (``csrc/spmm.cu``).

The port of the reference's Pallas ``segment_sum_pallas``.  The TPU kernel
took messages gathered and padded into 128-edge tiles, one 128-row output
block per tile; on Hopper the kernel takes the unpadded rows (``x`` or the
messages), the destination-sorted edge order ``perm`` and the CSR offsets
``row_ptr`` of a ``TilePrep``, gathers ``x[src]`` itself, and writes every
output row once (see the source comment for its bound and design).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

NAME = "spmm"
SOURCE = Path(__file__).resolve().parent / "csrc" / "spmm.cu"

#: row and output dtypes the kernel takes
DTYPES = (torch.float32, torch.bfloat16)
#: index dtypes the kernel takes (perm and src)
INDEX_DTYPES = (torch.int32, torch.int64)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.spmm_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _L, _L, _P, _I, _P, _I, _P, _P, _L, _P, _P,
                       _L, _L, _L, _P, _P, _P, _I, _P]
        fn.restype = ctypes.c_int
    return lib


def launch(rows, src, weights, prep, *, out: torch.Tensor) -> None:
    """Launch on the current stream of ``out``'s device.

    ``rows`` (R, D) contiguous float32 or bf16; ``src`` (E,) int32/int64 or
    None (then row ``perm[p]`` is gathered); ``weights`` (E,) float32 or
    None; ``prep`` a ``TilePrep`` on the same card; ``out`` (N, D)
    contiguous float32 or bf16 (bf16 only from bf16 rows).  Allocates the
    hubs' partial sums and arrival counts.  Raises if the launch is
    refused.
    """
    N, D = out.shape
    n_hubs, n_chunks = int(prep.hub_rows.numel()), prep.n_chunks
    dev = out.device
    with torch.cuda.device(dev):
        lib = library()
        partial = (torch.empty((n_chunks, D), dtype=torch.float32,
                               device=dev) if n_hubs else None)
        arrived = (torch.zeros(n_hubs, dtype=torch.int32, device=dev)
                   if n_hubs else None)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.spmm_launch(
            rows.data_ptr(), int(rows.dtype == torch.bfloat16),
            int(rows.shape[0]), int(D), prep.perm.data_ptr(),
            int(prep.perm.dtype == torch.int64),
            src.data_ptr() if src is not None else None,
            int(src is not None and src.dtype == torch.int64),
            weights.data_ptr() if weights is not None else None,
            prep.row_ptr.data_ptr(), int(N),
            prep.hub_rows.data_ptr() if n_hubs else None,
            prep.hub_chunk_ptr.data_ptr() if n_hubs else None, n_hubs,
            n_chunks, int(prep.split),
            partial.data_ptr() if n_hubs else None,
            arrived.data_ptr() if n_hubs else None, out.data_ptr(),
            int(out.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"spmm kernel launch failed: CUDA error {rc} "
                           f"(rows {tuple(rows.shape)} {rows.dtype}, "
                           f"E={prep.num_edges}, N={N})")
