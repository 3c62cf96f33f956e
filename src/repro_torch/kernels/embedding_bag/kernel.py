"""ctypes binding of the CUDA ``embedding_bag`` kernel
(``csrc/embedding_bag.cu``).

The port of the reference's Pallas ``bag_pool_pallas``.  The TPU kernel
pooled a (B, L, D) block gathered beforehand by XLA, with B padded to 8
rows and D to 128 lanes; on Hopper the kernel reads the table rows itself
from the (B, L) indices, unpadded (see the source comment for its bound
and design).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

NAME = "embedding_bag"
SOURCE = Path(__file__).resolve().parent / "csrc" / "embedding_bag.cu"

#: table dtypes the kernel takes
DTYPES = (torch.float32, torch.bfloat16)
#: index dtypes the kernel takes
INDEX_DTYPES = (torch.int32, torch.int64)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.embedding_bag_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _L, _L, _P, _I, _P, _L, _L, _I, _P, _P]
        fn.restype = ctypes.c_int
    return lib


def launch(table, indices, weights, *, mean: bool, out: torch.Tensor) -> None:
    """Launch on the current stream of ``out``'s device.

    ``table`` (V, D) contiguous float32 or bf16; ``indices`` (B, L)
    contiguous int32 or int64; ``weights`` (B, L) contiguous float32 or
    None; ``out`` (B, D) contiguous in the table's dtype.  Raises if the
    launch is refused.
    """
    V, D = table.shape
    B, L = indices.shape
    with torch.cuda.device(out.device):
        lib = library()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.embedding_bag_launch(
            table.data_ptr(), int(table.dtype == torch.bfloat16), int(V),
            int(D), indices.data_ptr(), int(indices.dtype == torch.int64),
            weights.data_ptr() if weights is not None else None, int(B),
            int(L), int(bool(mean)), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error "
                           f"{rc} (table {tuple(table.shape)} {table.dtype}, "
                           f"indices {tuple(indices.shape)})")
