"""ctypes binding of the CUDA ``augru`` kernel (``csrc/augru.cu``).

The port of the reference's Pallas ``augru_pallas``.  The TPU kernel padded
each gate section to 128 lanes and the batch to blocks of 8 rows; on Hopper
the kernel takes the unpadded ``(B, T, 3H)`` gates, ``(H, 3H)`` recurrent
weights, ``(B, T)`` attention and ``(B, H)`` initial state as they are, one
persistent block per group of rows with U in shared memory where it fits
(see the source comment for its bound and design).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

NAME = "augru"
SOURCE = Path(__file__).resolve().parent / "csrc" / "augru.cu"

_P = ctypes.c_void_p


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.augru_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [ctypes.c_int] * 3 + [_P]
        fn.restype = ctypes.c_int
        sz = lib.augru_scratch_floats
        sz.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        sz.restype = ctypes.c_int64
    return lib


def launch(x_gates, u, att, h0, *, out: torch.Tensor) -> None:
    """Launch on the current stream of ``out``'s device.

    All operands contiguous float32 on one card: ``x_gates`` (B, T, 3H),
    ``u`` (H, 3H), ``att`` (B, T), ``h0`` (B, H); ``out`` (B, T, H).  When
    the recurrent state of a block does not fit in shared memory (H in the
    thousands) the kernel keeps it in a global scratch buffer allocated
    here.  Raises if the launch is refused.
    """
    B, T, H = out.shape
    with torch.cuda.device(out.device):
        lib = library()
        err = ctypes.c_int(0)
        n = lib.augru_scratch_floats(int(B), int(H), ctypes.byref(err))
        if n < 0:
            raise RuntimeError(f"augru: CUDA error {err.value} while "
                               f"planning the launch")
        scratch = (torch.empty(n, dtype=torch.float32, device=out.device)
                   if n else None)
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.augru_launch(
            x_gates.data_ptr(), u.data_ptr(), att.data_ptr(), h0.data_ptr(),
            out.data_ptr(), scratch.data_ptr() if n else None, int(B),
            int(T), int(H), stream)
    if rc != 0:
        raise RuntimeError(f"augru kernel launch failed: CUDA error {rc} "
                           f"(B={B}, T={T}, H={H})")
