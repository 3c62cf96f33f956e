"""ctypes binding of the CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``).

The port of the reference's Pallas ``flash_attention_pallas``.  The TPU
kernel took q, k, v padded to D = 128 lanes and to 128-row blocks; on
Hopper the kernel takes the unpadded (B, H, S, D) operands, float32 or
bfloat16, as strided views whose last axis is contiguous, and writes a
contiguous output (see the source comment for its bound and design).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

#: operand dtypes the kernel takes, by the code its entry point expects
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 4 + [_I] * 8 + [ctypes.c_float,
                                              ctypes.POINTER(ctypes.c_int64),
                                              _P])
        fn.restype = ctypes.c_int
    return lib


def launch(q, k, v, *, out: torch.Tensor, causal: bool,
           scale: float) -> None:
    """Launch on the current stream of ``out``'s device.

    ``q`` (B, Hq, Sq, D), ``k`` and ``v`` (B, Hkv, Skv, D) of one dtype on
    one card, each with unit stride on D; ``out`` contiguous like ``q``.
    Raises if the launch is refused.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    with torch.cuda.device(out.device):
        lib = library()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], int(B), int(Hq), int(Hkv), int(Sq), int(Skv),
            int(D), int(bool(causal)), float(scale), strides, stream)
    if rc != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {rc} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")
