"""ctypes binding of the CUDA ``flash_attention`` kernels
(``csrc/flash_attention.cu``).

The port of the reference's Pallas ``flash_attention_pallas``.  The TPU
kernel took q, k, v padded to D = 128 lanes and to 128-row blocks; on
Hopper the kernels take the unpadded (B, H, S, D) operands as strided
views whose last axis is contiguous, and write a contiguous output.
bfloat16 operands go to the tensor-core kernel (``mma.sync`` on bf16,
``cp.async`` staging), float32 ones to the SIMT kernel, which keeps full
float32 products (see the source comment for their bound and design).
The backward (``csrc/flash_attention_backward.cu``, a library of its own)
forms dQ, dK and dV in three SIMT kernels from the saved output.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

NAME = "flash_attention"
SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BACKWARD_NAME = "flash_attention_backward"
BACKWARD_SOURCE = SOURCE.parent / "flash_attention_backward.cu"

#: operand dtypes the kernel takes, by the code its entry point expects
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P] * 4 + [_I] * 7 + [ctypes.c_float, ctypes.POINTER(ctypes.c_int64)]


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGS[:4] + [_I] + _ARGS[4:] + [_I, _P]
        fn.restype = ctypes.c_int
        prev = lib.flash_attention_previous_launch
        prev.argtypes = _ARGS + [_P]
        prev.restype = ctypes.c_int
    return lib


def rows_aligned(q, k, v) -> bool:
    """Whether every row start of ``q``, ``k`` and ``v`` lies on 16 bytes,
    so that the bf16 kernel stages rows with 16-byte ``cp.async`` copies:
    bf16 base pointers on 16 bytes, and D and the (batch, head, position)
    strides of every axis longer than 1 multiples of 8 elements.  Otherwise
    it stages by element loads (odd D, odd strides)."""
    if q.shape[-1] % 8:
        return False
    return all(t.data_ptr() % 16 == 0
               and all(n == 1 or s % 8 == 0
                       for n, s in zip(t.shape[:3], t.stride()[:3]))
               for t in (q, k, v))


def _geometry(q, k, v):
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    return (int(B), int(Hq), int(Hkv), int(Sq), int(Skv), int(D)), strides


def _raise_on(rc: int, q, k, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {rc} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")


def launch(q, k, v, *, out: torch.Tensor, causal: bool,
           scale: float) -> None:
    """Launch on the current stream of ``out``'s device.

    ``q`` (B, Hq, Sq, D), ``k`` and ``v`` (B, Hkv, Skv, D) of one dtype on
    one card, each with unit stride on D; ``out`` contiguous like ``q``.
    Raises if the launch is refused.
    """
    dims, strides = _geometry(q, k, v)
    with torch.cuda.device(out.device):
        lib = library()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], *dims, int(bool(causal)), float(scale),
            strides, int(rows_aligned(q, k, v)), stream)
    _raise_on(rc, q, k, "flash_attention")


def launch_previous(q, k, v, *, out: torch.Tensor, causal: bool,
                    scale: float) -> None:
    """The previous bf16 design (the SIMT kernel's bf16 instantiation) on
    the same arguments as ``launch``, to time it beside the tensor-core
    kernel; ``ops.flash_attention`` never routes here."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the previous design is timed in bf16, not "
                        f"{q.dtype}")
    dims, strides = _geometry(q, k, v)
    with torch.cuda.device(out.device):
        lib = library()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = lib.flash_attention_previous_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *dims, int(bool(causal)), float(scale), strides, stream)
    _raise_on(rc, q, k, "flash_attention (previous design)")


def backward_library() -> ctypes.CDLL:
    """Build (first use) and load the backward's library."""
    lib = cuda_build.load(BACKWARD_NAME, BACKWARD_SOURCE)
    fn = lib.flash_attention_backward_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 10 + [_I] * 8 + [ctypes.c_float,
                                              ctypes.POINTER(ctypes.c_int64),
                                              _P])
        fn.restype = ctypes.c_int
    return lib


def launch_backward(q, k, v, o, dout, *, dq, dk, dv, causal: bool,
                    scale: float) -> None:
    """The three backward kernels on the current stream of ``dq``'s device.

    ``q``, ``k``, ``v`` as for ``launch``; ``o`` (the forward's output)
    and ``dout`` contiguous like ``q``; ``dq``, ``dk`` and ``dv``
    contiguous, of ``q``'s and ``k``'s shapes and dtype.  Allocates the
    (B, Hq, Sq) float32 log-sum-exp and delta scratch.  Raises if a launch
    is refused (a causal call needs Sq <= Skv).
    """
    dims, strides = _geometry(q, k, v)
    B, Hq, _, Sq = dims[:4]
    with torch.cuda.device(dq.device):
        lib = backward_library()
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=dq.device)
        delta = torch.empty_like(lse)
        stream = torch.cuda.current_stream(dq.device).cuda_stream
        rc = lib.flash_attention_backward_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), DTYPES[q.dtype], *dims,
            int(bool(causal)), float(scale), strides, stream)
    _raise_on(rc, q, k, "flash_attention backward")
