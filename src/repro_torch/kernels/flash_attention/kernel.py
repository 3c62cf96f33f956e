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
forms dQ, dK and dV from the saved output.  Its route is decided by dtype
and head dim before any launch (``backward_route``): bf16 at D <= 128 takes
the tensor-core design (lse and delta, dQ per query tile, dK/dV partials
per (key tile, query head), and the group sum in head order); float32, and
bf16 at D > 128, the SIMT design, whose bf16 instantiation is also the
previous bf16 design (``launch_backward_previous``).
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


#: the largest head dim the tensor-core backward takes
BACKWARD_TC_MAX_D = 128
#: the backward's designs, by the code its entry point expects
BACKWARD_DESIGNS = {"simt": 0, "tensor_core": 1}
#: rows of the tensor-core backward's tiles (its lse and delta rows are
#: padded to a multiple)
BACKWARD_TILE = 64


def backward_route(q) -> str:
    """The backward design a call on operands like ``q`` takes, from dtype
    and head dim alone: ``"tensor_core"`` for bf16 at D <= 128, else
    ``"simt"`` (float32 at any D; bf16 above D = 128, where the tensor-core
    dK/dV kernel's accumulators would not fit the registers)."""
    if q.dtype == torch.bfloat16 and q.shape[-1] <= BACKWARD_TC_MAX_D:
        return "tensor_core"
    return "simt"


def backward_library() -> ctypes.CDLL:
    """Build (first use) and load the backward's library."""
    lib = cuda_build.load(BACKWARD_NAME, BACKWARD_SOURCE)
    fn = lib.flash_attention_backward_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 12 + [_I] * 9 + [ctypes.c_float,
                                              ctypes.POINTER(ctypes.c_int64),
                                              _I, _P])
        fn.restype = ctypes.c_int
    return lib


def _backward(q, k, v, o, dout, dq, dk, dv, causal, scale, design) -> int:
    """Launch ``design``'s kernels with their scratch; the CUDA error."""
    dims, strides = _geometry(q, k, v)
    B, Hq, Hkv, Sq, Skv, D = dims
    tc = design == "tensor_core"
    dev = dq.device
    with torch.cuda.device(dev):
        lib = backward_library()
        rows = -(-Sq // BACKWARD_TILE) * BACKWARD_TILE if tc else Sq
        lse = torch.empty((B, Hq, rows), dtype=torch.float32, device=dev)
        delta = torch.empty_like(lse)
        pk = pv = None            # each query head's dK and dV partials
        if tc and Hq > Hkv:
            pk = torch.empty((B, Hq, Skv, D), dtype=torch.float32,
                             device=dev)
            pv = torch.empty_like(pk)
        aligned = (tc and rows_aligned(q, k, v) and o.data_ptr() % 16 == 0
                   and dout.data_ptr() % 16 == 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        return lib.flash_attention_backward_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if pk is None else pk.data_ptr(),
            None if pv is None else pv.data_ptr(), DTYPES[q.dtype],
            BACKWARD_DESIGNS[design], *dims, int(bool(causal)),
            float(scale), strides, int(aligned), stream)


def launch_backward(q, k, v, o, dout, *, dq, dk, dv, causal: bool,
                    scale: float) -> None:
    """The backward on the current stream of ``dq``'s device, by
    ``backward_route``: four launches on the tensor-core route (three when
    Hq == Hkv), three on the SIMT one.

    ``q``, ``k``, ``v`` as for ``launch``; ``o`` (the forward's output)
    and ``dout`` contiguous like ``q``; ``dq``, ``dk`` and ``dv``
    contiguous, of ``q``'s and ``k``'s shapes and dtype.  Allocates the
    float32 log-sum-exp and delta scratch and, on the tensor-core route
    with Hq > Hkv, the (B, Hq, Skv, D) float32 dK and dV partials.  Raises
    if a launch is refused (a causal call needs Sq <= Skv).
    """
    rc = _backward(q, k, v, o, dout, dq, dk, dv, causal, scale,
                   backward_route(q))
    _raise_on(rc, q, k, "flash_attention backward")


def launch_backward_previous(q, k, v, o, dout, *, dq, dk, dv, causal: bool,
                             scale: float) -> None:
    """The previous bf16 design (the SIMT kernels' bf16 instantiation) on
    the same arguments as ``launch_backward``, to time it beside the
    tensor-core design; ``ops.flash_attention_backward`` never routes a
    bf16 call at D <= 128 here."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the previous design is timed in bf16, not "
                        f"{q.dtype}")
    rc = _backward(q, k, v, o, dout, dq, dk, dv, causal, scale, "simt")
    _raise_on(rc, q, k, "flash_attention backward (previous design)")
