"""ctypes binding of the CUDA ``edge_score`` kernel (``csrc/edge_score.cu``).

The port of the reference's Pallas ``edge_score_pallas``.  The TPU kernel
tiled the chunk as (rows, 128) lanes in 8x128 VMEM blocks; on Hopper the
kernel takes the flat ``(E,)`` arrays, one thread per edge, for any ``E``
(see the source comment for its bound and design).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

NAME = "edge_score"
SOURCE = Path(__file__).resolve().parent / "csrc" / "edge_score.cu"

_P = ctypes.c_void_p


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.edge_score_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 14 + [ctypes.c_float, ctypes.c_int64, _P, _P,
                                   _P]
        fn.restype = ctypes.c_int
    return lib


def launch(ints, flags, host_flags, dcn_penalty: float,
           chosen: torch.Tensor, best: torch.Tensor) -> None:
    """Launch on the current stream of ``chosen``'s device.

    ``ints``  : (du, dv, vol_u, vol_v, pu, pv), int32 contiguous (E,)
    ``flags`` : (rep_u1, rep_v1, rep_u2, rep_v2), 1-byte contiguous (E,)
    ``host_flags``: the four host flags of the same layout, or None when
    ``dcn_penalty`` is 0.  Raises if the launch is refused.
    """
    du, dv, vol_u, vol_v, pu, pv = ints
    hflags = host_flags if host_flags is not None else (None,) * 4
    n = chosen.numel()
    with torch.cuda.device(chosen.device):
        stream = torch.cuda.current_stream(chosen.device).cuda_stream
        rc = library().edge_score_launch(
            du.data_ptr(), dv.data_ptr(), vol_u.data_ptr(), vol_v.data_ptr(),
            *(f.data_ptr() for f in flags), pu.data_ptr(), pv.data_ptr(),
            *((h.data_ptr() if h is not None else None) for h in hflags),
            ctypes.c_float(dcn_penalty), ctypes.c_int64(n),
            chosen.data_ptr(), best.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"edge_score kernel launch failed: CUDA error "
                           f"{rc} (E={n})")
