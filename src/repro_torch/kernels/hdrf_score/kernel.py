"""ctypes binding of the CUDA ``hdrf_score`` kernel (``csrc/hdrf_score.cu``).

The port of the reference's Pallas ``hdrf_pallas``.  The TPU kernel padded
the partitions to 128 lanes and the edges to 8-row blocks; on Hopper the
kernel takes the flat ``(E,)`` degrees and the ``(E, k)`` flag matrices as
they are, one warp per edge, for any ``E`` and ``k`` (see the source
comment for its bound and design).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

NAME = "hdrf_score"
SOURCE = Path(__file__).resolve().parent / "csrc" / "hdrf_score.cu"

_P = ctypes.c_void_p


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.hdrf_score_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 7 + [ctypes.c_float, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                  _P, _P, _P]
        fn.restype = ctypes.c_int
    return lib


def launch(du, dv, rep_u, rep_v, sizes, hrep_u, hrep_v, *, lam: float,
           dcn_penalty: float, degree_weighted: bool,
           chosen: torch.Tensor, best: torch.Tensor) -> None:
    """Launch on the current stream of ``chosen``'s device.

    ``du``/``dv``: int32 (E,); ``rep_*``/``hrep_*``: 1-byte (E, k),
    row-major (the host flags None when ``dcn_penalty`` is 0); ``sizes``:
    int32 (k,).  Raises if the launch is refused.
    """
    n, k = rep_u.shape
    with torch.cuda.device(chosen.device):
        stream = torch.cuda.current_stream(chosen.device).cuda_stream
        rc = library().hdrf_score_launch(
            du.data_ptr(), dv.data_ptr(), rep_u.data_ptr(), rep_v.data_ptr(),
            sizes.data_ptr(),
            hrep_u.data_ptr() if hrep_u is not None else None,
            hrep_v.data_ptr() if hrep_v is not None else None,
            ctypes.c_float(lam), ctypes.c_float(dcn_penalty),
            int(bool(degree_weighted)), ctypes.c_int64(n), int(k),
            chosen.data_ptr(), best.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"hdrf_score kernel launch failed: CUDA error "
                           f"{rc} (E={n}, k={k})")
