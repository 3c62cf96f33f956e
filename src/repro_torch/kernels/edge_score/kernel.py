"""ctypes binding of the CUDA ``edge_score`` kernel (``csrc/edge_score.cu``).

The port of the reference's Pallas ``edge_score_pallas``.  The TPU kernel
tiled the chunk as (rows, 128) lanes in 8x128 VMEM blocks over operands
gathered beforehand; on Hopper one source serves two entries (see the
source comment for its bound and design): ``launch_bits`` reads the
endpoints, the packed bit matrices and the cluster tables itself and makes
a 2PS-L chunk's whole choice, ``launch`` takes the ten gathered (E,)
operands; both take one thread per edge.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import cuda_build

NAME = "edge_score"
SOURCE = Path(__file__).resolve().parent / "csrc" / "edge_score.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    lib = cuda_build.load(NAME, SOURCE)
    fn = lib.edge_score_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 14 + [ctypes.c_float, _L, _P, _P, _P]
        fn.restype = _I
        bits = lib.edge_score_bits_launch
        bits.argtypes = [_P, _L, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P,
                         ctypes.c_float, _L, _I, _P, _P, _P, _P, _P]
        bits.restype = _I
    return lib


def _raise(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"edge_score kernel launch failed: CUDA error "
                           f"{rc} ({what})")


def launch(ints, flags, host_flags, dcn_penalty: float,
           chosen: torch.Tensor, best: torch.Tensor) -> None:
    """The flag entry, on the current stream of ``chosen``'s device.

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
    _raise(rc, f"flag entry, E={n}")


def launch_bits(bits, d, vol, v2c, c2p, edges, valid, hbits, host_of, *,
                dcn_penalty: float, chosen, best, todo, hi) -> None:
    """The bits entry, on the current stream of ``chosen``'s device.

    ``bits``: int32 (V, W); ``d``, ``v2c``: int32 (V,); ``vol``, ``c2p``:
    int32 (clusters,); ``edges``: int32 or int64 (E, 2) row-major;
    ``valid``: bool (E,); ``hbits``: int32 (V, HW) and ``host_of``: int32
    (k,), read when ``dcn_penalty`` != 0 (else None).  Writes ``chosen``,
    ``best``, ``todo`` and ``hi``, one thread per edge; an edge's two
    endpoints are one 8- or 16-byte load where the base is aligned to the
    pair.  Raises if the launch is refused.
    """
    n = edges.shape[0]
    V, W = bits.shape
    HW = hbits.shape[1] if dcn_penalty else 0
    vector = edges.data_ptr() % (2 * edges.element_size()) == 0
    with torch.cuda.device(chosen.device):
        lib = library()
        stream = torch.cuda.current_stream(chosen.device).cuda_stream
        rc = lib.edge_score_bits_launch(
            bits.data_ptr(), V, W, d.data_ptr(), v2c.data_ptr(),
            vol.data_ptr(), c2p.data_ptr(), edges.data_ptr(),
            int(edges.dtype == torch.int64), valid.data_ptr(),
            hbits.data_ptr() if HW else None, HW,
            host_of.data_ptr() if HW else None, ctypes.c_float(dcn_penalty),
            n, int(vector), chosen.data_ptr(), best.data_ptr(), todo.data_ptr(),
            hi.data_ptr(), stream)
    _raise(rc, f"bits entry, E={n}, V={V}, W={W}, paired={vector}")
