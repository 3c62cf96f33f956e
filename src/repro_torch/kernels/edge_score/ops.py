"""Public wrapper of the ``edge_score`` kernel: dispatch on the device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain torch version in ``ref.py``.  Nothing falls
back from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from .. import LaunchCounter
from . import kernel
from .ref import edge_score_choose_ref

launches = LaunchCounter()

_INT_ARGS = ("du", "dv", "vol_u", "vol_v", "pu", "pv")
_FLAG_DTYPES = (torch.bool, torch.int8, torch.uint8)


def _check(name, t, dtypes, like):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"edge_score_choose: {name} must be a tensor")
    if t.device != like.device:
        raise ValueError(f"edge_score_choose: {name} is on {t.device}, "
                         f"expected {like.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"edge_score_choose: {name} has dtype {t.dtype}, "
                        f"expected one of {dtypes}")
    if t.dim() != 1 or t.shape != like.shape:
        raise ValueError(f"edge_score_choose: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(like.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"edge_score_choose: {name} is not contiguous")


def edge_score_choose(du, dv, vol_u, vol_v, rep_u1, rep_v1, rep_u2, rep_v2,
                      pu, pv, hrep_u1=None, hrep_v1=None, hrep_u2=None,
                      hrep_v2=None, *, dcn_penalty: float = 0.0):
    """Flat (E,) inputs -> (chosen (E,) int32, best (E,) float32).

    Same arguments and outputs as the reference's
    ``repro.kernels.edge_score.edge_score_choose``: degrees ``du``/``dv``
    and cluster volumes ``vol_u``/``vol_v`` (int32), the four replica flags
    of each endpoint on each candidate (bool or 0/1 int8), the candidates
    ``pu``/``pv`` (int32), and with ``dcn_penalty`` != 0 the four
    host-group presence flags.  ``chosen = pv if s2 > s1 else pu``,
    ``best = max(s1, s2)``.
    """
    flags = (rep_u1, rep_v1, rep_u2, rep_v2)
    hflags = (hrep_u1, hrep_v1, hrep_u2, hrep_v2) if dcn_penalty else None
    if du.device.type != "cuda":
        return edge_score_choose_ref(du, dv, vol_u, vol_v, *flags, pu, pv,
                                     *(hflags or ()),
                                     dcn_penalty=dcn_penalty)
    ints = (du, dv, vol_u, vol_v, pu, pv)
    for name, t in zip(_INT_ARGS, ints):
        _check(name, t, (torch.int32,), du)
    for i, t in enumerate(flags):
        _check(f"rep flag {i}", t, _FLAG_DTYPES, du)
    if hflags is not None:
        if any(h is None for h in hflags):
            raise ValueError("edge_score_choose: dcn_penalty != 0 needs all "
                             "four hrep_* flags")
        for i, t in enumerate(hflags):
            _check(f"host flag {i}", t, _FLAG_DTYPES, du)
    E = du.shape[0]
    chosen = torch.empty(E, dtype=torch.int32, device=du.device)
    best = torch.empty(E, dtype=torch.float32, device=du.device)
    if E == 0:
        return chosen, best
    kernel.launch(ints, flags, hflags, float(dcn_penalty), chosen, best)
    launches.count += 1
    return chosen, best
