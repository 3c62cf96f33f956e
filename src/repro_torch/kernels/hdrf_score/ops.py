"""Public wrapper of the ``hdrf_score`` kernel: dispatch on the device.

A CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain torch version in ``ref.py``.  Nothing falls
back from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from .. import LaunchCounter
from . import kernel
from .ref import hdrf_choose_ref

launches = LaunchCounter()

_FLAG_DTYPES = (torch.bool, torch.int8, torch.uint8)


def _check(name, t, dtypes, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"hdrf_choose: {name} must be a tensor")
    if t.device != device:
        raise ValueError(f"hdrf_choose: {name} is on {t.device}, expected "
                         f"{device}")
    if t.dtype not in dtypes:
        raise TypeError(f"hdrf_choose: {name} has dtype {t.dtype}, expected "
                        f"one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"hdrf_choose: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"hdrf_choose: {name} is not contiguous")


def hdrf_choose(du, dv, rep_u, rep_v, sizes, hrep_u=None, hrep_v=None, *,
                lam: float, dcn_penalty: float = 0.0,
                degree_weighted: bool = True):
    """(E,) int32 degrees ``du``/``dv``, (E, k) replica flags ``rep_u``/
    ``rep_v`` (bool or 0/1 int8), (k,) int32 partition ``sizes`` ->
    (chosen (E,) int32, best (E,) float32).

    ``chosen`` is the first index of each row's highest HDRF score (the
    reference's ``jnp.argmax``), ``best`` that score.  With ``dcn_penalty``
    != 0 the (E, k) host-group presence flags ``hrep_u``/``hrep_v``
    (``core.scoring.host_any``) subtract the host penalty;
    ``degree_weighted=False`` scores PowerGraph Greedy.
    """
    if du.device.type != "cuda":
        return hdrf_choose_ref(du, dv, rep_u, rep_v, sizes, hrep_u, hrep_v,
                               lam=lam, dcn_penalty=dcn_penalty,
                               degree_weighted=degree_weighted)
    if rep_u.dim() != 2:
        raise ValueError(f"hdrf_choose: rep_u must be (E, k), got shape "
                         f"{tuple(rep_u.shape)}")
    E, k = rep_u.shape
    dev = du.device
    for name, t in (("du", du), ("dv", dv)):
        _check(name, t, (torch.int32,), (E,), dev)
    _check("sizes", sizes, (torch.int32,), (k,), dev)
    flags = [("rep_u", rep_u), ("rep_v", rep_v)]
    if dcn_penalty:
        if hrep_u is None or hrep_v is None:
            raise ValueError("hdrf_choose: dcn_penalty != 0 needs hrep_u "
                             "and hrep_v")
        flags += [("hrep_u", hrep_u), ("hrep_v", hrep_v)]
    else:
        hrep_u = hrep_v = None
    for name, t in flags:
        _check(name, t, _FLAG_DTYPES, (E, k), dev)
    chosen = torch.empty(E, dtype=torch.int32, device=dev)
    best = torch.empty(E, dtype=torch.float32, device=dev)
    if E == 0:
        return chosen, best
    kernel.launch(du, dv, rep_u, rep_v, sizes, hrep_u, hrep_v, lam=lam,
                  dcn_penalty=float(dcn_penalty),
                  degree_weighted=degree_weighted, chosen=chosen, best=best)
    launches.count += 1
    return chosen, best
