"""Plain torch versions of the ``hdrf_score`` kernel's two entries: the CPU
path of ``hdrf_choose`` and ``hdrf_choose_bits`` and the yardstick the CUDA
kernel is held to on the card.  They share HDRF's scoring function with the
chunk functions."""
from __future__ import annotations

import torch

from ...core import bitops
from ...core.scoring import hdrf_score, host_any


def hdrf_choose_ref(du, dv, rep_u, rep_v, sizes, hrep_u=None, hrep_v=None,
                    *, lam: float, dcn_penalty: float = 0.0,
                    degree_weighted: bool = True):
    """(E,) degrees, (E, k) flags, (k,) sizes -> (chosen (E,) int32,
    best (E,) float32): the first index of each row's highest score."""
    host_kw = {}
    if dcn_penalty:
        host_kw = dict(hrep_u=hrep_u != 0, hrep_v=hrep_v != 0,
                       dcn_penalty=dcn_penalty)
    scores = hdrf_score(du, dv, rep_u != 0, rep_v != 0, sizes, lam=lam,
                        degree_weighted=degree_weighted, **host_kw)
    best, chosen = scores.max(dim=1)
    return chosen.to(torch.int32), best


def hdrf_choose_bits_ref(bits, d, uv, sizes, *, k: int, lam: float,
                         num_hosts: int = 0, dcn_penalty: float = 0.0,
                         degree_weighted: bool = True):
    """The bits entry composed of plain steps: gather the (2E, k) replica
    flags of ``uv`` = [u..., v...] from the packed ``bits`` and their
    degrees from ``d``, derive host presence with ``host_any`` (when
    ``dcn_penalty`` != 0 and ``num_hosts`` > 1), then ``hdrf_choose_ref``."""
    E = uv.shape[0] // 2
    parts = torch.arange(k, device=bits.device)
    rep = bitops.get(bits, uv[:, None], parts[None, :])
    d_uv = d[uv]
    host_kw = {}
    if dcn_penalty and num_hosts > 1:
        hrep = host_any(rep, num_hosts)
        host_kw = dict(hrep_u=hrep[:E], hrep_v=hrep[E:],
                       dcn_penalty=dcn_penalty)
    return hdrf_choose_ref(d_uv[:E], d_uv[E:], rep[:E], rep[E:], sizes,
                           lam=lam, degree_weighted=degree_weighted,
                           **host_kw)
