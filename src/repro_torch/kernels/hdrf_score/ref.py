"""Plain torch version of the ``hdrf_score`` kernel: the CPU path of
``hdrf_choose`` and the yardstick the CUDA kernel is held to on the card.
It shares HDRF's scoring function with the chunk functions."""
from __future__ import annotations

import torch

from ...core.scoring import hdrf_score


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
