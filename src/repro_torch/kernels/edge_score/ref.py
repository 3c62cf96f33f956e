"""Plain torch version of the ``edge_score`` kernel: the CPU path of
``edge_score_choose`` and the yardstick the CUDA kernel is held to on the
card.  It shares the paper's scoring function with the chunk functions."""
from __future__ import annotations

import torch

from ...core.scoring import twopsl_score


def edge_score_choose_ref(du, dv, vol_u, vol_v, rep_u1, rep_v1, rep_u2,
                          rep_v2, pu, pv, hrep_u1=None, hrep_v1=None,
                          hrep_u2=None, hrep_v2=None, *,
                          dcn_penalty: float = 0.0):
    """Flat (E,) inputs -> (chosen (E,) int32, best (E,) float32)."""
    def hosted(h):
        return (h != 0) if dcn_penalty else None
    ones = torch.ones_like(pu, dtype=torch.bool)
    s1 = twopsl_score(du, dv, vol_u, vol_v, rep_u1 != 0, rep_v1 != 0,
                      ones, pv == pu, hrep_u=hosted(hrep_u1),
                      hrep_v=hosted(hrep_v1), dcn_penalty=dcn_penalty)
    s2 = twopsl_score(du, dv, vol_u, vol_v, rep_u2 != 0, rep_v2 != 0,
                      pu == pv, ones, hrep_u=hosted(hrep_u2),
                      hrep_v=hosted(hrep_v2), dcn_penalty=dcn_penalty)
    chosen = torch.where(s2 > s1, pv, pu).to(torch.int32)
    return chosen, torch.maximum(s1, s2)
