"""Plain torch versions of the ``edge_score`` kernel's two entries: the CPU
path of ``edge_score_choose`` and ``edge_score_choose_bits`` and the
yardstick the CUDA kernel is held to on the card.  They share the paper's
scoring function with the chunk functions."""
from __future__ import annotations

import torch

from .. import wrap_clamp_index
from ...core import bitops
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


def edge_score_choose_bits_ref(bits, d, vol, v2c, c2p, edges, valid, *,
                               hbits=None, host_of=None,
                               dcn_penalty: float = 0.0):
    """2PS-L's two-candidate choice composed of plain steps: gather each
    endpoint's cluster ``v2c`` and degree ``d``, each cluster's partition
    ``c2p`` and volume ``vol``, the four replica flags from the packed
    ``bits`` (with ``dcn_penalty`` != 0 the four host flags from ``hbits``
    on ``host_of`` of the candidates), then ``edge_score_choose_ref``.

    Returns ``(chosen (E,) int32, best (E,) float32, todo (E,) bool,
    hi (E,))``: ``todo`` is ``valid`` minus the edges pre-partitioning
    placed (same cluster or same partition), ``hi`` the endpoint of the
    higher degree (``u`` on a tie), in ``edges``' dtype.  Endpoints are
    read by JAX's gather rule (wrapped once, clamped to [0, V)); ``hi``
    keeps the raw ids."""
    u, v = edges[:, 0], edges[:, 1]
    V = bits.shape[0]
    ui, vi = wrap_clamp_index(u, V), wrap_clamp_index(v, V)
    cu, cv = v2c[ui], v2c[vi]
    pu, pv = c2p[cu], c2p[cv]
    todo = valid & ~((cu == cv) | (pu == pv))
    du, dv = d[ui], d[vi]
    host_kw = {}
    if dcn_penalty:
        hu, hv = host_of[pu], host_of[pv]
        host_kw = dict(hrep_u1=bitops.get(hbits, ui, hu),
                       hrep_v1=bitops.get(hbits, vi, hu),
                       hrep_u2=bitops.get(hbits, ui, hv),
                       hrep_v2=bitops.get(hbits, vi, hv))
    chosen, best = edge_score_choose_ref(
        du, dv, vol[cu], vol[cv],
        bitops.get(bits, ui, pu), bitops.get(bits, vi, pu),
        bitops.get(bits, ui, pv), bitops.get(bits, vi, pv),
        pu, pv, **host_kw, dcn_penalty=dcn_penalty)
    return chosen, best, todo, torch.where(du >= dv, u, v)
