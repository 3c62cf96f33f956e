"""Scoring functions: 2PS-L (paper §III-B), HDRF (Petroni et al.) and the
host-affinity penalty.

The pure math behind the chunk functions and the plain versions of the
``edge_score`` and ``hdrf_score`` kernels, over already *gathered* per-edge
quantities.

Bit-identity with the reference holds against what the reference
*computes*, which is its jitted form: under ``jit`` XLA's algebraic
simplifier rewrites the source's ``1.0 + (1.0 - d/dsum)`` into
``2.0 - d/dsum``.  The two differ in the last ulp for a few percent of
float32 inputs, enough to flip near ties, so this module writes ``2 - θ``
(in ``twopsl_score`` and ``hdrf_score`` alike).
"""
from __future__ import annotations

import torch


def host_affinity_penalty(hrep_u, hrep_v, dcn_penalty: float):
    """A candidate partition pays ``dcn_penalty`` for every endpoint with NO
    replica on the candidate's host group.  Returns the (non-negative)
    float32 amount to SUBTRACT from the flat score."""
    miss_u = 1.0 - hrep_u.to(torch.float32)
    miss_v = 1.0 - hrep_v.to(torch.float32)
    return float(dcn_penalty) * (miss_u + miss_v)


def host_any(rep: torch.Tensor, num_hosts: int) -> torch.Tensor:
    """Collapse an ``(..., k)`` per-partition replica matrix to per-host
    presence, broadcast back to ``(..., k)``: entry ``p`` is True iff ANY
    partition on ``p``'s host group holds the vertex (partition ``p`` on
    host ``p // (k/H)``; ``k`` must be a multiple of ``num_hosts``)."""
    k = rep.shape[-1]
    d = k // num_hosts
    grouped = rep.reshape(*rep.shape[:-1], num_hosts, d).any(dim=-1)
    return grouped.repeat_interleave(d, dim=-1)


def twopsl_score(du, dv, vol_cu, vol_cv, rep_u, rep_v, cu_on_p, cv_on_p,
                 hrep_u=None, hrep_v=None, dcn_penalty: float = 0.0):
    """s(u,v,p) = g_u + g_v + sc_u + sc_v  for ONE candidate partition p.

    du, dv          : int32 degrees of the edge's endpoints
    vol_cu, vol_cv  : int32 volumes of the endpoints' clusters
    rep_u, rep_v    : bool, endpoint already replicated on p
    cu_on_p, cv_on_p: bool, endpoint's cluster is mapped to p
    hrep_u, hrep_v  : bool, endpoint replicated anywhere on p's host group
                      (only read when ``dcn_penalty`` != 0)

    ``du + dv`` is an int32 add followed by a float32 convert, as in the
    reference's jnp path (the Pallas wrapper converts first; the two agree
    while the sums stay below 2^24).  ``dcn_penalty=0`` evaluates the flat
    expression unchanged.
    """
    dsum = (du + dv).to(torch.float32).clamp_min(1.0)
    g_u = torch.where(rep_u, 2.0 - du / dsum, 0.0)
    g_v = torch.where(rep_v, 2.0 - dv / dsum, 0.0)
    vsum = (vol_cu + vol_cv).to(torch.float32).clamp_min(1.0)
    sc_u = torch.where(cu_on_p, vol_cu / vsum, 0.0)
    sc_v = torch.where(cv_on_p, vol_cv / vsum, 0.0)
    s = g_u + g_v + sc_u + sc_v
    if dcn_penalty:
        s = s - host_affinity_penalty(hrep_u, hrep_v, dcn_penalty)
    return s


def hdrf_score(du, dv, rep_u, rep_v, part_sizes, lam: float = 1.1,
               degree_weighted: bool = True, hrep_u=None, hrep_v=None,
               dcn_penalty: float = 0.0):
    """HDRF score of every edge against ALL k partitions (the O(k) per-edge
    baseline cost 2PS-L removes); ``degree_weighted=False`` is PowerGraph
    Greedy (a replica counts 1, with no high-degree preference).

    du, dv     : (E,) int32 degrees
    rep_u/v    : (E, k) bool replication state
    part_sizes : (k,) int32 current partition sizes
    hrep_u/v   : (E, k) bool host-group presence (``host_any``), read only
                 when ``dcn_penalty`` != 0
    returns    : (E, k) float32 scores

    The jitted reference's arithmetic: ``g = 2 - θ`` with ``θ = d / max(
    float(du + dv), 1)`` (an int32 add, then the convert); ``c_bal =
    (λ (max - s)) / ((1 + max) - min)``; score ``(g_u + g_v) + c_bal``,
    minus the host penalty after its own rounding.
    """
    if degree_weighted:
        dsum = (du + dv).to(torch.float32).clamp_min(1.0)[:, None]
        g_u = torch.where(rep_u, 2.0 - du[:, None] / dsum, 0.0)
        g_v = torch.where(rep_v, 2.0 - dv[:, None] / dsum, 0.0)
    else:
        g_u = torch.where(rep_u, 1.0, 0.0)
        g_v = torch.where(rep_v, 1.0, 0.0)
    sizes = part_sizes.to(torch.float32)
    maxsize, minsize = sizes.max(), sizes.min()
    c_bal = (lam * (maxsize - sizes)) / ((1.0 + maxsize) - minsize)
    s = (g_u + g_v) + c_bal[None, :]
    if dcn_penalty:
        s = s - host_affinity_penalty(hrep_u, hrep_v, dcn_penalty)
    return s
