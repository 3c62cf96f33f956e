"""2PS-L Phase 2 — streaming partitioning (paper Algorithm 2), in torch,
plus the chunk functions of the baselines the paper measures against.

Bulk-synchronous chunked implementation of the three steps:

  Step 1  clusters -> partitions  (mapping.py, Graham LPT)
  Step 2  pre-partitioning        (_prepartition_core)
  Step 3  linear 2-candidate scoring for remaining edges (_score_chunk),
          or k-way HDRF scoring for 2PS-HDRF (_hdrf_remaining_chunk)

The baselines: HDRF / Greedy (_hdrf_chunk, 64-edge micro-batches) and the
stateless hashes DBH, Grid and Random (_dbh_chunk, _grid_chunk,
_random_hash_chunk).  ``_prepartition_chunk`` (pre-partitioning with the
bits folded on the device) serves the incremental re-partitioner.

The hard balance cap ``|p| <= ceil(alpha*|E|/k)`` is enforced *exactly* even
under vectorization via per-chunk prefix ranks: within a chunk, edges
targeting partition p are ranked in stream order and only the first
``remaining_capacity(p)`` are admitted; the rest overflow down the paper's
fallback chain (degree-hash, then least-loaded).

The reference's jitted chunk functions return new arrays from donated
buffers; these update their state tensors (``sizes``, ``bits``, ``hbits``)
in place and return them, so the engine threads the same tensors from
chunk to chunk.  The one host synchronisation per admission tail is the
``.any()`` that skips the least-loaded rounds when nothing overflowed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import bitops
from .hashing import _mul_u32, hash_mod
# the modules, not the functions: the kernel packages import this
# package's scoring module, so either side may be imported first
from ..kernels.edge_score import ops as edge_score_ops
from ..kernels.hdrf_score import ops as hdrf_score_ops


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _chunk_rank(target: torch.Tensor, eligible: torch.Tensor, k: int):
    """Stream-order rank of each eligible edge among same-target edges: a
    stable sort plus a running max of segment starts, never atomics."""
    C = target.shape[0]
    key = torch.where(eligible, target, k)
    key_s, order = torch.sort(key, stable=True)
    idx = torch.arange(C, dtype=torch.int64, device=target.device)
    is_start = torch.ones(C, dtype=torch.bool, device=target.device)
    is_start[1:] = key_s[1:] != key_s[:-1]
    start_pos = torch.cummax(torch.where(is_start, idx, 0), 0).values
    rank = torch.empty(C, dtype=torch.int64, device=target.device)
    rank[order] = idx - start_pos
    return rank


def _ranked_admit(target, eligible, sizes, cap, k):
    """Admit eligible edges up to the remaining capacity ``cap - sizes``
    (``cap`` an int; stream order).  Updates ``sizes`` in place; returns
    ``(admitted_mask, sizes)``."""
    rank = _chunk_rank(target, eligible, k)
    remaining = (cap - sizes).clamp_min(0)
    ok = eligible & (rank < remaining[target.clamp(0, k - 1)])
    sizes.index_add_(0, torch.where(ok, target, 0), ok.to(sizes.dtype))
    return ok, sizes


def _least_loaded_rounds(assignment, pending, sizes, cap, k):
    """Fill the least-loaded partition, one round at a time, until every
    ``pending`` edge is assigned (the reference's bounded ``while_loop``).

    Almost every chunk has nothing pending, so one ``.any()`` — a host
    sync — decides whether the rounds run at all; on the card that sync
    costs less than launching k+1 rounds that change nothing
    (``chip_smoke.py``'s ``least_loaded_rounds`` phase times both)."""
    if not bool(pending.any()):
        return assignment, sizes
    return _fill_rounds(assignment, pending, sizes, cap, k)


def _fill_rounds(assignment, pending, sizes, cap, k):
    """The rounds themselves.  The reference's loop stops when nothing is
    pending or after k+1 rounds; a round with nothing pending changes
    nothing, so running exactly k+1 rounds gives the same result."""
    for _ in range(k + 1):
        un = pending & (assignment < 0)
        t = torch.argmin(sizes)                # lowest index wins ties
        rem = (cap - sizes[t]).clamp_min(0)
        rank = torch.cumsum(un.to(torch.int32), 0) - 1
        take = un & (rank < rem)
        assignment = torch.where(take, t.to(assignment.dtype), assignment)
        sizes.index_add_(0, t.reshape(1), take.sum(dtype=sizes.dtype)
                         .reshape(1))
    return assignment, sizes


def _apply_bits(bits, edges, assignment):
    """Fold the chunk's assignment into the replication matrix, in place."""
    return _apply_bits_uv(bits, torch.cat([edges[:, 0], edges[:, 1]]),
                          assignment)


def _apply_bits_uv(bits, uv, assignment):
    """``_apply_bits`` for endpoints given as one run ``uv`` = [u..., v...]."""
    a2 = assignment.repeat(2)
    return bitops.set_(bits, uv, a2.clamp_min(0), mask=a2 >= 0)


def _apply_host_bits(hbits, edges, assignment, host_of):
    """Fold the per-HOST replica matrix: the same OR as ``_apply_bits`` but
    with the assignment mapped through ``host_of`` (partition -> host)."""
    hasg = torch.where(assignment >= 0, host_of[assignment.clamp_min(0)], -1)
    return _apply_bits(hbits, edges, hasg)


def _admit_with_fallback(sizes, chosen, todo, hi, k, cap):
    """The paper's shared admission tail: capacity-ranked admission of the
    chosen partition, then the overflow chain (max-degree hash of ``hi``,
    the endpoint of the higher degree, -> least-loaded last resort, Alg. 2
    line 22-23 + prose).  Returns ``(assignment, sizes)`` with every
    ``todo`` edge placed."""
    ok, sizes = _ranked_admit(chosen, todo, sizes, cap, k)
    assignment = torch.where(ok, chosen, -1).to(torch.int32)

    over = todo & ~ok
    t2 = hash_mod(hi, k)
    ok2, sizes = _ranked_admit(t2, over, sizes, cap, k)
    assignment = torch.where(ok2, t2, assignment)

    still = over & ~ok2
    return _least_loaded_rounds(assignment, still, sizes, cap, k)


# ---------------------------------------------------------------------------
# Step 2: pre-partitioning
# ---------------------------------------------------------------------------

def _prepartition_core(sizes, d, v2c, c2p, edges, valid, *, k, cap):
    """Assign every edge whose endpoints share a cluster (or whose clusters
    share a partition) to that partition; overflow -> hash -> least-loaded.
    ``sizes`` is updated in place.  Returns ``(sizes, assignment,
    remaining)``.

    Does NOT fold the replication bit matrix: pre-partitioning never reads
    ``bits``, so the engine folds replication on the host in the pipeline's
    writeback stage."""
    u, v = edges[:, 0], edges[:, 1]
    cu, cv = v2c[u], v2c[v]
    pu, pv = c2p[cu], c2p[cv]
    eligible = valid & ((cu == cv) | (pu == pv))
    hi = torch.where(d[u] >= d[v], u, v)

    assignment, sizes = _admit_with_fallback(sizes, pu, eligible, hi, k,
                                             cap)
    remaining = valid & ~eligible
    return sizes, assignment, remaining


def _prepartition_chunk(bits, sizes, d, v2c, c2p, edges, valid, *, k, cap):
    """Pre-partitioning with the bits folded on the device: for consumers
    that read the replication state right after (the incremental
    re-partitioner scores the same chunk next).  ``bits`` and ``sizes``
    are updated in place.  Returns ``(bits, sizes, assignment,
    remaining)``."""
    sizes, assignment, remaining = _prepartition_core(
        sizes, d, v2c, c2p, edges, valid, k=k, cap=cap)
    _apply_bits(bits, edges, assignment)
    return bits, sizes, assignment, remaining


# ---------------------------------------------------------------------------
# Step 3: linear-time 2-candidate scoring
# ---------------------------------------------------------------------------

def _twopsl_choose(bits, d, vol, v2c, c2p, edges, valid, *,
                   hbits=None, host_of=None, dcn_penalty: float = 0.0):
    """The paper's two-candidate chooser, shared by the flat and the
    host-aware scoring chunks: one ``edge_score_choose_bits`` call (on the
    card one kernel launch that reads the bit matrices and the cluster
    tables itself; on the CPU its plain version) scores the two cluster
    partitions of every edge and picks the better.

    Returns ``(todo, chosen, hi)`` for the admission tail."""
    chosen, _, todo, hi = edge_score_ops.edge_score_choose_bits(
        bits, d, vol, v2c, c2p, edges, valid, hbits=hbits, host_of=host_of,
        dcn_penalty=dcn_penalty)
    return todo, chosen, hi


def _score_chunk(bits, sizes, d, vol, v2c, c2p, edges, valid, *, k, cap):
    """Score each *remaining* edge against exactly two candidate partitions
    (the partitions of its endpoints' clusters) — the paper's O(|E|) claim.
    ``bits`` and ``sizes`` are updated in place.  Returns ``(bits, sizes,
    assignment)``."""
    todo, chosen, hi = _twopsl_choose(bits, d, vol, v2c, c2p, edges, valid)
    assignment, sizes = _admit_with_fallback(sizes, chosen, todo, hi, k,
                                             cap)
    _apply_bits(bits, edges, assignment)
    return bits, sizes, assignment


def _score_chunk_hosted(bits, hbits, sizes, d, vol, v2c, c2p, host_of,
                        edges, valid, *, k, cap, dcn_penalty: float):
    """Host-aware 2PS-L scoring: ``_score_chunk`` plus the DCN locality
    term read from the O(|V|*H)-bit per-HOST replica matrix ``hbits``.
    ``bits``, ``hbits`` and ``sizes`` are updated in place.  Returns
    ``(bits, hbits, sizes, assignment)``."""
    todo, chosen, hi = _twopsl_choose(
        bits, d, vol, v2c, c2p, edges, valid,
        hbits=hbits, host_of=host_of, dcn_penalty=dcn_penalty)
    assignment, sizes = _admit_with_fallback(sizes, chosen, todo, hi, k,
                                             cap)
    _apply_bits(bits, edges, assignment)
    _apply_host_bits(hbits, edges, assignment, host_of)
    return bits, hbits, sizes, assignment


# ---------------------------------------------------------------------------
# Baselines: HDRF k-way scoring, DBH, Grid, random hash
# ---------------------------------------------------------------------------

def _hdrf_chunk(bits, sizes, dpart, edges, valid, *, k, cap, lam, use_cap,
                sub: int = 64, degree_weighted: bool = True,
                n: int, num_hosts: int = 0, dcn_penalty: float = 0.0):
    """HDRF (or Greedy with ``degree_weighted=False``): score EVERY
    partition for every edge, with HDRF's own streamed partial degrees
    ``dpart`` — the O(|E|*k) cost the paper removes.

    A Python loop over ``sub``-edge micro-batches stands for the
    reference's ``lax.scan``; each micro-batch counts its endpoints into
    ``dpart`` (duplicates accumulate, and the degrees are read after the
    adds), chooses with one ``hdrf_choose_bits`` launch (the kernel reads
    the endpoints' packed replica rows and ``dpart`` itself; host
    presence, when hosted, comes from the same rows), admits (with
    ``use_cap`` under the hard cap, else straight to ``sizes``) and folds
    the bits.  ``bits``, ``sizes`` and ``dpart`` are updated in place.

    ``n`` (the chunk's valid row count, known on the host) skips the
    micro-batches that hold only padding: they change nothing, so the
    result is the same and a chunk of ``n`` rows launches
    ``ceil(n / sub)`` kernels.

    Returns ``(bits, sizes, dpart, assignment)``."""
    C = edges.shape[0]
    assert C % sub == 0
    steps = -(-n // sub)
    # row i: micro-batch i's endpoints as one run, its u's then its v's
    uv_all = edges.reshape(C // sub, sub, 2).transpose(1, 2).reshape(
        C // sub, 2 * sub)
    m_all = valid.view(C // sub, sub)
    w_all = m_all.to(torch.int32).repeat(1, 2)
    out = []
    for i in range(steps):
        uv, m, w = uv_all[i], m_all[i], w_all[i]
        dpart.index_add_(0, uv, w)
        chosen, _ = hdrf_score_ops.hdrf_choose_bits(
            bits, dpart, uv, sizes, k=k, lam=lam, num_hosts=num_hosts,
            dcn_penalty=dcn_penalty, degree_weighted=degree_weighted)
        if use_cap:
            ok, sizes = _ranked_admit(chosen, m, sizes, cap, k)
            asg = torch.where(ok, chosen, -1).to(torch.int32)
            asg, sizes = _least_loaded_rounds(asg, m & ~ok, sizes, cap, k)
        else:
            asg = torch.where(m, chosen, -1).to(torch.int32)
            sizes.index_add_(0, chosen, w[:sub])     # padding rows add 0
        _apply_bits_uv(bits, uv, asg)
        out.append(asg)
    if steps * sub < C:                  # the skipped all-padding tail
        out.append(torch.full((C - steps * sub,), -1, dtype=torch.int32,
                              device=edges.device))
    return bits, sizes, dpart, torch.cat(out)


def _hdrf_remaining_chunk(bits, sizes, d, v2c, c2p, edges, valid, *, k, cap,
                          lam, num_hosts: int = 0, dcn_penalty: float = 0.0):
    """2PS-HDRF step 3: HDRF scoring over ALL k partitions, with Phase 1's
    true degrees, for the edges pre-partitioning left over — one
    ``hdrf_choose_bits`` launch per chunk.  ``bits`` and ``sizes`` are
    updated in place.  Returns ``(bits, sizes, assignment)``."""
    C = edges.shape[0]
    u, v = edges[:, 0], edges[:, 1]
    cu, cv = v2c[u], v2c[v]
    skip = (cu == cv) | (c2p[cu] == c2p[cv])
    todo = valid & ~skip
    uv = torch.cat([u, v])
    d_uv = d[uv]
    hi = torch.where(d_uv[:C] >= d_uv[C:], u, v)
    chosen, _ = hdrf_score_ops.hdrf_choose_bits(
        bits, d, uv, sizes, k=k, lam=lam, num_hosts=num_hosts,
        dcn_penalty=dcn_penalty)
    assignment, sizes = _admit_with_fallback(sizes, chosen, todo, hi, k,
                                             cap)
    _apply_bits_uv(bits, uv, assignment)
    return bits, sizes, assignment


def _lower_degree_hash(u, v, du, dv, k):
    """DBH's target: the hash of the LOWER-degree endpoint (``u`` on a
    tie).  HEP's cold edges fall back to it too."""
    return hash_mod(torch.where(du <= dv, u, v), k)


def _dbh_chunk(d, edges, valid, *, k):
    """Degree-based hashing: hash the LOWER-degree endpoint (Xie et al.)."""
    u, v = edges[:, 0], edges[:, 1]
    return torch.where(valid, _lower_degree_hash(u, v, d[u], d[v], k),
                       -1).to(torch.int32)


def _grid_chunk(edges, valid, *, k, rows, cols):
    """Grid (GraphBuilder-style 2D hash):
    ``p = (h(u) % rows) * cols + h1(v) % cols``."""
    u, v = edges[:, 0], edges[:, 1]
    p = hash_mod(u, rows) * cols + hash_mod(v, cols, seed=1)
    return torch.where(valid, p, -1).to(torch.int32)


def _random_hash_chunk(edges, valid, *, k):
    """Pure edge hashing: ``h(u * 0x9E3779B9 ^ v) % k`` with the product
    wrapped at 32 bits, as the reference's uint32 arithmetic wraps."""
    u = edges[:, 0].to(torch.int64) & 0xFFFFFFFF
    v = edges[:, 1].to(torch.int64) & 0xFFFFFFFF
    mixed = _mul_u32(u, 0x9E3779B9) ^ v
    return torch.where(valid, hash_mod(mixed, k), -1).to(torch.int32)


# ---------------------------------------------------------------------------
# chunk padding helper shared by the engine and the clustering pass
# ---------------------------------------------------------------------------

@dataclass
class PaddedChunk:
    edges: torch.Tensor     # (chunk_size, 2) int64 on the run's device
    valid: torch.Tensor     # (chunk_size,) bool
    n: int
    #: the unpadded host chunk, kept by reference for chunk functions with
    #: a host half (buffered re-streaming clusters the window on the host),
    #: so they never copy it back from the device
    host: np.ndarray | None = None


_valid_masks: dict = {}


def _valid_mask(chunk_size: int, n: int, device) -> torch.Tensor:
    """Cached validity mask.  Only two shapes occur per (stream,
    chunk_size) pair — the all-valid body and the ragged tail — so caching
    removes two small launches per chunk from the streaming loop."""
    key = (chunk_size, n, str(device))
    mask = _valid_masks.get(key)
    if mask is None:
        if len(_valid_masks) >= 32:
            _valid_masks.clear()
        mask = torch.arange(chunk_size, device=device) < n
        _valid_masks[key] = mask
    return mask


def pad_chunk(chunk: np.ndarray, chunk_size: int, device) -> PaddedChunk:
    """Zero-pad a host chunk to ``chunk_size`` rows and move it to
    ``device`` as int64 vertex ids (the index dtype of torch's scatters;
    the reference keeps int32).  On the card the rows are staged in pinned
    memory and copied without blocking the host; the pinned allocator
    reuses a staging buffer only after its copy has completed."""
    n = chunk.shape[0]
    device = torch.device(device)
    host = torch.zeros((chunk_size, 2), dtype=torch.int64,
                       pin_memory=device.type == "cuda")
    host[:n] = torch.from_numpy(np.asarray(chunk))
    edges = host.to(device, non_blocking=True)
    return PaddedChunk(edges=edges, valid=_valid_mask(chunk_size, n, device),
                       n=n, host=chunk)
