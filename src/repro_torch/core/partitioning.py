"""2PS-L Phase 2 — streaming partitioning (paper Algorithm 2), in torch.

Bulk-synchronous chunked implementation of the three steps:

  Step 1  clusters -> partitions  (mapping.py, Graham LPT)
  Step 2  pre-partitioning        (_prepartition_core)
  Step 3  linear 2-candidate scoring for remaining edges (_score_chunk)

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
from .hashing import hash_mod
# the module, not the function: the kernel package imports this package's
# scoring module, so either may be imported first
from ..kernels.edge_score import ops as edge_score_ops


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
    assigned = assignment >= 0
    vv = torch.cat([edges[:, 0], edges[:, 1]])
    pp = torch.cat([assignment, assignment]).clamp_min(0)
    mm = torch.cat([assigned, assigned])
    return bitops.set_(bits, vv, pp, mask=mm)


def _apply_host_bits(hbits, edges, assignment, host_of):
    """Fold the per-HOST replica matrix: the same OR as ``_apply_bits`` but
    with the assignment mapped through ``host_of`` (partition -> host)."""
    hasg = torch.where(assignment >= 0, host_of[assignment.clamp_min(0)], -1)
    return _apply_bits(hbits, edges, hasg)


def _admit_with_fallback(sizes, chosen, todo, du, dv, u, v, k, cap):
    """The paper's shared admission tail: capacity-ranked admission of the
    chosen partition, then the overflow chain (max-degree hash ->
    least-loaded last resort, Alg. 2 line 22-23 + prose).  Returns
    ``(assignment, sizes)`` with every ``todo`` edge placed."""
    ok, sizes = _ranked_admit(chosen, todo, sizes, cap, k)
    assignment = torch.where(ok, chosen, -1).to(torch.int32)

    over = todo & ~ok
    hi = torch.where(du >= dv, u, v)
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

    assignment, sizes = _admit_with_fallback(sizes, pu, eligible,
                                             d[u], d[v], u, v, k, cap)
    remaining = valid & ~eligible
    return sizes, assignment, remaining


# ---------------------------------------------------------------------------
# Step 3: linear-time 2-candidate scoring
# ---------------------------------------------------------------------------

def _twopsl_choose(bits, d, vol, v2c, c2p, edges, valid, *,
                   hbits=None, host_of=None, dcn_penalty: float = 0.0):
    """The paper's two-candidate chooser, shared by the flat and the
    host-aware scoring chunks: gather per-edge operands, score the two
    cluster partitions with ``edge_score_choose`` (the CUDA kernel on the
    card, its plain version on the CPU), pick the better.

    Returns ``(todo, chosen, du, dv, u, v)`` for the admission tail."""
    u, v = edges[:, 0], edges[:, 1]
    cu, cv = v2c[u], v2c[v]
    pu, pv = c2p[cu], c2p[cv]
    skip = (cu == cv) | (pu == pv)        # pre-partitioned in step 2
    todo = valid & ~skip

    du, dv = d[u], d[v]
    host_kw = {}
    if dcn_penalty:
        hu, hv = host_of[pu], host_of[pv]
        host_kw = dict(hrep_u1=bitops.get(hbits, u, hu),
                       hrep_v1=bitops.get(hbits, v, hu),
                       hrep_u2=bitops.get(hbits, u, hv),
                       hrep_v2=bitops.get(hbits, v, hv),
                       dcn_penalty=dcn_penalty)
    chosen, _ = edge_score_ops.edge_score_choose(
        du, dv, vol[cu], vol[cv],
        bitops.get(bits, u, pu), bitops.get(bits, v, pu),
        bitops.get(bits, u, pv), bitops.get(bits, v, pv),
        pu, pv, **host_kw)
    return todo, chosen, du, dv, u, v


def _score_chunk(bits, sizes, d, vol, v2c, c2p, edges, valid, *, k, cap):
    """Score each *remaining* edge against exactly two candidate partitions
    (the partitions of its endpoints' clusters) — the paper's O(|E|) claim.
    ``bits`` and ``sizes`` are updated in place.  Returns ``(bits, sizes,
    assignment)``."""
    todo, chosen, du, dv, u, v = _twopsl_choose(
        bits, d, vol, v2c, c2p, edges, valid)
    assignment, sizes = _admit_with_fallback(sizes, chosen, todo,
                                             du, dv, u, v, k, cap)
    _apply_bits(bits, edges, assignment)
    return bits, sizes, assignment


def _score_chunk_hosted(bits, hbits, sizes, d, vol, v2c, c2p, host_of,
                        edges, valid, *, k, cap, dcn_penalty: float):
    """Host-aware 2PS-L scoring: ``_score_chunk`` plus the DCN locality
    term read from the O(|V|*H)-bit per-HOST replica matrix ``hbits``.
    ``bits``, ``hbits`` and ``sizes`` are updated in place.  Returns
    ``(bits, hbits, sizes, assignment)``."""
    todo, chosen, du, dv, u, v = _twopsl_choose(
        bits, d, vol, v2c, c2p, edges, valid,
        hbits=hbits, host_of=host_of, dcn_penalty=dcn_penalty)
    assignment, sizes = _admit_with_fallback(sizes, chosen, todo,
                                             du, dv, u, v, k, cap)
    _apply_bits(bits, edges, assignment)
    _apply_host_bits(hbits, edges, assignment, host_of)
    return bits, hbits, sizes, assignment


# ---------------------------------------------------------------------------
# chunk padding helper shared by the engine and the clustering pass
# ---------------------------------------------------------------------------

@dataclass
class PaddedChunk:
    edges: torch.Tensor     # (chunk_size, 2) int64 on the run's device
    valid: torch.Tensor     # (chunk_size,) bool
    n: int


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
                       n=n)
