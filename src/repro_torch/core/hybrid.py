"""HEP-style hybrid partitioner (arXiv:2103.12594), in torch.

Almost all replication-state value concentrates in the few high-degree
vertices of a power-law graph, so only their state is pinned:

* the upfront degree pass ranks vertices by degree;
* the top ``memory_budget_bytes // row_bytes`` vertices get a pinned row in
  a compact packed bit matrix ``hbits`` (``row_bytes = ceil(k/32) * 4``);
* per chunk, edges with a pinned ("hot") endpoint are scored over all k
  partitions by NE-style replica affinity; edges between two cold vertices
  fall back to DBH's hash of the lower-degree endpoint;
* every choice then runs the shared admission tail
  (``_admit_with_fallback``), so the hard balance cap holds exactly.

The full V x k replication matrix exists only on the host, folded in the
pipeline's writeback stage for the end-of-run quality metrics; scoring
never reads it.  ``replication_state_bytes`` reports the pinned rows, which
the ``engine.replication_state_bytes`` gauge then shows.

The chunk function is plain torch on the run's device: the reference's
``_hep_chunk`` reaches no Pallas kernel, so no kernel of the port runs.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitops, partitioning as P
from .engine import (StreamingPartitioner, StreamPass,
                     compute_degrees_streaming)
from .metrics import capacity


def _hep_chunk(hbits, sizes, d, slot, edges, valid, *, k, cap):
    """Score one chunk against the pinned hot-vertex rows.

    ``slot`` maps vertex -> pinned row (-1 when cold).  A hot endpoint adds
    the affinity ``2 - deg/(deg_u + deg_v)`` (the jitted form of ``1 + (1 -
    θ)``) to every partition where it already replicates; edges with no
    hot replica anywhere take the DBH hash.  Admission and overflow run the
    shared capacity tail, and the chunk's assignments fold into the pinned
    rows (cold vertices have none).  ``hbits`` and ``sizes`` are updated in
    place.  Returns ``(hbits, sizes, assignment)``."""
    u, v = edges[:, 0], edges[:, 1]
    su, sv = slot[u], slot[v]
    hot_u, hot_v = su >= 0, sv >= 0
    du, dv = d[u], d[v]
    parts = torch.arange(k, device=edges.device)[None, :]
    rep_u = hot_u[:, None] & bitops.get(hbits, su.clamp_min(0)[:, None],
                                        parts)
    rep_v = hot_v[:, None] & bitops.get(hbits, sv.clamp_min(0)[:, None],
                                        parts)
    dsum = (du + dv).to(torch.float32).clamp_min(1.0)[:, None]
    aff_u = torch.where(rep_u, 2.0 - du.to(torch.float32)[:, None] / dsum,
                        0.0)
    aff_v = torch.where(rep_v, 2.0 - dv.to(torch.float32)[:, None] / dsum,
                        0.0)
    scores = aff_u + aff_v
    smax, best = torch.max(scores, dim=1)       # first maximum on ties
    # cold-cold edges (and hot edges with no replica yet) hash like DBH
    fallback = P._lower_degree_hash(u, v, du, dv, k)
    chosen = torch.where(smax > 0.0, best.to(torch.int32), fallback)

    hi = torch.where(du >= dv, u, v)
    assignment, sizes = P._admit_with_fallback(sizes, chosen, valid, hi, k,
                                               cap)

    ss = torch.cat([su, sv])
    pp = assignment.repeat(2)
    mm = torch.cat([hot_u, hot_v]) & (pp >= 0)
    bitops.set_(hbits, ss.clamp_min(0), pp.clamp_min(0), mask=mm)
    return hbits, sizes, assignment


class _HEPPartitioner(StreamingPartitioner):
    """HEP: one pass of ``_hep_chunk`` with the pinned rows, sizes, degrees
    and the slot map on the device and the metrics matrix on the host."""

    def _setup_run(self, stream, k):
        self.k = k
        self.cap = capacity(stream.num_edges, k, self.spec.alpha)
        self._init_hierarchy(k)
        row_bytes = bitops.num_words(k) * np.dtype(np.uint32).itemsize
        self._n_hot = int(min(stream.num_vertices,
                              self.spec.memory_budget_bytes // row_bytes))
        self._row_bytes = row_bytes

    def init_state(self, stream, k, timer, degrees):
        sp, dev = self.spec, self.device
        self._setup_run(stream, k)
        if degrees is None:
            degrees = compute_degrees_streaming(
                stream, sp.chunk_size, device=dev,
                readahead=sp.pipeline_depth - 1)
        timer.lap("degrees")
        order = np.argsort(-np.asarray(degrees), kind="stable")
        slot = np.full(stream.num_vertices, -1, np.int32)
        slot[order[:self._n_hot]] = np.arange(self._n_hot, dtype=np.int32)
        # metrics-only full matrix, host-folded off the critical path
        self._bits_np = bitops.alloc_np(stream.num_vertices, k)
        return {
            # >= 1 row so the shape is valid at budget 0; the dummy row is
            # never read (no slot points at it)
            "hbits": torch.zeros((max(self._n_hot, 1), bitops.num_words(k)),
                                 dtype=torch.int32, device=dev),
            "sizes": torch.zeros((k,), dtype=torch.int32, device=dev),
            "d": torch.from_numpy(np.asarray(degrees, np.int32)).to(dev),
            "slot": torch.from_numpy(slot).to(dev),
        }

    def passes(self):
        return [StreamPass("hybrid", self._chunk,
                           host_fold=self._fold_bits_host)]

    def _chunk(self, st, pc):
        *_, asg = _hep_chunk(st["hbits"], st["sizes"], st["d"], st["slot"],
                             pc.edges, pc.valid, k=self.k, cap=self.cap)
        return st, asg

    def _fold_bits_host(self, chunk, asg):
        m = asg >= 0
        p = asg[m]
        bitops.set_np(self._bits_np, chunk[m, 0], p)
        bitops.set_np(self._bits_np, chunk[m, 1], p)

    def finalize(self, state, pass_counts):
        extras = {
            "hot_vertices": self._n_hot,
            "hot_state_bytes": self._n_hot * self._row_bytes,
            "memory_budget_bytes": self.spec.memory_budget_bytes,
        }
        return self._bits_np, state["sizes"].cpu().numpy(), extras

    def replication_state_bytes(self):
        # the pinned rows are the only state scoring reads: what
        # memory_budget_bytes bounds (the host matrix is a metrics oracle)
        return self._n_hot * self._row_bytes

    # -- checkpoint / resume --------------------------------------------
    def host_state(self):
        return {"bits": self._bits_np}

    def restore_host_state(self, arrays):
        self._bits_np = np.ascontiguousarray(arrays["bits"])

    def init_for_resume(self, stream, k, timer):
        # degrees and the hot-slot map live in the device state; n_hot is a
        # pure function of (budget, k, |V|) — no stream sweep needed
        self._setup_run(stream, k)
