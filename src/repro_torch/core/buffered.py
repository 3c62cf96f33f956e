"""Buffered re-streaming partitioner (arXiv:2402.11980-style), in torch.

Buffered streaming trades a bounded edge buffer for quality: accumulate a
window of ``buffer_edges`` edges, build the window's mini-graph in memory,
and only then assign the batch, so every decision inside the window sees
the window's whole structure.  Each window is 2PS-L in miniature:

* the window's vertex ids are compacted (``np.unique``) and its undirected
  adjacency built with ``repro_torch.sample.local_graph.build_adjacency``;
  a volume-capped BFS from high-degree seeds clusters the mini-graph
  (``window_clusters``, on the host);
* window clusters map onto partitions by replica affinity against the
  global bit matrix under a slot-capacity guard (``map_window_clusters``):
  later windows re-place recurring vertices where their replicas live;
* window edges are reordered cluster by cluster (descending volume), and
  the batch then runs 2PS-L's two phases over sequential sub-batches of at
  most ``SUB_BATCH_TARGET`` edges: pre-partitioning, folding replicas after
  every sub-batch, then two-candidate scoring against state that holds the
  whole window's pre-partitioning.  The shared admission tail keeps the
  hard alpha cap exact.

The engine regroups the stream into windows of ``window_chunks *
chunk_size`` edges (``StreamPass.window``).  The reference's two
``lax.scan``s are Python loops here: on the card each scoring sub-batch is
one ``edge_score_choose_bits`` launch (``_twopsl_choose``), and sub-batches
that hold only padding are skipped, so a window of ``n`` edges launches
``ceil(n / sub)`` kernels.
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from . import bitops, partitioning as P
from .convert import words_to_numpy
from .engine import (StreamingPartitioner, StreamPass,
                     compute_degrees_streaming)
from .metrics import capacity

#: target edges per sequential sub-batch inside a window — small enough
#: that later sub-batches see earlier replicas, large enough to stay
#: vectorized
SUB_BATCH_TARGET = 1024


class WindowClustering(NamedTuple):
    """One window's mini-graph clustering (all aligned with ``uniq``)."""
    uniq: np.ndarray      # (n_local,) sorted global vertex ids
    labels: np.ndarray    # (n_local,) vertex -> cluster label
    vols: np.ndarray      # (C,) cluster volume (sum of mini-graph degrees)
    deg: np.ndarray       # (n_local,) mini-graph degree
    elabels: np.ndarray   # (n_edges, 2) per-edge endpoint cluster labels


def window_clusters(edges: np.ndarray, *, k: int,
                    max_vol_factor: float = 1.0) -> WindowClustering:
    """Cluster one buffered window's mini-graph (a copy of the reference's
    numpy function).

    Compacts the window's vertex ids, builds the undirected adjacency
    (both orientations through ``build_adjacency``), and grows
    volume-capped clusters by BFS from seeds in descending mini-graph
    degree — deterministic (stable sorts, stream-order adjacency).  The
    volume cap mirrors 2PS-L's ``default_max_vol``: ``max_vol_factor *
    2|E_w| / k`` over the window's own edge count.
    """
    from ..sample.local_graph import build_adjacency

    edges = np.asarray(edges)
    uniq, inv = np.unique(edges.reshape(-1), return_inverse=True)
    inv = inv.reshape(-1, 2)
    n_local = len(uniq)
    mini = inv.astype(np.int64)
    und = np.concatenate([mini, mini[:, ::-1]], axis=0)
    indptr, order = build_adjacency(und, n_local, by="src")
    nbr = und[order, 1]
    deg = (indptr[1:] - indptr[:-1]).astype(np.int64)
    max_vol = max(int(max_vol_factor * 2.0 * len(edges) / max(k, 1)), 1)

    labels = np.full(n_local, -1, np.int64)
    vols: list[int] = []
    for s in np.argsort(-deg, kind="stable"):
        if labels[s] >= 0:
            continue
        c = len(vols)
        labels[s] = c
        vol = int(deg[s])
        q = deque([int(s)])
        while q and vol < max_vol:
            x = q.popleft()
            for y in nbr[indptr[x]:indptr[x + 1]]:
                if labels[y] < 0 and vol + int(deg[y]) <= max_vol:
                    labels[y] = c
                    vol += int(deg[y])
                    q.append(int(y))
        vols.append(vol)
    labels = labels.astype(np.int32)
    return WindowClustering(uniq=uniq.astype(np.int64), labels=labels,
                            vols=np.asarray(vols, np.int64), deg=deg,
                            elabels=labels[inv])


def map_window_clusters(affinity: np.ndarray, vols: np.ndarray, k: int, *,
                        init_loads: np.ndarray,
                        cap_slots: int) -> np.ndarray:
    """Replica-affinity-aware cluster -> partition mapping (a copy of the
    reference's numpy function).

    Clusters are visited in descending volume (LPT order); each takes the
    partition with the highest ``affinity[c, p]`` among those whose
    running endpoint-slot load stays under ``cap_slots`` (ties: lighter
    load, then lower id).  A cluster that fits nowhere falls back to the
    least-loaded partition; the per-edge capacity admission still enforces
    the hard alpha cap.  With all-zero affinity (the first window) this is
    classic LPT.
    """
    num_c = len(vols)
    c2p = np.zeros(num_c, np.int32)
    loads = np.asarray(init_loads, np.int64).copy()
    pids = np.arange(k)
    for c in np.argsort(-np.asarray(vols), kind="stable"):
        fits = loads + vols[c] <= cap_slots
        cand = pids[fits] if fits.any() else pids
        a = affinity[c]
        # primary: max affinity; then min load; then lowest partition id
        best = cand[np.lexsort((cand, loads[cand], -a[cand]))[0]]
        c2p[c] = best
        loads[best] += int(vols[c])
    return c2p


def _buffered_window(bits, sizes, d, v2c, c2p, vol, edges, valid, scatter,
                     *, n, k, cap, sub, eff):
    """Assign one whole window: 2PS-L's two phases as sequential sub-batch
    loops, then scatter the assignments back to stream order.

    ``edges``/``valid`` arrive cluster-ordered and padded to a multiple of
    ``sub``; ``scatter[:n]`` maps each live row to its stream position in
    the (eff,) output.  Phase 1 pre-partitions cluster-coherent edges,
    folding replicas after every sub-batch; phase 2's two-candidate scoring
    (one ``edge_score_choose_bits`` call per sub-batch) then sees the
    replica state of the whole window's pre-partitioning.  Only the first
    ``ceil(n / sub)`` sub-batches hold live rows; the rest change nothing
    and are skipped.  ``bits`` and ``sizes`` are updated in place.  Returns
    ``(bits, sizes, (eff,) assignment)``."""
    S = edges.shape[0] // sub
    steps = -(-n // sub)
    e_s = edges.view(S, sub, 2)
    m_s = valid.view(S, sub)
    pre = []
    for i in range(steps):
        sizes, asg1, _ = P._prepartition_core(sizes, d, v2c, c2p, e_s[i],
                                              m_s[i], k=k, cap=cap)
        P._apply_bits(bits, e_s[i], asg1)
        pre.append(asg1)
    rows = []
    for i in range(steps):
        todo, chosen, hi = P._twopsl_choose(bits, d, vol, v2c, c2p, e_s[i],
                                            m_s[i])
        asg2, sizes = P._admit_with_fallback(sizes, chosen, todo, hi, k, cap)
        P._apply_bits(bits, e_s[i], asg2)
        rows.append(torch.where(pre[i] >= 0, pre[i], asg2))
    out = torch.full((eff,), -1, dtype=torch.int32, device=edges.device)
    if n:
        out[scatter[:n]] = torch.cat(rows)[:n]
    return bits, sizes, out


class _BufferedPartitioner(StreamingPartitioner):
    """Buffered re-streaming: one windowed pass with the global bit matrix,
    sizes, degrees and the window tables on the device."""

    def __init__(self, spec, device):
        super().__init__(spec, device)
        self.window = spec.window_chunks

    def _setup_run(self, stream, k):
        self.k = k
        self.cap = capacity(stream.num_edges, k, self.spec.alpha)
        self._init_hierarchy(k)
        self._eff = self.spec.chunk_size * self.window
        # fixed table padding: a window of W edges touches <= 2W vertices,
        # hence <= 2W clusters
        self._cpad = 2 * self._eff
        # sub-batch geometry: S sequential sub-batches of `sub` edges
        self._subs = max(1, -(-self._eff // SUB_BATCH_TARGET))
        self._sub = -(-self._eff // self._subs)
        self._windows = 0

    def init_state(self, stream, k, timer, degrees):
        sp, dev = self.spec, self.device
        self._setup_run(stream, k)
        if degrees is None:
            degrees = compute_degrees_streaming(
                stream, sp.chunk_size, device=dev,
                readahead=sp.pipeline_depth - 1)
        timer.lap("degrees")
        V = stream.num_vertices

        def zeros(n):
            return torch.zeros((n,), dtype=torch.int32, device=dev)
        return {
            "bits": torch.zeros((V, bitops.num_words(k)), dtype=torch.int32,
                                device=dev),
            "sizes": zeros(k),
            "d": torch.from_numpy(np.asarray(degrees, np.int32)).to(dev),
            # window tables, rewritten before every window reads them
            "wv2c": zeros(V), "wc2p": zeros(self._cpad),
            "wvol": zeros(self._cpad),
        }

    def passes(self):
        return [StreamPass("buffered", self._window_fn, window=self.window)]

    def _window_fn(self, st, pc):
        sp, dev = self.spec, self.device
        n = pc.n
        e = np.ascontiguousarray(pc.host[:n])
        wc = window_clusters(e, k=self.k, max_vol_factor=sp.max_vol_factor)

        # degree-weighted replica affinity of each window cluster with each
        # partition: the window vertices' rows of the global bit matrix come
        # to the host once (O(window) bytes, never O(V))
        uniq = torch.from_numpy(wc.uniq).to(dev)
        rows = words_to_numpy(st["bits"].index_select(0, uniq))
        rep = bitops.get_np(rows, np.arange(len(wc.uniq))[:, None],
                            np.arange(self.k)[None, :])
        aff = np.zeros((len(wc.vols), self.k), np.int64)
        np.add.at(aff, wc.labels, rep * wc.deg[:, None])
        # seed loads with the run's sizes so far (x2: volume counts endpoint
        # slots, sizes count edges); the slot cap keeps the affinity chase
        # from oversubscribing any partition
        sizes_np = st["sizes"].cpu().numpy().astype(np.int64)
        cap_slots = int(sp.alpha * 2.0
                        * (int(sizes_np.sum()) + n) / self.k) + 1
        c2p = map_window_clusters(aff, wc.vols, self.k,
                                  init_loads=2 * sizes_np,
                                  cap_slots=cap_slots)

        # cluster-coherent processing order: edges by their dominant
        # (larger-volume) cluster, big clusters first
        cu, cv = wc.elabels[:, 0], wc.elabels[:, 1]
        dom = np.where(wc.vols[cu] >= wc.vols[cv], cu, cv)
        crank = np.empty(len(wc.vols), np.int64)
        crank[np.argsort(-wc.vols, kind="stable")] = np.arange(len(wc.vols))
        order = np.argsort(crank[dom], kind="stable")

        padded = self._subs * self._sub
        e_ord = np.zeros((padded, 2), np.int64)
        e_ord[:n] = e[order]
        c2p_pad = np.zeros(self._cpad, np.int32)
        c2p_pad[:len(c2p)] = c2p
        vol_pad = np.zeros(self._cpad, np.int32)
        vol_pad[:len(wc.vols)] = np.minimum(wc.vols, np.iinfo(np.int32).max)

        # only the window's own vertices are written (the reference drops
        # its padding rows through an out-of-range sentinel)
        wv2c = st["wv2c"]
        wv2c[uniq] = torch.from_numpy(wc.labels).to(dev)
        wc2p = torch.from_numpy(c2p_pad).to(dev)
        wvol = torch.from_numpy(vol_pad).to(dev)
        bits, sizes, asg = _buffered_window(
            st["bits"], st["sizes"], st["d"], wv2c, wc2p, wvol,
            torch.from_numpy(e_ord).to(dev),
            P._valid_mask(padded, n, dev), torch.from_numpy(order).to(dev),
            n=n, k=self.k, cap=self.cap, sub=self._sub, eff=self._eff)
        self._windows += 1
        return {**st, "bits": bits, "sizes": sizes, "wv2c": wv2c,
                "wc2p": wc2p, "wvol": wvol}, asg

    def finalize(self, state, pass_counts):
        extras = {
            "buffer_edges": self._eff,
            "window_chunks": self.window,
            "windows": self._windows,
        }
        return (words_to_numpy(state["bits"]), state["sizes"].cpu().numpy(),
                extras)

    # -- checkpoint / resume --------------------------------------------
    # everything lives in the device state (the window tables included:
    # the next window rewrites the rows it reads); the window geometry
    # re-derives from the spec, so resume needs no stream sweep at all
    def init_for_resume(self, stream, k, timer):
        self._setup_run(stream, k)
