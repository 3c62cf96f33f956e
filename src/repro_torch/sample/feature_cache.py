"""Degree-ordered hot-vertex feature cache (static top-N + LRU overlay): a
copy of the reference package's ``sample/feature_cache.py`` (numpy only).

HEP's skew lever (arXiv 2103.12594) applied at serving time: real graph
traffic is power-law, so a small byte budget pinned to the highest
in-degree vertices absorbs most remote-feature reads — those are exactly
the vertices the sampler's frontier keeps landing on.  The budget is
split between a **static** tier (top-N by global in-degree, computed
once from the local CSC structures, never evicted) and an **LRU
overlay** for the request-dependent tail.

The cache is a pure latency/traffic optimization: ``get`` returns rows
bit-identical to ``fetch_fn`` (values are copied in and out, never
transformed), so a cached serve path produces exactly the logits of an
uncached one.  Hits/misses/evictions land in the ``repro_torch.obs`` metrics
registry (``sample.cache.*``).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .. import obs


class HotVertexFeatureCache:
    """Byte-budgeted feature cache in front of a remote fetch function.

    Parameters
    ----------
    fetch_fn : callable ``(global_ids: int64[n]) -> float[n, feat_dim]``
        The miss path — e.g. a gather from another partition's feature
        shard (in production, a cross-host RPC; the bytes it would move
        are what the hit rate saves).
    feat_dim, dtype : row shape; with ``byte_budget`` they fix capacity
        ``capacity = byte_budget // (feat_dim * dtype.itemsize)`` rows.
    degrees : optional global in-degree array (``PartitionedGraph.degrees()``);
        when given, ``static_fraction`` of the capacity is pinned to the
        top-degree vertices up front (features fetched once at build).
    """

    def __init__(self, fetch_fn, feat_dim: int, *, byte_budget: int,
                 dtype=np.float32, degrees: np.ndarray | None = None,
                 static_fraction: float = 0.5):
        self.fetch_fn = fetch_fn
        self.feat_dim = int(feat_dim)
        self.dtype = np.dtype(dtype)
        self.row_bytes = self.feat_dim * self.dtype.itemsize
        self.capacity = max(0, int(byte_budget) // self.row_bytes)
        if not (0.0 <= static_fraction <= 1.0):
            raise ValueError(f"static_fraction must be in [0, 1], got "
                             f"{static_fraction}")
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._static: dict[int, np.ndarray] = {}
        self._lru: OrderedDict[int, np.ndarray] = OrderedDict()
        self._reg = obs.get_registry()

        n_static = 0
        if degrees is not None and self.capacity > 0:
            n_static = min(int(self.capacity * static_fraction),
                           len(degrees))
        if n_static > 0:
            hot = np.argsort(np.asarray(degrees), kind="stable")[::-1]
            hot = np.sort(hot[:n_static].astype(np.int64))
            rows = np.asarray(fetch_fn(hot), self.dtype)
            for g, row in zip(hot.tolist(), rows):
                self._static[g] = row.copy()
        self.static_size = len(self._static)
        self.lru_capacity = self.capacity - self.static_size

    def __contains__(self, gid: int) -> bool:
        return gid in self._static or gid in self._lru

    def get(self, gids: np.ndarray) -> np.ndarray:
        """Rows for ``gids`` (bit-identical to ``fetch_fn(gids)``)."""
        gids = np.asarray(gids, np.int64).reshape(-1)
        out = np.empty((len(gids), self.feat_dim), self.dtype)
        miss_idx = []
        for i, g in enumerate(gids.tolist()):
            row = self._static.get(g)
            if row is None:
                row = self._lru.get(g)
                if row is not None:
                    self._lru.move_to_end(g)
            if row is None:
                miss_idx.append(i)
            else:
                out[i] = row
                self.hits += 1
        if miss_idx:
            self.misses += len(miss_idx)
            idx = np.asarray(miss_idx, np.int64)
            rows = np.asarray(self.fetch_fn(gids[idx]), self.dtype)
            out[idx] = rows
            for g, row in zip(gids[idx].tolist(), rows):
                self._admit(g, row)
        self._reg.counter("sample.cache.hits").inc(len(gids) - len(miss_idx))
        self._reg.counter("sample.cache.misses").inc(len(miss_idx))
        return out

    def _admit(self, gid: int, row: np.ndarray) -> None:
        if self.lru_capacity <= 0 or gid in self._static:
            return
        if gid in self._lru:
            self._lru.move_to_end(gid)
            return
        if len(self._lru) >= self.lru_capacity:
            self._lru.popitem(last=False)
            self.evictions += 1
            self._reg.counter("sample.cache.evictions").inc()
        self._lru[gid] = row.copy()

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hits / total if total else 0.0,
            "capacity_rows": self.capacity,
            "static_rows": self.static_size,
            "lru_rows": len(self._lru),
            "byte_budget_used": (self.static_size + len(self._lru))
            * self.row_bytes,
        }
