"""2PS-L Phase 2, Step 1 — clusters -> partitions via Graham's sorted list
scheduling (LPT, a 4/3-approximation of makespan on identical machines).

A copy of the reference's host heap path (O(C log k)); it runs on the host
in both packages.  ``map_clusters_lpt_torch`` is the counterpart of the
reference's device path ``map_clusters_lpt_jax``.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from .hashing import hash_mod, hash_mod_np


def map_clusters_lpt(vol: np.ndarray, k: int, *,
                     host_of: np.ndarray | None = None,
                     init_loads: np.ndarray | None = None,
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-list-scheduling of clusters onto k partitions.

    Returns (c2p, part_volumes).  Clusters with volume <= 0 (empty / isolated
    singletons) are hashed — they carry no edges, so their mapping only has to
    be *defined*, not balanced.

    ``init_loads`` (shape (k,)) seeds the running loads: buffered
    re-streaming maps each window's clusters with the partition sizes
    accumulated so far as the starting loads, so LPT balances the whole run
    rather than each window in isolation.  ``init_loads=None`` (or all
    zeros) leaves the classic mapping bit-identical.

    ``host_of`` (shape (k,), partition -> host group) makes the mapping
    hierarchy-aware — the DCN lever of host-grouped scoring: each cluster
    first picks the least-loaded HOST (loads summed over the host's
    partitions), then the least-loaded partition within it.  Per-host
    volume balance means the cluster cores the scoring pass keeps local
    are also spread evenly across host groups, so the ``dcn_penalty``
    term starts from a layout with no oversubscribed host.  With
    ``host_of=None`` the classic flat LPT runs unchanged.
    """
    vol = np.asarray(vol)
    c2p = hash_mod_np(np.arange(len(vol), dtype=np.uint32), k)
    active = np.nonzero(vol > 0)[0]
    order = active[np.argsort(-vol[active], kind="stable")]
    init = (np.zeros(k, dtype=np.int64) if init_loads is None
            else np.asarray(init_loads, dtype=np.int64))
    if host_of is None:
        loads = [(int(init[p]), p) for p in range(k)]
        heapq.heapify(loads)
        for c in order:
            load, p = heapq.heappop(loads)
            c2p[c] = p
            heapq.heappush(loads, (load + int(vol[c]), p))
    else:
        host_of = np.asarray(host_of)
        num_hosts = int(host_of.max()) + 1 if len(host_of) else 1
        host_loads = [(int(init[host_of == h].sum()), h)
                      for h in range(num_hosts)]
        heapq.heapify(host_loads)
        part_heaps = {h: [(int(init[p]), p) for p in range(k)
                          if host_of[p] == h] for h in range(num_hosts)}
        for h in part_heaps:
            heapq.heapify(part_heaps[h])
        for c in order:
            hload, h = heapq.heappop(host_loads)
            pload, p = heapq.heappop(part_heaps[h])
            c2p[c] = p
            heapq.heappush(part_heaps[h], (pload + int(vol[c]), p))
            heapq.heappush(host_loads, (hload + int(vol[c]), h))
    part_vol = np.zeros(k, dtype=np.int64)
    np.add.at(part_vol, c2p[active], vol[active])
    return c2p.astype(np.int32), part_vol


def map_clusters_lpt_torch(vol: torch.Tensor, k: int):
    """Device LPT, the counterpart of the reference's
    ``map_clusters_lpt_jax``: a loop over the volume-sorted clusters, each
    taking the argmin of the running loads (lowest index on ties, like the
    heap), on ``vol``'s device.  O(C*k) work; clusters with volume <= 0 are
    hashed.  Returns ``(c2p, loads)`` as int32 tensors."""
    C = vol.shape[0]
    dev = vol.device
    order = torch.argsort(-vol, stable=True)
    vs = vol[order]
    take = vs > 0
    w = torch.where(take, vs, 0).to(torch.int32)
    loads = torch.zeros((k,), dtype=torch.int32, device=dev)
    picks = []
    for i in range(C):
        p = torch.argmin(loads)            # lowest index wins ties
        loads.index_add_(0, p.view(1), w[i].view(1))   # adds 0 if not taken
        picks.append(p)
    pick = (torch.stack(picks).to(torch.int32) if C
            else torch.zeros((0,), dtype=torch.int32, device=dev))
    c2p = torch.zeros((C,), dtype=torch.int32, device=dev)
    c2p[order] = torch.where(take, pick, -1)
    fallback = hash_mod(torch.arange(C, device=dev), k)
    return torch.where(c2p < 0, fallback, c2p), loads
