"""Synthetic recsys interaction pipeline: popularity-skewed item catalog,
per-user taste clusters (so CTR is learnable), fixed-shape batches."""
from __future__ import annotations

import numpy as np


class InteractionStream:
    def __init__(self, n_items: int, batch: int, seq_len: int,
                 n_clusters: int = 32, seed: int = 0):
        self.n_items = n_items
        self.batch = batch
        self.seq_len = seq_len
        self.n_clusters = n_clusters
        self.rng = np.random.default_rng(seed)
        self.item_cluster = self.rng.integers(0, n_clusters, n_items)

    def next_batch(self):
        B, T = self.batch, self.seq_len
        rng = self.rng
        user_cluster = rng.integers(0, self.n_clusters, B)
        # history: mostly items from the user's cluster
        hist = rng.integers(0, self.n_items, (B, T))
        in_cluster = rng.random((B, T)) < 0.7
        cluster_items = rng.integers(0, self.n_items, (B, T))
        match = self.item_cluster[cluster_items] == user_cluster[:, None]
        hist = np.where(in_cluster & match, cluster_items, hist)
        lengths = rng.integers(T // 2, T + 1, B)
        mask = (np.arange(T)[None, :] < lengths[:, None])
        target = rng.integers(0, self.n_items, B)
        label = (self.item_cluster[target] == user_cluster).astype(np.int32)
        # add noise to labels
        flip = rng.random(B) < 0.1
        label = np.where(flip, 1 - label, label)
        return {"hist": hist.astype(np.int32),
                "hist_mask": mask.astype(np.float32),
                "target": target.astype(np.int32),
                "label": label.astype(np.int32)}

    def __iter__(self):
        while True:
            yield self.next_batch()
