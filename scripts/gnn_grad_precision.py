#!/usr/bin/env python
"""How far float32 rounding alone moves the GNN models' gradients, leaf by
leaf, at ``gnn_models``' cells (GatedGCN and EGNN on ``full_graph_sm``,
NequIP on ``molecule``; the weights and batch ``chip_smoke.py`` checks).

Each reading is a leaf's largest difference as a share of its scale (its
largest magnitude, floored at 1e-2 of the tree's largest: the scale of
``chip_smoke.py``'s gate).  One JSON line per model:

* ``reorder_float32``: ``segment_sum``'s additions in another (seeded,
  random) order against the given order, the model in float32;
* ``reorder_float64``: the same with the model in float64 (the segment
  sums still add in float32);
* ``float32_vs_float64``: the float32 gradient against the float64.

``chip_smoke.py``'s ``gnn_train`` reads the card against the CPU.

    PYTHONPATH=src python scripts/gnn_grad_precision.py
"""
from __future__ import annotations

import json

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.data.gnn_batches import full_graph_batch, molecule_batch
from repro_torch.launch import steps as S
from repro_torch.models import gnn as G
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.training import value_and_grad

TOL = 1e-4


def cases():
    sm, mol = GNN_SHAPES["full_graph_sm"], GNN_SHAPES["molecule"]
    graph = full_graph_batch(sm["n_nodes"], sm["n_edges"], sm["d_feat"],
                             seed=0, with_coords=True)
    for arch in ("gatedgcn", "egnn"):
        cfg = get_arch(arch).config_for_shape("full_graph_sm")
        yield arch, cfg, {**graph, "labels": (graph["labels"]
                                              % cfg.n_classes)
                          .astype(np.int32)}, 1, "full"
    cfg = get_arch("nequip").config_for_shape("molecule")
    batch, n_graphs = molecule_batch(mol["batch"], mol["n_nodes"],
                                     mol["n_edges"],
                                     n_species=cfg.n_species, seed=0)
    yield "nequip", cfg, batch, n_graphs, "molecule"


def reordered_segment_sum(data, prep, n):
    """``G.segment_sum`` with its additions in a seeded random order."""
    flat = data.reshape(data.shape[0], -1)
    order = torch.randperm(flat.shape[0],
                           generator=torch.Generator().manual_seed(1))
    out = torch.zeros((prep.num_nodes, flat.shape[1]), dtype=torch.float32)
    out.index_add_(0, prep.dst()[order], flat.float()[order])
    return out[:n].reshape((n,) + tuple(data.shape[1:])).to(data.dtype)


def shares(got, want) -> list:
    top = max(float(w.abs().max()) for w in want if w.numel())
    return [float((g.double() - w.double()).abs().max())
            / max(float(w.abs().max()), 1e-2 * top, 1e-30)
            if w.numel() else 0.0 for g, w in zip(got, want)]


def summary(s: list) -> dict:
    worst = sorted(range(len(s)), key=lambda i: -s[i])[:5]
    return {"max": max(s), "leaves_over_1e-4": sum(x > TOL for x in s),
            "worst": [[i, s[i]] for i in worst]}


def main() -> None:
    for arch, cfg, batch, n_graphs, kind in cases():
        params = S.init_params("gnn", cfg, torch.Generator().manual_seed(0))
        loss_fn = S.gnn_loss_fn(cfg, kind, n_graphs)
        b32 = {k: torch.from_numpy(v) for k, v in batch.items()
               if v is not None}
        p64 = tree_map(lambda p: p.double(), params)
        b64 = {k: v.double() if v.is_floating_point() else v
               for k, v in b32.items()}

        def grads(p, b):
            return tree_leaves(value_and_grad(loss_fn, p, b)[1])
        g32, g64 = grads(params, b32), grads(p64, b64)
        given = G.segment_sum
        G.segment_sum = reordered_segment_sum
        try:
            r32, r64 = grads(params, b32), grads(p64, b64)
        finally:
            G.segment_sum = given
        line = {"arch": arch, "leaves": len(g32),
                "reorder_float32": summary(shares(r32, g32)),
                "reorder_float64": summary(shares(r64, g64)),
                "float32_vs_float64": summary(shares(g32, g64))}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
