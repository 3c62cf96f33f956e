"""ArchSpec: the contract every ported architecture implements, the port's
counterpart of ``repro.configs.base``.

Each arch module registers:
  full()        — the exact published configuration
  smoke()       — reduced same-family config for CPU smoke tests
  shapes        — the arch's own input-shape set (dry-run cells)
  input_specs() — each shape's inputs as meta tensors (no allocation)

``config_for_shape`` adjusts the full config to a shape (a GNN's input
width follows the dataset's ``d_feat``).  ``input_specs`` is the
counterpart of the reference's (jax ``ShapeDtypeStruct`` stand-ins): the
same tree, every leaf a meta tensor of the same shape and dtype (a decode
cell's cache from ``models.transformer.cache_abstract``), for the dry run
and for the sharded steps' tests.
LM shape kinds: train, prefill (forward), decode (a KV cache of seq_len).
GNN kinds: full (full-batch), sampled (fan-out sampled subgraph),
molecule (padded molecule batch).  Recsys kinds: train / serve /
retrieval.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

ARCHS: dict[str, "ArchSpec"] = {}

I32 = torch.int32
F32 = torch.float32


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype`` (the reference's
    ``ShapeDtypeStruct``)."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


@dataclass
class ArchSpec:
    arch_id: str
    family: str                       # lm | gnn | recsys
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict[str, dict]
    notes: str = ""

    def config_for_shape(self, shape_name: str):
        """Full config adjusted to the shape (GNN input width follows the
        dataset's d_feat; everything else is shape-independent)."""
        cfg = self.make_config()
        sh = self.shapes[shape_name]
        if self.family == "gnn" and hasattr(cfg, "d_in") and "d_feat" in sh:
            cfg = dataclasses.replace(cfg, d_in=sh["d_feat"])
        return cfg

    def input_specs(self, shape_name: str, cfg=None):
        """The shape's inputs as meta tensors, the reference's tree."""
        cfg = cfg or self.config_for_shape(shape_name)
        return _INPUT_SPEC_BUILDERS[self.family](cfg, self.shapes[shape_name])


def register(spec: ArchSpec):
    ARCHS[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    """The registered ``ArchSpec``; an unknown id raises ``KeyError``."""
    return ARCHS[arch_id]


# ---------------------------------------------------------------------------
# per-family input-spec builders (meta tensors only: no allocation)
# ---------------------------------------------------------------------------

def _lm_specs(cfg, sh):
    B, S = sh["batch"], sh["seq"]
    kind = sh["kind"]
    if kind == "train":
        return {"tokens": sds((B, S), I32), "targets": sds((B, S), I32)}
    if kind == "prefill":
        return {"tokens": sds((B, S), I32)}
    if kind == "decode":
        from ..models.transformer import cache_abstract
        return {"cache": cache_abstract(cfg, B, S),
                "tokens": sds((B, 1), I32),
                "pos": sds((), I32)}
    raise ValueError(kind)


def _gnn_specs(cfg, sh):
    kind = sh["kind"]
    dtype = F32
    species_input = cfg.__class__.__name__ == "NequIPConfig"
    needs_coords = species_input or cfg.__class__.__name__ == "EGNNConfig"

    def batch_specs(N, E, d_feat, B=1):
        b = {
            "nodes": sds((N,), I32) if species_input
            else sds((N, d_feat), dtype),
            "edges": sds((E, 2), I32),
            "node_mask": sds((N,), dtype),
            "edge_mask": sds((E,), dtype),
            "graph_ids": sds((N,), I32),
            "labels": sds((N,), I32),
        }
        if needs_coords:
            b["coords"] = sds((N, 3), dtype)
        if species_input:
            b["energy_target"] = sds((B,), dtype)
        return b

    if kind == "full":
        return {"batch": batch_specs(sh["n_nodes"], sh["n_edges"],
                                     sh["d_feat"])}
    if kind == "sampled":
        # fan-out caps: roots + roots*f1 + roots*f1*f2 nodes
        r = sh["batch_nodes"]
        f = sh["fanout"]
        max_nodes = r * (1 + f[0] + f[0] * f[1])
        max_edges = r * (f[0] + f[0] * f[1])
        b = batch_specs(max_nodes, max_edges, sh["d_feat"])
        b["loss_mask"] = sds((max_nodes,), dtype)
        return {"batch": b}
    if kind == "molecule":
        B = sh["batch"]
        N = B * sh["n_nodes"]
        E = B * sh["n_edges"]
        return {"batch": batch_specs(N, E, sh.get("d_feat", 16), B=B),
                "n_graphs": B}
    raise ValueError(kind)


def _recsys_specs(cfg, sh):
    kind = sh["kind"]
    T = cfg.seq_len
    if kind == "train":
        B = sh["batch"]
        return {"hist": sds((B, T), I32), "hist_mask": sds((B, T), F32),
                "target": sds((B,), I32), "label": sds((B,), I32)}
    if kind == "serve":
        B = sh["batch"]
        return {"hist": sds((B, T), I32), "hist_mask": sds((B, T), F32),
                "target": sds((B,), I32)}
    if kind == "retrieval":
        M = sh["n_candidates"]
        return {"hist": sds((1, T), I32), "hist_mask": sds((1, T), F32),
                "candidates": sds((M,), I32)}
    raise ValueError(kind)


_INPUT_SPEC_BUILDERS = {
    "lm": _lm_specs,
    "gnn": _gnn_specs,
    "recsys": _recsys_specs,
}


# shared shape sets ---------------------------------------------------------

LM_SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    # decode against a 512k cache is O(S) per step, not O(S^2)
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "full", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433},
    "minibatch_lg": {"kind": "sampled", "n_nodes": 232965,
                     "n_edges": 114_615_892, "batch_nodes": 1024,
                     "fanout": (15, 10), "d_feat": 602},
    "ogb_products": {"kind": "full", "n_nodes": 2_449_029,
                     "n_edges": 61_859_140, "d_feat": 100},
    "molecule": {"kind": "molecule", "n_nodes": 30, "n_edges": 64,
                 "batch": 128, "d_feat": 16},
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}
