"""ArchSpec: the contract every ported architecture implements, the port's
counterpart of ``repro.configs.base``.

Each arch module registers:
  full()   — the exact published configuration
  smoke()  — reduced same-family config for CPU smoke tests
  shapes   — the arch's own input-shape set

``config_for_shape`` adjusts the full config to a shape (a GNN's input
width follows the dataset's ``d_feat``).  The reference's ``input_specs``
(jax ``ShapeDtypeStruct`` stand-ins) serve its dry run, which is not
ported.
LM shape kinds: train, prefill (forward), decode (a KV cache of seq_len).
GNN kinds: full (full-batch), sampled (fan-out sampled subgraph),
molecule (padded molecule batch).  Recsys kinds: train / serve /
retrieval.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

ARCHS: dict[str, "ArchSpec"] = {}


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


def register(spec: ArchSpec):
    ARCHS[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    """The registered ``ArchSpec``; an unknown id raises ``KeyError``."""
    return ARCHS[arch_id]


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
