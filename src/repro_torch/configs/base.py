"""ArchSpec: the contract every ported architecture implements, the port's
counterpart of ``repro.configs.base``.

Each arch module registers:
  full()   — the exact published configuration
  smoke()  — reduced same-family config for CPU smoke tests
  shapes   — the arch's own input-shape set

The reference's ``input_specs`` (jax ``ShapeDtypeStruct`` stand-ins) and
``config_for_shape`` serve its dry run, which is not ported.
LM shape kinds: train, prefill (forward), decode (a KV cache of seq_len).
Recsys kinds: train / serve / retrieval.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

ARCHS: dict[str, "ArchSpec"] = {}

#: the reference's other architecture ids -> the ROADMAP item porting them
_NOT_PORTED = {
    **dict.fromkeys(("qwen2-moe-a2.7b", "olmoe-1b-7b"),
                    "Queue 1 item 12 (MoE dispatch)"),
    **dict.fromkeys(("egnn", "nequip", "gin-tu", "gatedgcn"),
                    "Queue 1 item 10 (GNN serving and training)"),
}


@dataclass
class ArchSpec:
    arch_id: str
    family: str                       # lm | gnn | recsys
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict[str, dict]
    notes: str = ""


def register(spec: ArchSpec):
    ARCHS[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    """The registered ``ArchSpec``.  An architecture of the reference that
    is not ported yet raises ``NotImplementedError``; an unknown id
    ``KeyError``."""
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported to repro_torch yet: "
            f"see ROADMAP.md {_NOT_PORTED[arch_id]}")
    return ARCHS[arch_id]


LM_SHAPES = {
    "train_4k": {"seq": 4096, "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768, "batch": 32, "kind": "prefill"},
    "decode_32k": {"seq": 32768, "batch": 128, "kind": "decode"},
    # decode against a 512k cache is O(S) per step, not O(S^2)
    "long_500k": {"seq": 524288, "batch": 1, "kind": "decode"},
}

RECSYS_SHAPES = {
    "train_batch": {"kind": "train", "batch": 65536},
    "serve_p99": {"kind": "serve", "batch": 512},
    "serve_bulk": {"kind": "serve", "batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "batch": 1,
                       "n_candidates": 1_000_000},
}
