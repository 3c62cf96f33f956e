"""gatedgcn [gnn] — n_layers=16 d_hidden=70 aggregator=gated.
[arXiv:2003.00982; paper]"""
from ..models.gnn import GatedGCNConfig
from .base import ArchSpec, GNN_SHAPES, register


def full() -> GatedGCNConfig:
    return GatedGCNConfig(name="gatedgcn", n_layers=16, d_hidden=70,
                          d_in=16, n_classes=8)


def smoke() -> GatedGCNConfig:
    return GatedGCNConfig(name="gatedgcn-smoke", n_layers=2, d_hidden=14,
                          d_in=8, n_classes=4)


register(ArchSpec(
    arch_id="gatedgcn", family="gnn", make_config=full,
    make_smoke_config=smoke, shapes=GNN_SHAPES,
    notes="deepest GNN (16 layers) with per-edge state: heaviest "
          "edge-memory cell; gated aggregation = SDDMM + SpMM"))
