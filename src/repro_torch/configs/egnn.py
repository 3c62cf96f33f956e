"""egnn [gnn] — n_layers=4 d_hidden=64 equivariance=E(n).
[arXiv:2102.09844; paper]"""
from ..models.gnn import EGNNConfig
from .base import ArchSpec, GNN_SHAPES, register


def full() -> EGNNConfig:
    return EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_in=16,
                      n_classes=8)


def smoke() -> EGNNConfig:
    return EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_in=8,
                      n_classes=4)


register(ArchSpec(
    arch_id="egnn", family="gnn", make_config=full, make_smoke_config=smoke,
    shapes=GNN_SHAPES,
    notes="E(n)-equivariant: coordinates co-evolve with features; 2PS-L "
          "edge partitioning applies directly (paper's GNN use case)"))
