"""gin-tu [gnn] — n_layers=5 d_hidden=64 aggregator=sum eps=learnable.
[arXiv:1810.00826; paper]"""
from ..models.gnn import GINConfig
from .base import ArchSpec, GNN_SHAPES, register


def full() -> GINConfig:
    return GINConfig(name="gin-tu", n_layers=5, d_hidden=64, d_in=16,
                     n_classes=8)


def smoke() -> GINConfig:
    return GINConfig(name="gin-smoke", n_layers=2, d_hidden=16, d_in=8,
                     n_classes=4)


register(ArchSpec(
    arch_id="gin-tu", family="gnn", make_config=full,
    make_smoke_config=smoke, shapes=GNN_SHAPES,
    notes="SpMM regime; sum aggregation maps 1:1 onto kernels/spmm"))
