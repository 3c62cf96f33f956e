"""nequip [gnn] — n_layers=5 d_hidden=32 l_max=2 n_rbf=8 cutoff=5,
E(3) tensor-product equivariance (Cartesian l<=2 basis here — DESIGN.md).
[arXiv:2101.03164; paper]"""
from ..models.gnn import NequIPConfig
from .base import ArchSpec, GNN_SHAPES, register


def full() -> NequIPConfig:
    return NequIPConfig(name="nequip", n_layers=5, mul=32, l_max=2,
                        n_rbf=8, cutoff=5.0, n_species=16)


def smoke() -> NequIPConfig:
    return NequIPConfig(name="nequip-smoke", n_layers=2, mul=8, l_max=2,
                        n_rbf=4, cutoff=5.0, n_species=4)


register(ArchSpec(
    arch_id="nequip", family="gnn", make_config=full,
    make_smoke_config=smoke, shapes=GNN_SHAPES,
    notes="irrep tensor-product regime; energies invariant / vectors "
          "equivariant under rotation (property-tested)"))
