"""``repro_torch.configs``' ``ArchSpec.input_specs`` against the reference's
``input_specs`` for all 40 (architecture, shape) cells, leaf by leaf: the
same tree, every leaf a meta tensor of the reference's shape and dtype,
and the same ``n_graphs`` for the molecule cells."""
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro_torch.configs import ARCHS

CELLS = [(arch, shape) for arch, spec in sorted(R_ARCHS.items())
         for shape in spec.shapes]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        assert all(isinstance(k, str) for k in tree), path
        return {p: leaf for k in tree
                for p, leaf in _flat(tree[k], path + (k,)).items()}
    return {path: tree}


def test_the_forty_cells_of_both_packages():
    assert len(CELLS) == 40
    assert set(ARCHS) == set(R_ARCHS)
    assert all(set(ARCHS[a].shapes) == set(R_ARCHS[a].shapes)
               for a in ARCHS)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    want = _flat(R_ARCHS[arch].input_specs(shape))
    got = _flat(ARCHS[arch].input_specs(shape))
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        if isinstance(w, int):                  # a molecule cell's n_graphs
            assert type(g) is int and g == w, path
            continue
        assert isinstance(g, torch.Tensor) and g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name, \
            path
