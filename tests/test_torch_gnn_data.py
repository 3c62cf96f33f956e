"""The port's numpy copies of the reference's GNN data modules
(``repro_torch.data.sampler``: ``CSRGraph``, ``NeighborSampler``;
``repro_torch.data.gnn_batches``: ``full_graph_batch``,
``molecule_batch``): the same arrays, dtypes and keys from the same seeds,
exactly."""
import numpy as np
import pytest

from repro.data import gnn_batches as RB
from repro.data import sampler as RS
from repro_torch.data import gnn_batches as B
from repro_torch.data import sampler as S


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _edges(seed, V, E):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, (E, 2)).astype(np.int64)


@pytest.mark.parametrize("V,E", [(4, 0), (5, 1), (50, 300), (200, 40)])
def test_csrgraph_matches_reference(V, E):
    edges = _edges(V + E, V, E)
    g, rg = S.CSRGraph.from_edges(edges, V), RS.CSRGraph.from_edges(edges, V)
    assert g.num_nodes == rg.num_nodes
    for name in ("indptr", "indices"):
        assert getattr(g, name).dtype == getattr(rg, name).dtype
        np.testing.assert_array_equal(getattr(g, name), getattr(rg, name))
    nodes = np.arange(V)
    np.testing.assert_array_equal(g.degree(nodes), rg.degree(nodes))


@pytest.mark.parametrize("fanouts", [(3,), (2, 2), (5, 3, 2), (0,)])
@pytest.mark.parametrize("V,E", [(4, 0), (50, 300), (200, 40)])
@pytest.mark.parametrize("seed", [0, 7])
def test_neighbor_sampler_matches_reference(fanouts, V, E, seed):
    edges = _edges(seed, V, E)
    ours = S.NeighborSampler(S.CSRGraph.from_edges(edges, V), fanouts,
                             seed=seed)
    theirs = RS.NeighborSampler(RS.CSRGraph.from_edges(edges, V), fanouts,
                                seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(3):                       # the generators stay in step
        roots = rng.integers(0, V, 5)
        _assert_same(ours.sample(roots), theirs.sample(roots))


@pytest.mark.parametrize("seed", [0, 3])
def test_padded_batch_matches_reference(seed):
    V, E = 60, 400
    edges = _edges(seed, V, E)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(V, 6)).astype(np.float32)
    labels = rng.integers(0, 4, V).astype(np.int32)
    ours = S.NeighborSampler(S.CSRGraph.from_edges(edges, V), (4, 3),
                             seed=seed)
    theirs = RS.NeighborSampler(RS.CSRGraph.from_edges(edges, V), (4, 3),
                                seed=seed)
    roots = rng.integers(0, V, 6)
    _assert_same(ours.padded_batch(roots, feats, labels, max_nodes=V,
                                   max_edges=200),
                 theirs.padded_batch(roots, feats, labels, max_nodes=V,
                                     max_edges=200))
    with pytest.raises(ValueError, match="sample exceeded caps"):
        ours.padded_batch(roots, feats, labels, max_nodes=2, max_edges=2)


@pytest.mark.parametrize("n_nodes,n_edges,d_feat", [
    (2708, 10556, 1433), (500, 3000, 16), (100, 50, 2), (64, 400, 3)])
@pytest.mark.parametrize("with_coords", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_full_graph_batch_matches_reference(n_nodes, n_edges, d_feat,
                                            with_coords, seed):
    _assert_same(B.full_graph_batch(n_nodes, n_edges, d_feat, seed=seed,
                                    with_coords=with_coords),
                 RB.full_graph_batch(n_nodes, n_edges, d_feat, seed=seed,
                                     with_coords=with_coords))


@pytest.mark.parametrize("n_classes,n_communities", [(8, 32), (3, 5)])
def test_full_graph_batch_communities_match_reference(n_classes,
                                                      n_communities):
    _assert_same(B.full_graph_batch(300, 2000, 12, n_classes=n_classes,
                                    n_communities=n_communities, seed=2),
                 RB.full_graph_batch(300, 2000, 12, n_classes=n_classes,
                                     n_communities=n_communities, seed=2))


@pytest.mark.parametrize("batch,n_nodes,n_edges", [
    (128, 30, 64), (4, 10, 24), (1, 3, 5)])
@pytest.mark.parametrize("n_species", [4, 16])
@pytest.mark.parametrize("one_hot", [False, True])
def test_molecule_batch_matches_reference(batch, n_nodes, n_edges,
                                          n_species, one_hot):
    got, gb = B.molecule_batch(batch, n_nodes, n_edges, n_species=n_species,
                               seed=batch, one_hot_species=one_hot)
    want, wb = RB.molecule_batch(batch, n_nodes, n_edges,
                                 n_species=n_species, seed=batch,
                                 one_hot_species=one_hot)
    assert gb == wb == batch
    _assert_same(got, want)
