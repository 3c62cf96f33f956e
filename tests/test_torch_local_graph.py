"""The port's per-partition local graphs (``repro_torch.sample``: a copy of
the reference's ``LocalGraph``, ``build_local_graphs``,
``PartitionedGraph`` and ``local_graphs_manifest_entry``) against the
reference: the same CSC/CSR arrays and files from the same artifact, the
id-map contract (a partition's local ids are the valid prefix of the halo
plan's ``vmap_global[p]``), and the replica index's answers."""
import json
import os

import numpy as np
import pytest

import repro.core as R
from repro.sample import local_graph as RL
from repro_torch import obs
import repro_torch.core as T
from repro_torch.sample import (LocalGraph, PartitionedGraph,
                                build_local_graphs, load_local_graph,
                                local_graphs_manifest_entry)

K = 6


def _assert_graphs_equal(a, b):
    assert a.part_id == b.part_id
    for name in LocalGraph._ARRAYS:
        va, vb = getattr(a, name), getattr(b, name)
        assert va.dtype == vb.dtype, name
        np.testing.assert_array_equal(va, vb, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_edges_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 300))
    e = rng.integers(0, 50, (n, 2))
    eid = rng.permutation(1000)[:n]
    ours = LocalGraph.from_edges(3, e, eid)
    theirs = RL.LocalGraph.from_edges(3, e.copy(), eid.copy())
    _assert_graphs_equal(ours, theirs)
    assert ours.num_local == theirs.num_local
    assert ours.num_edges == n
    probe = np.arange(-2, 55)
    np.testing.assert_array_equal(ours.local_of(probe),
                                  theirs.local_of(probe))
    if ours.num_local:
        ids = np.arange(ours.num_local)
        np.testing.assert_array_equal(ours.in_degree(ids),
                                      theirs.in_degree(ids))
        # every CSC entry is the edge it names, in local ids
        for dst in range(ours.num_local):
            s, t = ours.csc_indptr[dst], ours.csc_indptr[dst + 1]
            glob = e[[int(np.nonzero(eid == x)[0][0])
                      for x in ours.csc_eid[s:t]]]
            np.testing.assert_array_equal(glob[:, 1],
                                          ours.vmap_global[dst])
            np.testing.assert_array_equal(
                glob[:, 0], ours.vmap_global[ours.csc_src[s:t]])


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    e = rng.integers(0, 40, (120, 2))
    g = LocalGraph.from_edges(2, e, np.arange(120))
    path = g.save(str(tmp_path))
    assert os.path.basename(path) == "local_csc_p2.npz"
    _assert_graphs_equal(LocalGraph.load(path), g)
    _assert_graphs_equal(load_local_graph(str(tmp_path), 2), g)
    _assert_graphs_equal(RL.load_local_graph(str(tmp_path), 2), g)


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    from repro_torch.data import rmat_graph
    e = rmat_graph(9, edge_factor=6, seed=3)
    path = str(tmp_path_factory.mktemp("g") / "g.bin")
    np.ascontiguousarray(e, dtype=np.uint32).tofile(path)
    return e, path


def _artifact(pkg, graph, d, *, plan=True, **run_kw):
    edges, path = graph
    stream = pkg.MemmapEdgeStream(path)
    res = pkg.run_spec(pkg.spec_for("2psl", chunk_size=512), stream, K,
                       **run_kw)
    return pkg.PartitionArtifact.save(
        d, res, num_vertices=stream.num_vertices, num_edges=len(edges),
        edges=edges if plan else None, graph_path=path)


@pytest.mark.parametrize("source", ["stream", "edges", "graph_path"])
def test_build_local_graphs_equals_the_reference(source, graph, tmp_path):
    """Each edge source: the same graphs and files as the reference, the
    manifest's block and checksums, and the id-map contract against the
    persisted plan (which ``build_local_graphs`` asserts itself)."""
    edges, path = graph
    ours_art = _artifact(T, graph, str(tmp_path / "port"), device="cpu")
    theirs_art = _artifact(R, graph, str(tmp_path / "ref"))
    kw = {"stream": {"stream": T.MemmapEdgeStream(path)},
          "edges": {"edges": edges}, "graph_path": {}}[source]
    rkw = {"stream": {"stream": R.MemmapEdgeStream(path)},
           "edges": {"edges": edges.copy()}, "graph_path": {}}[source]
    reg = obs.MetricsRegistry()
    with obs.use_registry(reg):
        ours = build_local_graphs(ours_art, chunk_size=333, **kw)
    theirs = RL.build_local_graphs(theirs_art, chunk_size=333, **rkw)
    assert reg.snapshot()["sample.local_graphs_built"]["value"] == K
    assert len(ours) == len(theirs) == K
    plan = T.PartitionArtifact.load(ours_art.path).halo_plan()
    for p, (a, b) in enumerate(zip(ours, theirs)):
        _assert_graphs_equal(a, b)
        pv = plan.vmap_global[p]
        np.testing.assert_array_equal(a.vmap_global, pv[pv >= 0])
        name = f"local_csc_p{p}.npz"
        assert (open(os.path.join(ours_art.path, name), "rb").read()
                == open(os.path.join(theirs_art.path, name), "rb").read())
    entry = local_graphs_manifest_entry(ours_art.path)
    assert entry == RL.local_graphs_manifest_entry(theirs_art.path)
    assert entry["num_partitions"] == K
    assert sum(entry["edge_counts"]) == len(edges)
    reloaded = T.PartitionArtifact.load(ours_art.path)
    assert reloaded.manifest["format_version"] == 4
    assert reloaded.has_local_graphs()
    _assert_graphs_equal(reloaded.local_graph(1), ours[1])
    with open(os.path.join(ours_art.path, "manifest.json")) as f:
        files = json.load(f)["integrity"]["files"]
    assert sum(n.startswith("local_csc_p") for n in files) == K


def test_build_local_graphs_without_plan_and_refusals(graph, tmp_path):
    edges, path = graph
    art = _artifact(T, graph, str(tmp_path / "a"), plan=False,
                    device="cpu")
    assert local_graphs_manifest_entry(art.path) is None
    with pytest.raises(FileNotFoundError):
        PartitionedGraph.load(art.path)
    with pytest.raises(ValueError, match="edges"):
        build_local_graphs(art, edges=edges[:-1])
    art.manifest["graph_path"] = None
    with pytest.raises(ValueError, match="no edge source"):
        build_local_graphs(art)
    graphs = build_local_graphs(art.path, stream=T.MemmapEdgeStream(path))
    assert sum(g.num_edges for g in graphs) == len(edges)


def test_partitioned_graph_equals_the_reference(graph, tmp_path):
    edges, path = graph
    art = _artifact(T, graph, str(tmp_path / "a"), device="cpu")
    build_local_graphs(art, stream=T.MemmapEdgeStream(path))
    ours = PartitionedGraph.load(art.path)
    theirs = RL.PartitionedGraph.load(art.path)
    for name in ("rep_vertex", "rep_part", "rep_local"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name))
    gids = np.arange(-1, ours.num_vertices + 3)
    for a, b in zip(ours.replica_slices(gids), theirs.replica_slices(gids)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.home_of(gids), theirs.home_of(gids))
    for p in range(K):
        np.testing.assert_array_equal(ours.masters(p), theirs.masters(p))
    np.testing.assert_array_equal(ours.degrees(), theirs.degrees())
    np.testing.assert_array_equal(
        ours.degrees(), np.bincount(edges[:, 1],
                                    minlength=ours.num_vertices))
    empty = PartitionedGraph([], 5)
    np.testing.assert_array_equal(empty.home_of(np.arange(3)), [-1] * 3)
