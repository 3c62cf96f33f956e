"""The port's partition-aware sampling and GNN serving
(``repro_torch.sample``: ``PartitionedNeighborSampler``,
``minibatch_halo_plan``, ``HotVertexFeatureCache``;
``repro_torch.launch.serve``: ``serve_gnn`` and ``--gnn-artifact``) against
the reference's, on artifacts built as ``tests/test_sample.py`` builds them.

Sampler, halo-plan and cache arrays and counters are numpy copies and must
be equal exactly.  The port's own promises are held as the reference holds
them: a full-fan-out sampled EGNN forward equals the dense one at the
roots bit for bit, GIN's sampled root loss ``==`` the dense one, and a
cached serve returns the uncached logits bit for bit.  Serving against the
reference (its weights carried over with ``params_from_reference``):
logits within 1e-5 of their largest magnitude (float32 matmuls round
differently in the two frameworks, and the segment sums add in another
order), every counter of the report equal.
"""
import contextlib
import dataclasses
import io
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as RC
import repro.launch.serve as r_serve
import repro.models.gnn as RG
from repro import obs as r_obs
from repro.sample import (HotVertexFeatureCache as RCache,
                          PartitionedGraph as RPG,
                          PartitionedNeighborSampler as RSampler,
                          build_local_graphs as r_build_local_graphs,
                          minibatch_halo_plan as r_minibatch_halo_plan)
import repro_torch.core as TC
import repro_torch.launch.serve as serve
import repro_torch.models.gnn as G
from repro_torch import obs
from repro_torch.kernels import spmm as spmm_ops
from repro_torch.sample import (HotVertexFeatureCache, PartitionedGraph,
                                PartitionedNeighborSampler,
                                minibatch_halo_plan)

LOGIT_TOL = 1e-5


def _graph(seed, V=120, E=700):
    rng = np.random.default_rng(seed)
    return rng.integers(0, V, size=(E, 2), dtype=np.int64), V


def _artifact(tmp_path, edges, V, k, algorithm="2psl", name="art"):
    """The reference's artifact with local graphs (``tests/test_sample.py``'s
    recipe); returns its path."""
    stream = RC.InMemoryEdgeStream(edges, num_vertices=V)
    res = RC.run_spec(RC.spec_for(algorithm, chunk_size=256), stream, k)
    art = RC.PartitionArtifact.save(str(tmp_path / name), res,
                                    num_vertices=V, num_edges=len(edges),
                                    edges=edges)
    r_build_local_graphs(art, edges=edges)
    return art.path


def _graphs(path):
    """(port PartitionedGraph, reference PartitionedGraph) of ``path``."""
    return (PartitionedGraph.load(TC.PartitionArtifact.load(path)),
            RPG.load(RC.PartitionArtifact.load(path)))


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def _close(got, want, rtol=LOGIT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * float(np.abs(want).max()))


SPECS = [("2psl", 2), ("2psl", 4), ("dbh", 2), ("dbh", 4)]
FANOUTS = [(-1, -1), (-1,), (3,), (2, 2), (15, 10), (4, -1), (0, 3)]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One artifact per (algorithm, k), shared by the module."""
    tmp = tmp_path_factory.mktemp("arts")
    out = {}
    for i, (algorithm, k) in enumerate(SPECS):
        edges, V = _graph(10 + i)
        out[algorithm, k] = (_artifact(tmp, edges, V, k, algorithm,
                                       name=f"{algorithm}{k}"), edges, V)
    return out


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}-k{s[1]}")
@pytest.mark.parametrize("fanouts", FANOUTS, ids=str)
def test_sample_matches_reference(artifacts, spec, fanouts):
    path, _, V = artifacts[spec]
    pg, rpg = _graphs(path)
    ours = PartitionedNeighborSampler(pg, fanouts, seed=3)
    theirs = RSampler(rpg, fanouts, seed=3)
    rng = np.random.default_rng(4)
    for r in range(4):                       # the generators stay in step
        roots = rng.integers(0, V, 1 + r)
        home = None if r % 2 else int(rng.integers(0, spec[1]))
        _assert_same(ours.sample(roots, home=home),
                     theirs.sample(roots, home=home))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}-k{s[1]}")
@pytest.mark.parametrize("fanouts", [(-1, -1), (3, 2)], ids=str)
def test_padded_batch_matches_reference(artifacts, spec, fanouts):
    path, edges, V = artifacts[spec]
    pg, rpg = _graphs(path)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(V, 6)).astype(np.float32)
    labels = rng.integers(0, 3, V).astype(np.int32)
    coords = rng.normal(size=(V, 3)).astype(np.float32)
    ours = PartitionedNeighborSampler(pg, fanouts, seed=1)
    theirs = RSampler(rpg, fanouts, seed=1)
    caps = {"max_nodes": V + 8, "max_edges": len(edges) + 8}
    roots = rng.integers(0, V, 5)
    _assert_same(ours.padded_batch(roots, feats, labels, coords=coords,
                                   **caps),
                 theirs.padded_batch(roots, feats, labels, coords=coords,
                                     **caps))
    # a callable feature store and a sample drawn beforehand
    s, rs = ours.sample(roots), theirs.sample(roots)
    _assert_same(ours.padded_batch(roots, lambda g: feats[g], sample=s,
                                   **caps),
                 theirs.padded_batch(roots, lambda g: feats[g], sample=rs,
                                     **caps))


def test_padded_batch_refuses_a_sample_past_the_caps(artifacts):
    path, _, V = artifacts["2psl", 2]
    pg, _ = _graphs(path)
    sampler = PartitionedNeighborSampler(pg, (-1, -1))
    with pytest.raises(ValueError, match="sample exceeded caps"):
        sampler.padded_batch(np.arange(5), np.zeros((V, 2), np.float32),
                             max_nodes=3, max_edges=3)


def test_fanouts_below_minus_one_raise(artifacts):
    pg, _ = _graphs(artifacts["2psl", 2][0])
    with pytest.raises(ValueError, match="fanouts must be"):
        PartitionedNeighborSampler(pg, (-2,))


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}-k{s[1]}")
def test_sampler_counters_and_spans_match_reference(artifacts, spec):
    path, _, V = artifacts[spec]
    pg, rpg = _graphs(path)
    reg, r_reg = obs.MetricsRegistry(), r_obs.MetricsRegistry()
    tracer = obs.Tracer()
    roots = np.random.default_rng(6).integers(0, V, (3, 4))
    with obs.use_registry(reg), obs.use_tracer(tracer):
        s = PartitionedNeighborSampler(pg, (3, -1), seed=2)
        for r in roots:
            s.sample(r)
    with r_obs.use_registry(r_reg):
        s = RSampler(rpg, (3, -1), seed=2)
        for r in roots:
            s.sample(r)
    names = ("sample.minibatches", "sample.edges_local", "sample.edges_halo")
    snap, r_snap = reg.snapshot(), r_reg.snapshot()
    assert {n: snap[n]["value"] for n in names} \
        == {n: r_snap[n]["value"] for n in names}
    spans = [e for e in tracer.events() if e.get("name") == "sample.minibatch"]
    assert len(spans) == len(roots)


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}-k{s[1]}")
@pytest.mark.parametrize("fanouts", [(4, 4), (-1, -1), (2,)], ids=str)
def test_minibatch_halo_plan_matches_reference(artifacts, spec, fanouts):
    path, _, V = artifacts[spec]
    pg, rpg = _graphs(path)
    roots = np.arange(6)
    s = PartitionedNeighborSampler(pg, fanouts, seed=1).sample(roots)
    rs = RSampler(rpg, fanouts, seed=1).sample(roots)
    k = spec[1]
    for q in (1.0, 0.5):
        plan = minibatch_halo_plan(s, k, pair_cap_quantile=q)
        want = r_minibatch_halo_plan(rs, k, pair_cap_quantile=q)
        assert [f.name for f in dataclasses.fields(plan)] \
            == [f.name for f in dataclasses.fields(want)]
        for f in dataclasses.fields(want):
            a, b = getattr(plan, f.name), getattr(want, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name


# ---------------------------------------------------------------------------
# the feature cache
# ---------------------------------------------------------------------------

def _caches(feats, **kw):
    """(port cache, reference cache, port fetch log, reference fetch log)."""
    logs = ([], [])

    def fetcher(log):
        def fetch(g):
            log.append(np.array(g))
            return feats[g]
        return fetch
    return (HotVertexFeatureCache(fetcher(logs[0]), feats.shape[1], **kw),
            RCache(fetcher(logs[1]), feats.shape[1], **kw), *logs)


@pytest.mark.parametrize("budget_rows", [0, 1, 2, 16, 64])
@pytest.mark.parametrize("static_fraction", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("with_degrees", [False, True])
def test_cache_matches_reference(budget_rows, static_fraction, with_degrees):
    """Rows, counters, stats, fetch calls and the LRU order after every
    ``get``."""
    rng = np.random.default_rng(budget_rows)
    feats = rng.normal(size=(64, 4)).astype(np.float32)
    deg = rng.integers(0, 100, 64) if with_degrees else None
    ours, theirs, log, r_log = _caches(
        feats, byte_budget=budget_rows * 4 * 4, degrees=deg,
        static_fraction=static_fraction)
    assert (ours.static_size, ours.lru_capacity) \
        == (theirs.static_size, theirs.lru_capacity)
    for _ in range(6):
        ids = rng.integers(0, 64, 40)
        got, want = ours.get(ids), theirs.get(ids)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, feats[ids])
        assert list(ours._lru) == list(theirs._lru)
        assert ours.stats() == theirs.stats()
    assert len(log) == len(r_log)
    for a, b in zip(log, r_log):
        np.testing.assert_array_equal(a, b)


def test_cache_eviction_order_matches_reference():
    feats = np.arange(40, dtype=np.float32).reshape(10, 4)
    ours, theirs, _, _ = _caches(feats, byte_budget=3 * 4 * 4)
    for ids in ([0], [1], [2], [0], [3], [1], [4, 0], [5]):
        ours.get(np.array(ids))
        theirs.get(np.array(ids))
        assert list(ours._lru) == list(theirs._lru)
        assert ours.evictions == theirs.evictions
    assert ours.evictions == 4
    assert 0 in ours and 1 not in ours


def test_cache_counters_match_reference():
    feats = np.ones((8, 2), np.float32)
    reg, r_reg = obs.MetricsRegistry(), r_obs.MetricsRegistry()
    with obs.use_registry(reg):
        c = HotVertexFeatureCache(lambda g: feats[g], 2, byte_budget=2 * 2 * 4)
        for ids in ([0, 1], [0, 1], [2, 3, 0]):
            c.get(np.array(ids))
    with r_obs.use_registry(r_reg):
        c = RCache(lambda g: feats[g], 2, byte_budget=2 * 2 * 4)
        for ids in ([0, 1], [0, 1], [2, 3, 0]):
            c.get(np.array(ids))
    names = ("sample.cache.hits", "sample.cache.misses",
             "sample.cache.evictions")
    snap, r_snap = reg.snapshot(), r_reg.snapshot()
    assert {n: snap[n]["value"] for n in names} \
        == {n: r_snap[n]["value"] for n in names}


def test_cache_refuses_a_bad_static_fraction():
    with pytest.raises(ValueError, match="static_fraction"):
        HotVertexFeatureCache(lambda g: g, 2, byte_budget=64,
                              static_fraction=1.5)


# ---------------------------------------------------------------------------
# the port's own promises, as the reference holds them
# ---------------------------------------------------------------------------

def _dense_batch(feats, edges, V, coords=None):
    b = {"nodes": feats, "edges": edges.astype(np.int32),
         "edge_attr": None, "node_mask": np.ones(V, np.float32),
         "edge_mask": np.ones(len(edges), np.float32),
         "graph_ids": np.zeros(V, np.int32)}
    if coords is not None:
        b["coords"] = coords
    return {k: None if v is None else torch.from_numpy(v)
            for k, v in b.items()}


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: f"{s[0]}-k{s[1]}")
def test_full_fanout_egnn_bit_parity(artifacts, spec):
    """Full-fan-out sampled forward == dense forward at the roots, bit for
    bit (EGNN: no batch statistics), across specs and partition counts."""
    path, edges, V = artifacts[spec]
    pg, _ = _graphs(path)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(V, 6)).astype(np.float32)
    coords = rng.normal(size=(V, 3)).astype(np.float32)
    cfg = G.EGNNConfig(name="egnn", n_layers=2, d_hidden=16, d_in=6,
                       n_classes=3)
    params = G.egnn_init(cfg, torch.Generator().manual_seed(0))
    dense = G.egnn_apply(cfg, params, _dense_batch(feats, edges, V, coords))
    sampler = PartitionedNeighborSampler(pg, [-1, -1])
    roots = rng.choice(V, size=5, replace=False)
    b = sampler.padded_batch(roots, feats, max_nodes=V + 8,
                             max_edges=len(edges) + 8, coords=coords)
    tb = {k: v if k == "root_local" or v is None else torch.from_numpy(v)
          for k, v in b.items()}
    out = G.egnn_apply(cfg, params, tb)
    assert torch.equal(out["node_logits"][b["root_local"]],
                       dense["node_logits"][roots])


def _gin_root_loss(params, nodes, edges, emask, N, rows, labels):
    """The no-BN GIN forward (``serve``'s) and the mean root NLL."""
    gp = G.edge_prep(torch.from_numpy(edges), torch.from_numpy(emask), N)
    logits = serve.gin_serve_forward(params, torch.from_numpy(nodes), gp)
    logp = torch.log_softmax(logits[torch.from_numpy(rows).long()], dim=-1)
    return float(-torch.gather(logp, -1,
                               torch.from_numpy(labels).long()[:, None])
                 .mean())


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("padded", [True, False])
def test_full_fanout_gin_loss_parity(tmp_path, k, padded):
    """Sampled-subgraph root loss == dense loss on the same roots (no-BN
    GIN), on the padded batch and on the sample's own nodes and edges (the
    serving forward's)."""
    edges, V = _graph(20 + k)
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(V, 5)).astype(np.float32)
    labels = rng.integers(0, 3, size=V).astype(np.int32)
    pg, _ = _graphs(_artifact(tmp_path, edges, V, k))
    cfg = G.GINConfig(name="gin", n_layers=2, d_hidden=16, d_in=5,
                      n_classes=3)
    params = G.gin_init(cfg, torch.Generator().manual_seed(0))
    roots = rng.choice(V, size=6, replace=False)
    ref = _gin_root_loss(params, feats, edges.astype(np.int32),
                         np.ones(len(edges), np.float32), V, roots,
                         labels[roots])
    sampler = PartitionedNeighborSampler(pg, [-1, -1])
    s = sampler.sample(roots)
    b = sampler.padded_batch(roots, feats, labels, max_nodes=V + 8,
                             max_edges=len(edges) + 8, sample=s)
    n, e = (len(b["nodes"]), len(b["edges"])) if padded else \
        (len(s["node_ids"]), len(s["edges"]))
    got = _gin_root_loss(params, b["nodes"][:n], b["edges"][:e],
                         b["edge_mask"][:e], n, b["root_local"],
                         b["labels"][b["root_local"]])
    assert got == ref


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_artifacts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    out = {}
    for algorithm, k in (("2psl", 2), ("dbh", 4)):
        edges, V = _graph(40 + k, V=90, E=500)
        out[algorithm, k] = _artifact(tmp, edges, V, k, algorithm,
                                      name=f"{algorithm}{k}")
    return out


@pytest.mark.parametrize("spec", [("2psl", 2), ("dbh", 4)],
                         ids=lambda s: f"{s[0]}-k{s[1]}")
def test_serve_gnn_cached_logits_identical(serve_artifacts, spec):
    path = serve_artifacts[spec]
    cached, rep = serve.serve_gnn(path, n_requests=6, roots_per=3,
                                  cache_budget=1 << 12, seed=3,
                                  device="cpu")
    uncached, rep2 = serve.serve_gnn(path, n_requests=6, roots_per=3,
                                     no_cache=True, seed=3, device="cpu")
    np.testing.assert_array_equal(cached, uncached)
    assert rep["cache"]["hits"] + rep["cache"]["misses"] > 0
    assert rep["p50_ms"] > 0 and rep["p99_ms"] >= rep["p50_ms"]
    assert rep2["cache"]["hit_rate"] == 0.0


def _reference_weights(monkeypatch, seed, fanouts, d_in=8, n_classes=4):
    """The reference's ``serve_gnn`` weights for ``seed``, handed to the
    port's ``serve_gnn`` through its ``gin_init``."""
    cfg = RG.GINConfig(name="gin-serve", n_layers=len(fanouts), d_hidden=32,
                       d_in=d_in, n_classes=n_classes)
    tree = jax.tree.map(np.asarray, RG.gin_init(cfg, jax.random.key(seed)))
    monkeypatch.setattr(G, "gin_init", lambda cfg, gen:
                        G.params_from_reference(tree, gen.device))


REPORT_EQUAL = ("mode", "requests", "roots_per_request", "fanouts", "k",
                "num_vertices", "num_edges", "cache", "remote_rows_fetched",
                "fetch_failures", "fetch_retries")


def _assert_report(got, want):
    assert set(got) == set(want)
    assert {k: got[k] for k in REPORT_EQUAL} \
        == {k: want[k] for k in REPORT_EQUAL}
    assert got["p50_ms"] > 0 and got["p99_ms"] >= got["p50_ms"]


@pytest.mark.parametrize("spec", [("2psl", 2), ("dbh", 4)],
                         ids=lambda s: f"{s[0]}-k{s[1]}")
@pytest.mark.parametrize("kw", [
    {}, {"no_cache": True}, {"fanouts": (3, 2)}, {"fanouts": (-1,)},
    {"fanouts": (15, 10), "roots_per": 2}, {"cache_budget": 256},
    {"inject_fetch_faults": 2}, {"inject_fetch_faults": 5},
    {"inject_fetch_faults": 1, "no_cache": True}],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()) or "default")
def test_serve_gnn_matches_reference(serve_artifacts, monkeypatch, spec, kw):
    """The port with the reference's weights: logits within 1e-5, the
    report's counters equal (the fault-injected runs too: 2 faults recover
    within the default 2 retries, 5 serve degraded rows)."""
    path = serve_artifacts[spec]
    kw = {"n_requests": 5, "roots_per": 3, "seed": 3, **kw}
    _reference_weights(monkeypatch, 3, kw.get("fanouts", (-1, -1)))
    want, r_rep = r_serve.serve_gnn(path, **kw)
    got, rep = serve.serve_gnn(path, device="cpu", **kw)
    _close(got, want)
    _assert_report(rep, r_rep)


@pytest.mark.parametrize("spec", [("2psl", 2), ("dbh", 4)],
                         ids=lambda s: f"{s[0]}-k{s[1]}")
def test_serve_gnn_fault_injection(serve_artifacts, spec):
    """Faults up to the retries recover bit-identically; past them the
    batch is served degraded and the rows counted."""
    path = serve_artifacts[spec]
    kw = {"n_requests": 5, "roots_per": 3, "seed": 4, "device": "cpu"}
    clean, rep = serve.serve_gnn(path, **kw)
    recovered, rep2 = serve.serve_gnn(path, inject_fetch_faults=2, **kw)
    np.testing.assert_array_equal(recovered, clean)
    assert rep2["fetch_failures"] == 0 and rep2["fetch_retries"] == 2
    reg = obs.MetricsRegistry()
    with obs.use_registry(reg):
        _, rep3 = serve.serve_gnn(path, inject_fetch_faults=5, **kw)
    assert rep3["fetch_failures"] > 0
    assert reg.snapshot()["serve.fetch_failures"]["value"] \
        == rep3["fetch_failures"]
    assert rep["fetch_failures"] == 0


def test_serve_gnn_launches_no_kernel_on_the_cpu(serve_artifacts):
    spmm_ops.launches.reset()
    serve.serve_gnn(serve_artifacts["2psl", 2], n_requests=2, device="cpu")
    assert spmm_ops.launches.count == 0


def test_serve_gnn_records_its_spans_and_gauges(serve_artifacts):
    tracer, reg = obs.Tracer(), obs.MetricsRegistry()
    with obs.use_tracer(tracer), obs.use_registry(reg):
        serve.serve_gnn(serve_artifacts["2psl", 2], n_requests=3,
                        device="cpu")
    names = [e.get("name") for e in tracer.events()]
    for span in ("serve.request", "serve.features", "serve.forward",
                 "sample.minibatch"):
        assert names.count(span) == 4, span          # 3 + the warm-up
    snap = reg.snapshot()
    assert 0 < snap["serve.p50_ms"]["value"] <= snap["serve.p99_ms"]["value"]


def test_serve_forward_neighbour_sums_take_the_bound_route():
    rng = np.random.default_rng(1)
    edges = torch.from_numpy(rng.integers(0, 30, (200, 2)).astype(np.int32))
    gp = G.edge_prep(edges, torch.ones(200), 30)
    h = torch.from_numpy(rng.normal(size=(30, 32)).astype(np.float32))
    assert spmm_ops.route(h, gp.src, gp.edge_mask, gp.edges) == "bound"


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    [], ["--no-cache"], ["--fanout", "3", "2", "--roots-per", "2"],
    ["--inject-fetch-faults", "5", "--fetch-retries", "1"],
    ["--cache-budget", "512", "--fetch-timeout", "2.0"]], ids=str)
def test_serve_main_gnn_artifact_matches_reference(serve_artifacts,
                                                   monkeypatch, argv):
    """``--gnn-artifact DIR --device cpu --json`` prints the reference's
    report keys and counters (the reference's weights carried over)."""
    fanouts = (3, 2) if "--fanout" in argv else (-1, -1)
    _reference_weights(monkeypatch, 0, fanouts)
    base = ["--gnn-artifact", serve_artifacts["dbh", 4], "--requests", "4",
            "--json"] + argv
    want = _cli(r_serve.main, base)
    got = _cli(serve.main, base + ["--device", "cpu"])
    _assert_report(got, want)


def test_serve_gnn_defaults_to_the_card(serve_artifacts):
    if torch.cuda.is_available():
        pytest.skip("this case checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--gnn-artifact", serve_artifacts["2psl", 2]])


def test_serve_gnn_builds_missing_local_graphs(tmp_path):
    """An artifact saved without local graphs gets them on first serve, as
    in the reference."""
    edges, V = _graph(50, V=60, E=300)
    graph = str(tmp_path / "g.bin")
    edges.astype(np.uint32).tofile(graph)
    stream = RC.InMemoryEdgeStream(edges, num_vertices=V)
    res = RC.run_spec(RC.spec_for("2psl", chunk_size=256), stream, 2)
    art = RC.PartitionArtifact.save(str(tmp_path / "bare"), res,
                                    num_vertices=V, num_edges=len(edges),
                                    edges=edges, graph_path=graph)
    assert not art.has_local_graphs()
    _, rep = serve.serve_gnn(art.path, n_requests=2, device="cpu")
    assert TC.PartitionArtifact.load(art.path).has_local_graphs()
    assert rep["requests"] == 2
