"""Buffered re-streaming (``core/buffered.py``) in the port against the
reference: the copied window functions on seeded windows, ``run_spec``
byte-equal at several k, pipeline depths, window sizes and the test
geometry, the cross-host RF with host groups, the scoring calls per window,
``build_adjacency``, the ``run_buffered`` shim and the CLI."""
import json

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import buffered as RB
from repro.sample.local_graph import build_adjacency as ref_build_adjacency
from repro_torch.core import buffered as TB
from repro_torch.sample import build_adjacency

_REF: dict = {}


def _reference(graph, edges, k, **kw):
    key = (graph, k, tuple(sorted(kw.items())))
    if key not in _REF:
        kw = {"chunk_size": 512, **kw}
        _REF[key] = R.run_spec(R.spec_for("buffered", **kw),
                               R.InMemoryEdgeStream(edges), k)
    return _REF[key]


def _assert_same(res, ref):
    assert res.assignment.dtype == np.int32
    assert res.assignment.tobytes() == np.asarray(ref.assignment).tobytes()
    assert res.quality.replication_factor == ref.quality.replication_factor
    assert res.quality.balance == ref.quality.balance
    np.testing.assert_array_equal(res.quality.part_sizes,
                                  ref.quality.part_sizes)
    for key in ("buffer_edges", "window_chunks", "windows"):
        assert res.extras[key] == ref.extras[key]
    assert set(res.timings) == set(ref.timings)


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("graph", ["small_rmat", "small_planted"])
def test_run_spec_byte_equal(graph, k, request):
    """2,048-edge windows of four 512-edge chunks: several windows."""
    edges = request.getfixturevalue(graph)
    ref = _reference(graph, edges, k, buffer_edges=2048)
    res = T.run_spec(T.spec_for("buffered", chunk_size=512,
                                buffer_edges=2048),
                     T.InMemoryEdgeStream(edges), k, device="cpu")
    _assert_same(res, ref)
    assert res.extras["windows"] == -(-len(edges) // 2048)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_any_pipeline_depth_byte_equal(depth, small_rmat):
    ref = _reference("small_rmat", small_rmat, 8, buffer_edges=2048)
    res = T.run_spec(T.spec_for("buffered", chunk_size=512,
                                buffer_edges=2048, pipeline_depth=depth),
                     T.InMemoryEdgeStream(small_rmat), 8, device="cpu")
    _assert_same(res, ref)


@pytest.mark.parametrize("graph", ["small_rmat", "small_planted"])
def test_test_geometry_byte_equal(graph, request):
    """``with_test_geometry(512)``: two chunks a window."""
    edges = request.getfixturevalue(graph)
    ref = R.run_spec(R.spec_for("buffered").with_test_geometry(512),
                     R.InMemoryEdgeStream(edges), 8)
    res = T.run_spec(T.spec_for("buffered").with_test_geometry(512),
                     T.InMemoryEdgeStream(edges), 8, device="cpu")
    _assert_same(res, ref)
    assert res.extras["window_chunks"] == 2


@pytest.mark.parametrize("k", [4, 32])
@pytest.mark.parametrize("buffer_edges", [1300, 65536])
def test_buffer_not_a_multiple_of_the_chunk(buffer_edges, k, small_rmat):
    """1,300 edges round up to three 512-edge chunks (1,536-edge windows,
    two 768-edge sub-batches each, a ragged last window); the default
    65,536 holds the whole graph in one window."""
    ref = _reference("small_rmat", small_rmat, k, buffer_edges=buffer_edges)
    res = T.run_spec(T.spec_for("buffered", chunk_size=512,
                                buffer_edges=buffer_edges),
                     T.InMemoryEdgeStream(small_rmat), k, device="cpu")
    _assert_same(res, ref)


@pytest.mark.parametrize("k", [4, 8, 32])
def test_host_groups_cross_host_rf_equal(k, small_planted):
    """``host_groups`` without a penalty only adds the cross-host RF."""
    ref = _reference("small_planted", small_planted, k, host_groups=4,
                     buffer_edges=2048)
    res = T.run_spec(T.spec_for("buffered", chunk_size=512, host_groups=4,
                                buffer_edges=2048),
                     T.InMemoryEdgeStream(small_planted), k, device="cpu")
    _assert_same(res, ref)
    assert res.extras["cross_host_rf"] == ref.extras["cross_host_rf"]
    assert res.extras["num_hosts"] == ref.extras["num_hosts"] == 4


def test_one_scoring_call_per_live_sub_batch(small_rmat, monkeypatch):
    """Each window runs ``ceil(n / sub)`` scoring sub-batches, each one
    ``_twopsl_choose`` call (one ``edge_score_choose_bits`` launch on the
    card); all-padding sub-batches are skipped."""
    from repro_torch.core import partitioning as P
    calls = []
    choose = P._twopsl_choose

    def counting(*args, **kw):
        calls.append(args[5].shape[0])
        return choose(*args, **kw)
    monkeypatch.setattr(P, "_twopsl_choose", counting)
    spec = T.spec_for("buffered", chunk_size=512, buffer_edges=1300)
    res = T.run_spec(spec, T.InMemoryEdgeStream(small_rmat), 8,
                     device="cpu")
    _assert_same(res, _reference("small_rmat", small_rmat, 8,
                                 buffer_edges=1300))
    eff = res.extras["buffer_edges"]
    subs = -(-eff // TB.SUB_BATCH_TARGET)
    sub = -(-eff // subs)
    E = len(small_rmat)
    want = sum(-(-min(eff, E - lo) // sub) for lo in range(0, E, eff))
    assert len(calls) == want
    assert set(calls) == {sub}


def _window(seed, n, V):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, V, (n, 2)).astype(np.int32)
    e[::7, 1] = e[::7, 0]                                    # self-loops
    return e


#: (seed, edges, vertex range): a single edge, a single self-loop, sparse
#: and dense windows
_WINDOWS = [(0, 1, 50), (1, 1, 1), (2, 40, 1000), (3, 500, 64),
            (4, 2000, 300)]


@pytest.mark.parametrize("k", [1, 4, 32])
@pytest.mark.parametrize("seed,n,V", _WINDOWS)
def test_window_clusters_equal(seed, n, V, k):
    e = _window(seed, n, V)
    ref = RB.window_clusters(e, k=k, max_vol_factor=1.0)
    got = TB.window_clusters(e, k=k, max_vol_factor=1.0)
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("k", [2, 8, 32])
def test_map_window_clusters_equal(k):
    rng = np.random.default_rng(k)
    wc = RB.window_clusters(_window(k, 600, 200), k=k)
    C = len(wc.vols)
    aff = rng.integers(0, 5, (C, k)).astype(np.int64)
    aff[::3] = 0                                             # affinity ties
    loads = rng.integers(0, 50, k).astype(np.int64)
    for cap_slots in (10, int(wc.vols.sum()) // k + 1, 10 ** 9):
        ref = RB.map_window_clusters(aff, wc.vols, k, init_loads=loads,
                                     cap_slots=cap_slots)
        got = TB.map_window_clusters(aff, wc.vols, k, init_loads=loads,
                                     cap_slots=cap_slots)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("by", ["src", "dst"])
@pytest.mark.parametrize("case", ["empty", "isolated_tail", "random"])
def test_build_adjacency_equal(case, by):
    rng = np.random.default_rng(5)
    if case == "empty":
        e, n = np.empty((0, 2), np.int32), 4
    elif case == "isolated_tail":
        e, n = rng.integers(0, 10, (30, 2)), 25
    else:
        e, n = rng.integers(0, 100, (500, 2)).astype(np.int32), 100
    got, ref = build_adjacency(e, n, by=by), ref_build_adjacency(e, n, by=by)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_build_adjacency_rejects_out_of_range():
    with pytest.raises(ValueError, match="out of range"):
        build_adjacency(np.array([[0, 5]]), 3, by="dst")


def test_run_buffered_shim(small_rmat):
    ref = R.run_buffered(R.InMemoryEdgeStream(small_rmat), 8, chunk_size=512,
                         buffer_edges=2048)
    res = T.run_buffered(T.InMemoryEdgeStream(small_rmat), 8,
                         chunk_size=512, buffer_edges=2048, device="cpu")
    _assert_same(res, ref)


@pytest.mark.parametrize("buffer_edges", [None, 1300],
                         ids=["default", "b1300"])
def test_cli_byte_equal_to_reference_cli(buffer_edges, small_rmat, tmp_path,
                                         capsys):
    from repro.launch.partition import main as ref_main
    from repro_torch.launch.partition import main as port_main
    graph = tmp_path / "g.bin"
    np.ascontiguousarray(small_rmat, dtype=np.uint32).tofile(graph)
    common = ["--input", str(graph), "--k", "8", "--chunk-size", "512",
              "--algorithm", "buffered", "--json"]
    if buffer_edges is not None:
        common += ["--buffer-edges", str(buffer_edges)]
    ref_main(common + ["--out", str(tmp_path / "ref.bin")])
    ref_report = json.loads(capsys.readouterr().out)
    port_main(common + ["--out", str(tmp_path / "port.bin"),
                        "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "ref.bin").read_bytes())
    for key in ("algorithm", "replication_factor", "alpha_measured",
                "buffer_edges", "window_chunks", "windows"):
        assert report[key] == ref_report[key]


@pytest.mark.gpu
@pytest.mark.parametrize("buffer_edges", [1300, 2048])
def test_card_run_equals_cpu_run(buffer_edges, small_rmat):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels import edge_score
    spec = T.spec_for("buffered", chunk_size=512, buffer_edges=buffer_edges)
    edge_score.launches.reset()
    card = T.run_spec(spec, T.InMemoryEdgeStream(small_rmat), 8,
                      device="cuda")
    eff = card.extras["buffer_edges"]
    subs = -(-eff // TB.SUB_BATCH_TARGET)
    sub = -(-eff // subs)
    E = len(small_rmat)
    want = sum(-(-min(eff, E - lo) // sub) for lo in range(0, E, eff))
    assert dict(edge_score.launches.by_entry) == {"bits": want, "flags": 0}
    cpu = T.run_spec(spec, T.InMemoryEdgeStream(small_rmat), 8,
                     device="cpu")
    assert card.assignment.tobytes() == cpu.assignment.tobytes()
    assert card.quality.replication_factor == cpu.quality.replication_factor
