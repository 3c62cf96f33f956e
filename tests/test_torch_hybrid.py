"""HEP (``core/hybrid.py``) in the port against the reference: the chunk
function on identical state, ``run_spec`` byte-equal at several k, budgets,
pipeline depths and the test geometry, the cross-host RF with host groups,
the resident-state gauge, the ``run_hep`` shim and the CLI."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import bitops as rbitops
from repro.core import hybrid as RH
from repro_torch.core import convert
from repro_torch.core import hybrid as TH

_REF: dict = {}


def _reference(graph, edges, k, **kw):
    key = (graph, k, tuple(sorted(kw.items())))
    if key not in _REF:
        kw = {"chunk_size": 512, **kw}
        _REF[key] = R.run_spec(R.spec_for("hep", **kw),
                               R.InMemoryEdgeStream(edges), k)
    return _REF[key]


def _assert_same(res, ref):
    assert res.assignment.dtype == np.int32
    assert res.assignment.tobytes() == np.asarray(ref.assignment).tobytes()
    assert res.quality.replication_factor == ref.quality.replication_factor
    assert res.quality.balance == ref.quality.balance
    np.testing.assert_array_equal(res.quality.part_sizes,
                                  ref.quality.part_sizes)
    for key in ("hot_vertices", "hot_state_bytes", "memory_budget_bytes"):
        assert res.extras[key] == ref.extras[key]
    assert set(res.timings) == set(ref.timings)


#: budgets: none pinned, the test geometry's 512 bytes, the default 64 MiB
_BUDGETS = [0, 512, None]


@pytest.mark.parametrize("budget", _BUDGETS, ids=["b0", "b512", "default"])
@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("graph", ["small_rmat", "small_planted"])
def test_run_spec_byte_equal(graph, k, budget, request):
    edges = request.getfixturevalue(graph)
    kw = {} if budget is None else {"memory_budget_bytes": budget}
    ref = _reference(graph, edges, k, **kw)
    res = T.run_spec(T.spec_for("hep", chunk_size=512, **kw),
                     T.InMemoryEdgeStream(edges), k, device="cpu")
    _assert_same(res, ref)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_any_pipeline_depth_byte_equal(depth, small_rmat):
    ref = _reference("small_rmat", small_rmat, 8, memory_budget_bytes=512)
    res = T.run_spec(T.spec_for("hep", chunk_size=512,
                                memory_budget_bytes=512,
                                pipeline_depth=depth),
                     T.InMemoryEdgeStream(small_rmat), 8, device="cpu")
    _assert_same(res, ref)


@pytest.mark.parametrize("graph", ["small_rmat", "small_planted"])
def test_test_geometry_byte_equal(graph, request):
    """``with_test_geometry`` pins 128 rows at k <= 32: both the in-memory
    and the hash path run."""
    edges = request.getfixturevalue(graph)
    ref = R.run_spec(R.spec_for("hep").with_test_geometry(512),
                     R.InMemoryEdgeStream(edges), 8)
    res = T.run_spec(T.spec_for("hep").with_test_geometry(512),
                     T.InMemoryEdgeStream(edges), 8, device="cpu")
    _assert_same(res, ref)
    assert 0 < res.extras["hot_vertices"] < int(edges.max()) + 1


@pytest.mark.parametrize("k", [4, 8, 32])
def test_host_groups_cross_host_rf_equal(k, small_planted):
    """``host_groups`` without a penalty only adds the cross-host RF."""
    ref = _reference("small_planted", small_planted, k, host_groups=4,
                     memory_budget_bytes=512)
    res = T.run_spec(T.spec_for("hep", chunk_size=512, host_groups=4,
                                memory_budget_bytes=512),
                     T.InMemoryEdgeStream(small_planted), k, device="cpu")
    _assert_same(res, ref)
    assert res.extras["cross_host_rf"] == ref.extras["cross_host_rf"]
    assert res.extras["num_hosts"] == ref.extras["num_hosts"] == 4


@pytest.mark.parametrize("budget", [8192, 65536])
def test_resident_state_bounded_by_budget(budget):
    """The engine's ``replication_state_bytes`` gauge reports the pinned
    rows, never more than the budget (as the reference's quality
    regression pins for its own engine)."""
    from repro_torch.data import rmat_graph
    from repro_torch.obs import MetricsRegistry
    k = 32
    reg = MetricsRegistry()
    edges = rmat_graph(12, edge_factor=8, seed=1)
    res = T.run_spec(T.spec_for("hep", chunk_size=2048,
                                memory_budget_bytes=budget),
                     T.InMemoryEdgeStream(edges), k, device="cpu",
                     metrics=reg)
    hot_bytes = res.extras["hot_state_bytes"]
    assert hot_bytes <= budget
    assert res.extras["memory_budget_bytes"] == budget
    assert reg.gauge("engine.replication_state_bytes").value == hot_bytes
    from repro_torch.core import bitops
    assert hot_bytes == res.extras["hot_vertices"] * bitops.num_words(k) * 4


def test_full_matrix_gauge_for_the_others(small_rmat):
    """Partitioners that keep the whole bit matrix report its size."""
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    T.run_spec(T.spec_for("2psl", chunk_size=512),
               T.InMemoryEdgeStream(small_rmat), 8, device="cpu",
               metrics=reg)
    V = int(small_rmat.max()) + 1
    assert reg.gauge("engine.replication_state_bytes").value == V * 4


def _chunk_state(seed, k, V=300, E=256, n_hot=100, n_valid=230,
                 tight=False):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 40, V).astype(np.int32)
    d[rng.choice(V, V // 10, replace=False)] = 17           # degree ties
    slot = np.full(V, -1, np.int32)
    slot[rng.choice(V, n_hot, replace=False)] = np.arange(n_hot)
    hbits = rbitops.alloc_np(n_hot, k)
    m = 4 * n_hot
    rbitops.set_np(hbits, rng.integers(0, n_hot, m), rng.integers(0, k, m))
    edges = rng.integers(0, V, (E, 2)).astype(np.int32)
    edges[::17, 1] = edges[::17, 0]                          # self-loops
    edges[n_valid:] = 0
    valid = np.arange(E) < n_valid
    sizes = (rng.random(k) * 20).astype(np.int32)
    # tight: the cap binds (the overflow chain runs) but every edge fits
    cap = (n_valid + int(sizes.sum())) // k + 2 if tight else 10 * E
    return hbits, sizes, d, slot, edges, valid, cap


@pytest.mark.parametrize("tight", [False, True], ids=["loose", "tight"])
@pytest.mark.parametrize("k", [1, 8, 32, 33])
def test_hep_chunk_matches_reference(k, tight):
    """The chunk function on identical state: equal assignment, sizes and
    pinned rows, with degree ties, self-loops, a ragged tail and (tight)
    the overflow chain."""
    hbits, sizes, d, slot, edges, valid, cap = _chunk_state(
        k * 3 + tight, k, tight=tight)
    r_h, r_s, r_a = RH._hep_chunk(
        jnp.asarray(hbits), jnp.asarray(sizes), jnp.asarray(d),
        jnp.asarray(slot), jnp.asarray(edges), jnp.asarray(valid), k=k,
        cap=cap)
    # the port updates its state in place: hand it copies, never memory a
    # reference buffer may alias while its dispatch is in flight
    t_h, t_s, t_a = TH._hep_chunk(
        convert.words_to_torch(hbits, "cpu"), torch.from_numpy(sizes.copy()),
        torch.from_numpy(d), torch.from_numpy(slot),
        torch.from_numpy(edges.astype(np.int64)), torch.from_numpy(valid),
        k=k, cap=cap)
    np.testing.assert_array_equal(t_a.numpy(), np.asarray(r_a))
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(r_s))
    np.testing.assert_array_equal(convert.words_to_numpy(t_h),
                                  np.asarray(r_h))
    assert (t_a.numpy()[valid] >= 0).all()


def test_run_hep_shim(small_rmat):
    ref = R.run_hep(R.InMemoryEdgeStream(small_rmat), 8, chunk_size=512,
                    memory_budget_bytes=512)
    res = T.run_hep(T.InMemoryEdgeStream(small_rmat), 8, chunk_size=512,
                    memory_budget_bytes=512, device="cpu")
    _assert_same(res, ref)


@pytest.mark.parametrize("budget", [None, 512], ids=["default", "b512"])
def test_cli_byte_equal_to_reference_cli(budget, small_rmat, tmp_path,
                                         capsys):
    from repro.launch.partition import main as ref_main
    from repro_torch.launch.partition import main as port_main
    graph = tmp_path / "g.bin"
    np.ascontiguousarray(small_rmat, dtype=np.uint32).tofile(graph)
    common = ["--input", str(graph), "--k", "8", "--chunk-size", "512",
              "--algorithm", "hep", "--json"]
    if budget is not None:
        common += ["--memory-budget-bytes", str(budget)]
    ref_main(common + ["--out", str(tmp_path / "ref.bin")])
    ref_report = json.loads(capsys.readouterr().out)
    port_main(common + ["--out", str(tmp_path / "port.bin"),
                        "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "ref.bin").read_bytes())
    for key in ("algorithm", "replication_factor", "alpha_measured",
                "hot_vertices", "hot_state_bytes", "memory_budget_bytes"):
        assert report[key] == ref_report[key]


def test_cli_refuses_the_budget_for_other_algorithms(small_rmat, tmp_path):
    """The spec is the validator: a knob the algorithm lacks is an error."""
    from repro_torch.launch.partition import main as port_main
    graph = tmp_path / "g.bin"
    np.ascontiguousarray(small_rmat, dtype=np.uint32).tofile(graph)
    with pytest.raises(SystemExit):
        port_main(["--input", str(graph), "--k", "8", "--algorithm", "2psl",
                   "--memory-budget-bytes", "512", "--device", "cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("budget", [None, 512], ids=["default", "b512"])
def test_card_run_equals_cpu_run(budget, small_rmat):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import edge_score, hdrf_score
    kw = {} if budget is None else {"memory_budget_bytes": budget}
    spec = T.spec_for("hep", chunk_size=512, **kw)
    edge_score.launches.reset()
    hdrf_score.launches.reset()
    card = T.run_spec(spec, T.InMemoryEdgeStream(small_rmat), 8,
                      device="cuda")
    assert edge_score.launches.count == hdrf_score.launches.count == 0
    cpu = T.run_spec(spec, T.InMemoryEdgeStream(small_rmat), 8,
                     device="cpu")
    assert card.assignment.tobytes() == cpu.assignment.tobytes()
    for key in ("hot_vertices", "hot_state_bytes"):
        assert card.extras[key] == cpu.extras[key]
