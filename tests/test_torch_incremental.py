"""The rest of the reference's ``repro.core`` in the port: incremental
2PS-L (``bootstrap``, ``insert_edges``, ``drift``), ``_prepartition_chunk``,
``cluster_in_memory_scan``, the device LPT (``map_clusters_lpt_torch``
against ``map_clusters_lpt_jax``), the sequential oracle, the integration
helpers and the ``run_*`` shims, each against its reference counterpart on
the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core import bitops as rbitops
from repro.core import incremental as RI
from repro.core import integration as RG
from repro.core import oracle as RO
from repro.core import partitioning as RP
from repro.core.clustering import cluster_in_memory_scan as ref_scan
from repro.core.mapping import map_clusters_lpt_jax
from repro.data import planted_partition_graph
from repro_torch.core import convert
from repro_torch.core import incremental as TI
from repro_torch.core import integration as TG
from repro_torch.core import oracle as TO
from repro_torch.core import partitioning as TP


def _split_graph(seed):
    edges = planted_partition_graph(32, 48, 900, 4000, seed=seed)
    n = int(len(edges) * 0.8)
    return edges[:n], edges[n:], int(edges.max()) + 1


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("seed", [0, 3, 5])
def test_bootstrap_and_insert_equal(seed, k):
    """Equal initial assignment, equal inserted assignments, equal state,
    drift and quality, with the inserts in two batches of 2,048-edge
    chunks (a ragged last chunk each)."""
    base, extra, V = _split_graph(seed)
    ref_res, ref_st = RI.bootstrap(R.InMemoryEdgeStream(base, num_vertices=V),
                                   k, chunk_size=4096)
    res, st = TI.bootstrap(T.InMemoryEdgeStream(base, num_vertices=V), k,
                           chunk_size=4096, device="cpu")
    assert res.assignment.tobytes() == np.asarray(
        ref_res.assignment).tobytes()
    assert st.drift() == ref_st.drift()
    half = len(extra) // 2
    for batch in (extra[:half], extra[half:]):
        want = RI.insert_edges(ref_st, batch, chunk_size=2048)
        got = TI.insert_edges(st, batch, chunk_size=2048)
        np.testing.assert_array_equal(got, want)
    assert st.drift() == ref_st.drift() > 0
    assert (st.inserted, st.num_edges, st.cap) == (
        ref_st.inserted, ref_st.num_edges, ref_st.cap)
    for name in ("d", "vol", "v2c", "c2p", "sizes"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(ref_st, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(convert.words_to_numpy(st.bits),
                                  np.asarray(ref_st.bits))
    assert (st.quality().replication_factor
            == ref_st.quality().replication_factor)


def test_bootstrap_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base, _, V = _split_graph(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TI.bootstrap(T.InMemoryEdgeStream(base, num_vertices=V), 4)


@pytest.mark.parametrize("n_valid", [512, 300])
def test_prepartition_chunk_equal(n_valid, small_rmat):
    """Pre-partitioning with the bits folded on the device: equal bits,
    sizes, assignment and remaining mask on identical state."""
    from repro.core import compute_degrees, map_clusters_lpt
    from repro.core import streaming_clustering
    k, C = 8, 512
    edges = small_rmat
    V = int(edges.max()) + 1
    stream = R.InMemoryEdgeStream(edges)
    deg = compute_degrees(stream)
    clus = streaming_clustering(stream, deg, k=k, chunk_size=C)
    c2p, _ = map_clusters_lpt(clus.vol, k)
    rng = np.random.default_rng(n_valid)
    bits = rbitops.alloc_np(V, k)
    rbitops.set_np(bits, rng.integers(0, V, 800), rng.integers(0, k, 800))
    sizes = rng.integers(0, 40, k).astype(np.int32)
    cap = int(sizes.max()) + n_valid // k        # the overflow chain runs
    chunk = np.zeros((C, 2), np.int32)
    chunk[:n_valid] = edges[1000:1000 + n_valid]
    valid = np.arange(C) < n_valid
    r = RP._prepartition_chunk(
        jnp.asarray(bits), jnp.asarray(sizes), jnp.asarray(deg),
        jnp.asarray(clus.v2c), jnp.asarray(c2p), jnp.asarray(chunk),
        jnp.asarray(valid), k=k, cap=cap)
    r = [np.asarray(x) for x in r]
    t = TP._prepartition_chunk(
        convert.words_to_torch(bits, "cpu"), torch.from_numpy(sizes.copy()),
        torch.from_numpy(deg), torch.from_numpy(clus.v2c),
        torch.from_numpy(c2p), torch.from_numpy(chunk.astype(np.int64)),
        torch.from_numpy(valid), k=k, cap=cap)
    np.testing.assert_array_equal(convert.words_to_numpy(t[0]), r[0])
    for got, want in zip(t[1:], r[1:]):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("passes,chunk_size", [(1, 4096), (2, 4096),
                                               (1, 1024)])
def test_cluster_in_memory_scan_equal(passes, chunk_size, small_planted):
    from repro.core import compute_degrees
    edges = small_planted
    deg = compute_degrees(R.InMemoryEdgeStream(edges))
    max_vol = R.default_max_vol(len(edges), 8)
    rv, rvol = ref_scan(jnp.asarray(edges), jnp.asarray(deg), max_vol,
                        passes=passes, chunk_size=chunk_size)
    tv, tvol = T.cluster_in_memory_scan(
        torch.from_numpy(edges.astype(np.int64)), torch.from_numpy(deg),
        max_vol, passes=passes, chunk_size=chunk_size)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(tvol.numpy(), np.asarray(rvol))


@pytest.mark.parametrize("k", [2, 5, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_map_clusters_lpt_torch_equal(seed, k):
    """Equal c2p (hash fallback for empty clusters included) and loads,
    with volume ties and zero volumes."""
    rng = np.random.default_rng(seed * 10 + k)
    vol = rng.integers(0, 12, 40).astype(np.int32)
    vol[::5] = 0
    c2p_j, loads_j = map_clusters_lpt_jax(jnp.asarray(vol), k)
    c2p_t, loads_t = T.map_clusters_lpt_torch(torch.from_numpy(vol), k)
    assert c2p_t.dtype == loads_t.dtype == torch.int32
    np.testing.assert_array_equal(c2p_t.numpy(), np.asarray(c2p_j))
    np.testing.assert_array_equal(loads_t.numpy(), np.asarray(loads_j))


@pytest.mark.parametrize("k", [4, 8])
def test_oracle_partition_sequential_equal(k, small_planted):
    from repro.core import map_clusters_lpt, streaming_clustering
    edges = small_planted[:3000]
    stream = R.InMemoryEdgeStream(edges)
    clus = streaming_clustering(stream, k=k, chunk_size=1024)
    c2p, _ = map_clusters_lpt(clus.vol, k)
    want = RO.partition_sequential(edges, clus, c2p, k)
    got = TO.partition_sequential(edges, clus, c2p, k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def two_assignments(small_rmat):
    stream = R.InMemoryEdgeStream(small_rmat)
    return {"2psl": np.asarray(R.run_2psl(stream, 8,
                                          chunk_size=2048).assignment),
            "random": np.asarray(R.run_random(stream, 8).assignment)}


def test_build_device_shards_equal(small_rmat, two_assignments):
    V = int(small_rmat.max()) + 1
    for asg in two_assignments.values():
        got = TG.build_device_shards(small_rmat, asg, V, 8)
        want = RG.build_device_shards(small_rmat, asg, V, 8)
        for name in ("edges", "counts", "sync_vertices"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert (got.cap, got.replication_factor) == (
            want.cap, want.replication_factor)
        assert (TG.comm_volume_per_layer(got, 64)
                == RG.comm_volume_per_layer(want, 64))


def test_partition_speedup_report_equal(small_rmat, two_assignments):
    V = int(small_rmat.max()) + 1
    assert (TG.partition_speedup_report(small_rmat, two_assignments, V, 8)
            == RG.partition_speedup_report(small_rmat, two_assignments, V,
                                           8))


@pytest.mark.parametrize("runner", ["spec", "shim"])
def test_bipartite_partition_equal(runner):
    rng = np.random.default_rng(0)
    hist = np.stack([rng.integers(0, 100, 5000),
                     rng.integers(0, 50, 5000)], axis=1)
    if runner == "spec":
        want = RG.bipartite_partition(hist, 100, 50, 4,
                                      R.spec_for("2psl"), chunk_size=1024)
        got = TG.bipartite_partition(hist, 100, 50, 4, T.spec_for("2psl"),
                                     device="cpu", chunk_size=1024)
    else:
        want = RG.bipartite_partition(hist, 100, 50, 4, R.run_2psl,
                                      chunk_size=1024)
        got = TG.bipartite_partition(hist, 100, 50, 4, T.run_2psl,
                                     device="cpu", chunk_size=1024)
    assert got.assignment.tobytes() == np.asarray(want.assignment).tobytes()


@pytest.mark.parametrize("name", sorted(R.PARTITIONERS))
def test_run_partitioner_shims_equal(name, small_rmat):
    """Every name of ``PARTITIONERS`` at its shim's defaults (HDRF and
    Greedy on a 2,048-edge prefix: they score in 64-edge micro-batches)."""
    edges = small_rmat if name not in ("hdrf", "greedy") else small_rmat[:2048]
    assert set(T.PARTITIONERS) == set(R.PARTITIONERS)
    want = R.run_partitioner(name, R.InMemoryEdgeStream(edges), 8)
    got = T.run_partitioner(name, T.InMemoryEdgeStream(edges), 8,
                            device="cpu")
    assert got.name == want.name
    assert got.assignment.tobytes() == np.asarray(want.assignment).tobytes()
    assert (got.quality.replication_factor
            == want.quality.replication_factor)
