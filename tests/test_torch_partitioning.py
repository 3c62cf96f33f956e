"""Chunk functions of the port against the jitted reference, on identical
state carried across by ``repro_torch.core.convert``: assignment, sizes and
bit matrices must be equal, chunk by chunk."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as rbitops
from repro.core import clustering as rclus
from repro.core import partitioning as RP
from repro.core.hashing import hash_mod_np
from repro.core.mapping import map_clusters_lpt
from repro.core.metrics import capacity, host_assignment
from repro.core.stream import InMemoryEdgeStream, compute_degrees
from repro_torch.core import clustering as tclus
from repro_torch.core import convert
from repro_torch.core import partitioning as TP
from repro_torch.core.stream import InMemoryEdgeStream as TStream

K = 8
C = 512


@pytest.fixture(scope="module")
def setup(small_rmat):
    """Clustered graph + LPT mapping, as the engine builds them."""
    edges = small_rmat
    V = int(edges.max()) + 1
    deg = compute_degrees(InMemoryEdgeStream(edges))
    clus = rclus.streaming_clustering(InMemoryEdgeStream(edges), deg, k=K,
                                      chunk_size=C)
    c2p, _ = map_clusters_lpt(clus.vol, K)
    return edges, V, deg, clus, c2p


def _state(setup, seed, sizes_frac, hosts=2):
    edges, V, deg, clus, c2p = setup
    rng = np.random.default_rng(seed)
    cap = capacity(len(edges), K, 1.05)
    bits = rbitops.alloc_np(V, K)
    n = len(edges) // 3
    rbitops.set_np(bits, rng.integers(0, V, n), rng.integers(0, K, n))
    host_of = host_assignment(K, hosts)
    hbits = rbitops.alloc_np(V, hosts)
    rbitops.set_np(hbits, rng.integers(0, V, n), rng.integers(0, hosts, n))
    sizes = (cap * sizes_frac * rng.random(K)).astype(np.int32)
    return {"sizes": sizes, "d": deg, "vol": clus.vol, "v2c": clus.v2c,
            "c2p": c2p, "bits": bits, "hbits": hbits,
            "host_of": host_of}, cap


def _chunk(setup, lo, n_valid=C):
    edges = setup[0]
    chunk = np.zeros((C, 2), np.int32)
    part = edges[lo:lo + n_valid]
    chunk[:len(part)] = part
    valid = np.arange(C) < len(part)
    return chunk, valid


def _torch(state, chunk, valid):
    return (convert.state_to_torch(state, "cpu"),
            torch.from_numpy(chunk.astype(np.int64)),
            torch.from_numpy(valid))


def _overflowed(state, chunk, valid, asg, k=K):
    """Edges placed on neither candidate nor their hash fallback: the
    least-loaded rounds placed them."""
    u, v = chunk[:, 0], chunk[:, 1]
    pu = state["c2p"][state["v2c"][u]]
    pv = state["c2p"][state["v2c"][v]]
    hi = np.where(state["d"][u] >= state["d"][v], u, v)
    t2 = hash_mod_np(hi.astype(np.uint32), k)
    return int((valid & (asg >= 0) & (asg != pu) & (asg != pv)
                & (asg != t2)).sum())


@pytest.mark.parametrize("lo,n_valid,sizes_frac", [
    (0, C, 0.5), (C, C, 0.5), (2 * C, 100, 0.0), (0, 0, 0.5),
    (0, C, 0.999)])
def test_prepartition_core(setup, lo, n_valid, sizes_frac):
    state, cap = _state(setup, lo + n_valid, sizes_frac)
    chunk, valid = _chunk(setup, lo, n_valid)
    if sizes_frac > 0.99:        # tight: force the hash + least-loaded tail
        cap = int(state["sizes"].max()) + 2
    rs, ra, rr = RP._prepartition_core(
        jnp.asarray(state["sizes"]), state["d"], state["v2c"], state["c2p"],
        jnp.asarray(chunk), jnp.asarray(valid), k=K, cap=cap)
    ts, tchunk, tvalid = _torch(state, chunk, valid)
    sizes, asg, rem = TP._prepartition_core(
        ts["sizes"], ts["d"], ts["v2c"], ts["c2p"], tchunk, tvalid,
        k=K, cap=cap)
    np.testing.assert_array_equal(asg.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(rem.numpy(), np.asarray(rr))
    if sizes_frac > 0.99:
        assert _overflowed(state, chunk, valid, asg.numpy()) > 0


@pytest.mark.parametrize("lo,n_valid,tight", [
    (0, C, False), (3 * C, C, False), (C, 77, False), (0, 0, False),
    (0, C, True)])
def test_score_chunk(setup, lo, n_valid, tight):
    state, cap = _state(setup, 7 * lo + n_valid, 0.5)
    chunk, valid = _chunk(setup, lo, n_valid)
    if tight:
        cap = int(state["sizes"].max()) + 2
    rb, rs, ra = RP._score_chunk(
        jnp.asarray(state["bits"]), jnp.asarray(state["sizes"]), state["d"],
        state["vol"], state["v2c"], state["c2p"], jnp.asarray(chunk),
        jnp.asarray(valid), k=K, cap=cap)
    ts, tchunk, tvalid = _torch(state, chunk, valid)
    bits, sizes, asg = TP._score_chunk(
        ts["bits"], ts["sizes"], ts["d"], ts["vol"], ts["v2c"], ts["c2p"],
        tchunk, tvalid, k=K, cap=cap)
    np.testing.assert_array_equal(asg.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(convert.words_to_numpy(bits),
                                  np.asarray(rb))
    assert bits is ts["bits"] and sizes is ts["sizes"]    # in place
    if tight:
        assert _overflowed(state, chunk, valid, asg.numpy()) > 0


@pytest.mark.parametrize("pen,hosts", [(1.0, 2), (0.5, 4), (2.5, 2)])
def test_score_chunk_hosted(setup, pen, hosts):
    state, cap = _state(setup, hosts, 0.5, hosts=hosts)
    chunk, valid = _chunk(setup, 2 * C, C)
    rb, rh, rs, ra = RP._score_chunk_hosted(
        jnp.asarray(state["bits"]), jnp.asarray(state["hbits"]),
        jnp.asarray(state["sizes"]), state["d"], state["vol"], state["v2c"],
        state["c2p"], state["host_of"], jnp.asarray(chunk),
        jnp.asarray(valid), k=K, cap=cap, dcn_penalty=pen)
    ts, tchunk, tvalid = _torch(state, chunk, valid)
    bits, hbits, sizes, asg = TP._score_chunk_hosted(
        ts["bits"], ts["hbits"], ts["sizes"], ts["d"], ts["vol"], ts["v2c"],
        ts["c2p"], ts["host_of"], tchunk, tvalid, k=K, cap=cap,
        dcn_penalty=pen)
    np.testing.assert_array_equal(asg.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(rs))
    got = convert.state_to_numpy({"bits": bits, "hbits": hbits})
    np.testing.assert_array_equal(got["bits"], np.asarray(rb))
    np.testing.assert_array_equal(got["hbits"], np.asarray(rh))


@pytest.mark.parametrize("n_pending,cap", [(0, 40), (30, 40), (300, 40),
                                           (300, 10)])
def test_least_loaded_rounds(n_pending, cap):
    """The overflow tail: skipped when nothing is pending, else k+1 rounds
    filling the least-loaded partition (ties to the lowest index); with
    too little headroom some edges stay unassigned, as in the reference."""
    rng = np.random.default_rng(n_pending + cap)
    asg = np.where(rng.random(C) < 0.25, rng.integers(0, K, C), -1)
    asg = asg.astype(np.int32)
    pending = np.zeros(C, bool)
    pending[rng.choice(np.nonzero(asg < 0)[0], n_pending,
                       replace=False)] = True
    sizes = rng.integers(0, cap, K).astype(np.int32)
    sizes[2] = sizes[5] = sizes.min()
    ra, rs = RP._least_loaded_rounds(jnp.asarray(asg), jnp.asarray(pending),
                                     jnp.asarray(sizes), cap, K)
    ta, ts = TP._least_loaded_rounds(torch.from_numpy(asg),
                                     torch.from_numpy(pending),
                                     torch.from_numpy(sizes.copy()), cap, K)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    fa, fs = TP._fill_rounds(torch.from_numpy(asg), torch.from_numpy(pending),
                             torch.from_numpy(sizes.copy()), cap, K)
    np.testing.assert_array_equal(fa.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(fs.numpy(), np.asarray(rs))


@pytest.mark.parametrize("lo,n_valid", [(0, 1024), (1024, 300), (0, 0)])
def test_cluster_chunk_step(setup, lo, n_valid):
    edges, V, deg, _, _ = setup
    chunk = np.zeros((1024, 2), np.int32)
    part = edges[lo:lo + n_valid]
    chunk[:len(part)] = part
    valid = np.arange(1024) < len(part)
    max_vol = rclus.default_max_vol(len(edges), K)
    rng = np.random.default_rng(lo)
    # mid-pass state: some vertices already moved
    v2c = np.arange(V, dtype=np.int32)
    moved = rng.choice(V, V // 4, replace=False)
    v2c[moved] = rng.integers(0, V, len(moved))
    vol = np.zeros(V, np.int32)
    np.add.at(vol, v2c, deg)
    rv, rvol, rm = rclus._cluster_chunk_step(
        jnp.asarray(v2c), jnp.asarray(vol), jnp.asarray(deg),
        jnp.asarray(chunk), jnp.asarray(valid), max_vol=max_vol, sub=128)
    tv, tvol = torch.from_numpy(v2c.copy()), torch.from_numpy(vol.copy())
    tv, tvol, tm = tclus._cluster_chunk_step(
        tv, tvol, torch.from_numpy(deg), torch.from_numpy(chunk),
        torch.from_numpy(valid), max_vol=max_vol, sub=128)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(tvol.numpy(), np.asarray(rvol))
    assert int(tm) == int(rm)


@pytest.mark.parametrize("passes", [1, 2])
def test_streaming_clustering_matches_reference(setup, passes):
    edges, _, deg, _, _ = setup
    ref = rclus.streaming_clustering(InMemoryEdgeStream(edges), deg, k=K,
                                     chunk_size=C, passes=passes)
    got = tclus.streaming_clustering(TStream(edges), deg, k=K, device="cpu",
                                     chunk_size=C, passes=passes)
    np.testing.assert_array_equal(got.v2c, ref.v2c)
    np.testing.assert_array_equal(got.vol, ref.vol)
    assert got.num_clusters == ref.num_clusters


def test_chunk_size_one_is_the_sequential_algorithm(small_planted):
    edges = small_planted[:1500]
    V = int(edges.max()) + 1
    deg = np.bincount(edges.reshape(-1), minlength=V).astype(np.int32)
    max_vol = rclus.default_max_vol(len(edges), K)
    seq = tclus.cluster_sequential(edges, deg, max_vol)
    ref_seq = rclus.cluster_sequential(edges, deg, max_vol)
    got = tclus.streaming_clustering(TStream(edges, num_vertices=V), deg,
                                     k=K, device="cpu", max_vol=max_vol,
                                     chunk_size=1)
    np.testing.assert_array_equal(seq.v2c, ref_seq.v2c)
    np.testing.assert_array_equal(got.v2c, seq.v2c)
    np.testing.assert_array_equal(got.vol, seq.vol)


def test_pad_chunk_and_convert_round_trip(setup):
    edges = setup[0]
    pc = TP.pad_chunk(edges[:300], C, "cpu")
    assert pc.n == 300 and pc.edges.dtype == torch.int64
    assert pc.edges.shape == (C, 2) and int(pc.valid.sum()) == 300
    assert not pc.edges[300:].any()
    state, _ = _state(setup, 1, 0.5)
    back = convert.state_to_numpy(convert.state_to_torch(state, "cpu"))
    for key, arr in state.items():
        np.testing.assert_array_equal(back[key], arr)
        assert back[key].dtype == (np.uint32 if key in ("bits", "hbits")
                                   else np.int32)
