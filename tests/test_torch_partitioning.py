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


def _wide_state(setup, seed, k, hosts):
    """``_state`` at k partitions: the same clusters mapped by LPT onto k,
    so that k > 32 reads a second word of every row."""
    edges, V, deg, clus, _ = setup
    rng = np.random.default_rng(seed)
    cap = capacity(len(edges), k, 1.05)
    c2p, _ = map_clusters_lpt(clus.vol, k)
    bits = rbitops.alloc_np(V, k)
    n = len(edges) // 3
    rbitops.set_np(bits, rng.integers(0, V, n), rng.integers(0, k, n))
    H = max(hosts, 1)
    hbits = rbitops.alloc_np(V, H)
    rbitops.set_np(hbits, rng.integers(0, V, n), rng.integers(0, H, n))
    sizes = (cap * 0.5 * rng.random(k)).astype(np.int32)
    return {"sizes": sizes, "d": deg, "vol": clus.vol, "v2c": clus.v2c,
            "c2p": c2p, "bits": bits, "hbits": hbits,
            "host_of": host_assignment(k, H)}, cap


@pytest.mark.parametrize("k,lo,tight", [(33, 0, False), (64, C, False),
                                        (64, 0, True), (100, 2 * C, False)])
def test_score_chunk_wide_k(setup, k, lo, tight):
    """``_score_chunk`` at k > 32 (two to four words a row) against the
    reference, byte-equal; tight: the hash and least-loaded tail runs."""
    state, cap = _wide_state(setup, k + lo, k, 0)
    chunk, valid = _chunk(setup, lo, C - 11)
    if tight:
        cap = int(state["sizes"].max()) + 2
    rb, rs, ra = RP._score_chunk(
        jnp.asarray(state["bits"]), jnp.asarray(state["sizes"]), state["d"],
        state["vol"], state["v2c"], state["c2p"], jnp.asarray(chunk),
        jnp.asarray(valid), k=k, cap=cap)
    ts, tchunk, tvalid = _torch(state, chunk, valid)
    bits, sizes, asg = TP._score_chunk(
        ts["bits"], ts["sizes"], ts["d"], ts["vol"], ts["v2c"], ts["c2p"],
        tchunk, tvalid, k=k, cap=cap)
    np.testing.assert_array_equal(asg.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(convert.words_to_numpy(bits),
                                  np.asarray(rb))
    # candidates past the first word of a row were scored
    assert (state["c2p"][state["v2c"][chunk[valid]]] > 31).any()
    if tight:
        assert _overflowed(state, chunk, valid, asg.numpy(), k) > 0


@pytest.mark.parametrize("k,hosts,pen", [(64, 4, 1.0), (40, 8, 0.5),
                                         (33, 3, 2.5)])
def test_score_chunk_hosted_wide_k(setup, k, hosts, pen):
    """``_score_chunk_hosted`` at k > 32 against the reference."""
    state, cap = _wide_state(setup, k * hosts, k, hosts)
    chunk, valid = _chunk(setup, C, C)
    rb, rh, rs, ra = RP._score_chunk_hosted(
        jnp.asarray(state["bits"]), jnp.asarray(state["hbits"]),
        jnp.asarray(state["sizes"]), state["d"], state["vol"], state["v2c"],
        state["c2p"], state["host_of"], jnp.asarray(chunk),
        jnp.asarray(valid), k=k, cap=cap, dcn_penalty=pen)
    ts, tchunk, tvalid = _torch(state, chunk, valid)
    bits, hbits, sizes, asg = TP._score_chunk_hosted(
        ts["bits"], ts["hbits"], ts["sizes"], ts["d"], ts["vol"], ts["v2c"],
        ts["c2p"], ts["host_of"], tchunk, tvalid, k=k, cap=cap,
        dcn_penalty=pen)
    np.testing.assert_array_equal(asg.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(rs))
    got = convert.state_to_numpy({"bits": bits, "hbits": hbits})
    np.testing.assert_array_equal(got["bits"], np.asarray(rb))
    np.testing.assert_array_equal(got["hbits"], np.asarray(rh))
    assert (state["c2p"][state["v2c"][chunk[valid]]] > 31).any()


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


# ---------------------------------------------------------------------------
# baselines: 2PS-HDRF step 3, HDRF / Greedy micro-batches, the hashes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,n_valid,tight,hosts", [
    (0, C, False, 0), (C, 77, False, 0), (0, 0, False, 0), (0, C, True, 0),
    (2 * C, C, False, 2), (C, C, False, 4)])
def test_hdrf_remaining_chunk(setup, lo, n_valid, tight, hosts):
    state, cap = _state(setup, 11 * lo + n_valid + hosts, 0.5)
    chunk, valid = _chunk(setup, lo, n_valid)
    if tight:
        cap = int(state["sizes"].max()) + 2
    pen = 1.0 if hosts else 0.0
    rb, rs, ra = RP._hdrf_remaining_chunk(
        jnp.asarray(state["bits"]), jnp.asarray(state["sizes"]), state["d"],
        state["v2c"], state["c2p"], jnp.asarray(chunk), jnp.asarray(valid),
        k=K, cap=cap, lam=1.1, num_hosts=hosts, dcn_penalty=pen)
    ts, tchunk, tvalid = _torch(state, chunk, valid)
    bits, sizes, asg = TP._hdrf_remaining_chunk(
        ts["bits"], ts["sizes"], ts["d"], ts["v2c"], ts["c2p"], tchunk,
        tvalid, k=K, cap=cap, lam=1.1, num_hosts=hosts, dcn_penalty=pen)
    np.testing.assert_array_equal(asg.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(convert.words_to_numpy(bits),
                                  np.asarray(rb))
    assert bits is ts["bits"] and sizes is ts["sizes"]    # in place
    if tight:
        assert _overflowed(state, chunk, valid, asg.numpy()) > 0


@pytest.mark.parametrize("n_valid,use_cap,tight,dw,hosts", [
    (C, False, False, True, 0), (C, True, False, True, 0),
    (C, True, True, True, 0), (100, False, False, True, 0),
    (100, True, False, False, 0), (0, False, False, True, 0),
    (C, False, False, False, 0), (C, False, False, True, 2),
    (150, True, True, True, 4)])
def test_hdrf_chunk(setup, n_valid, use_cap, tight, dw, hosts, monkeypatch):
    """HDRF / Greedy micro-batches against the reference's ``lax.scan``,
    with and without the hard cap (tight: all but two partitions nearly
    full, so the least-loaded rounds run), host-aware, and with the
    all-padding micro-batches skipped (``n``)."""
    state, cap = _state(setup, n_valid + 3 * hosts + use_cap, 0.3)
    chunk, valid = _chunk(setup, C, n_valid)
    if tight:
        cap = int(state["sizes"].max()) + 3
        state["sizes"][:K - 2] = cap - 1
    rounds = []
    fill = TP._fill_rounds
    monkeypatch.setattr(TP, "_fill_rounds",
                        lambda *a: rounds.append(1) or fill(*a))
    V = len(state["d"])
    dpart = np.random.default_rng(n_valid).integers(0, 20, V).astype(
        np.int32)
    kw = dict(k=K, cap=cap, lam=1.1, use_cap=use_cap, degree_weighted=dw,
              num_hosts=hosts, dcn_penalty=1.0 if hosts else 0.0)
    rb, rs, rd, ra = RP._hdrf_chunk(
        jnp.asarray(state["bits"]), jnp.asarray(state["sizes"]),
        jnp.asarray(dpart), jnp.asarray(chunk), jnp.asarray(valid), **kw)
    ts, tchunk, tvalid = _torch(state, chunk, valid)
    tdpart = torch.from_numpy(dpart.copy())
    bits, sizes, dp, asg = TP._hdrf_chunk(
        ts["bits"], ts["sizes"], tdpart, tchunk, tvalid,
        n=n_valid, **kw)
    np.testing.assert_array_equal(asg.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(dp.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(convert.words_to_numpy(bits),
                                  np.asarray(rb))
    assert bits is ts["bits"] and sizes is ts["sizes"] and dp is tdpart
    assert bool(rounds) == tight


def _hash_chunk(setup, big_ids):
    """A chunk of the test graph, or of random ids in [2^31, 2^32) (the
    reference holds those as negative int32, the port as int64)."""
    chunk, valid = _chunk(setup, C, 300)
    if big_ids:
        rng = np.random.default_rng(5)
        ids = rng.integers(1 << 31, 1 << 32, (C, 2), dtype=np.int64)
        return ids.astype(np.uint32).view(np.int32), ids, valid
    return chunk, chunk.astype(np.int64), valid


@pytest.mark.parametrize("k", [4, 8, 32])
def test_dbh_chunk(setup, k):
    chunk, tchunk, valid = _hash_chunk(setup, False)
    deg = setup[2]
    ra = RP._dbh_chunk(jnp.asarray(deg), jnp.asarray(chunk),
                       jnp.asarray(valid), k=k)
    ta = TP._dbh_chunk(torch.from_numpy(deg), torch.from_numpy(tchunk),
                       torch.from_numpy(valid), k=k)
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))


@pytest.mark.parametrize("k,big_ids", [(4, False), (8, True), (32, False),
                                       (12, True)])
def test_grid_chunk(setup, k, big_ids):
    chunk, tchunk, valid = _hash_chunk(setup, big_ids)
    rows = int(np.sqrt(k))
    while k % rows:
        rows -= 1
    ra = RP._grid_chunk(jnp.asarray(chunk), jnp.asarray(valid), k=k,
                        rows=rows, cols=k // rows)
    ta = TP._grid_chunk(torch.from_numpy(tchunk), torch.from_numpy(valid),
                        k=k, rows=rows, cols=k // rows)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))


@pytest.mark.parametrize("k,big_ids", [(4, False), (8, True), (32, False),
                                       (32, True)])
def test_random_hash_chunk(setup, k, big_ids):
    """``u * 0x9E3779B9`` wraps at 32 bits in the reference's uint32
    arithmetic; the port's int64 product must wrap the same way."""
    chunk, tchunk, valid = _hash_chunk(setup, big_ids)
    ra = RP._random_hash_chunk(jnp.asarray(chunk), jnp.asarray(valid), k=k)
    ta = TP._random_hash_chunk(torch.from_numpy(tchunk),
                               torch.from_numpy(valid), k=k)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
