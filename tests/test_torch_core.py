"""The port's foundations against the reference: hashing, bit matrices,
the 2PS-L score, the spec registry and the numpy copies.  Inputs come from
numpy seeds and cross between the packages as numpy arrays."""
import jax
import numpy as np
import pytest
import torch

from repro.core import bitops as rbitops
from repro.core import hashing as rhashing
from repro.core import scoring as rscoring
from repro.core import specs as rspecs
from repro_torch.core import bitops, convert, hashing, scoring, specs


@pytest.mark.parametrize("k,seed", [(1, 0), (7, 0), (32, 1), (1000, 3)])
def test_hash_mod_matches_numpy(k, seed):
    rng = np.random.default_rng(k + seed)
    ids = rng.integers(0, 2**32, 20_000, dtype=np.uint64)
    ids[:6] = [0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]
    want = rhashing.hash_mod_np(ids.astype(np.uint32), k, seed=seed)
    got = hashing.hash_mod(torch.from_numpy(ids.astype(np.int64)), k,
                           seed=seed)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        hashing.hash_mod_np(ids.astype(np.uint32), k, seed=seed), want)
    np.testing.assert_array_equal(
        hashing.hash_u32(torch.from_numpy(ids.astype(np.int64)),
                         seed).numpy(),
        rhashing.hash_u32_np(ids.astype(np.uint32), seed).astype(np.int64))


@pytest.mark.parametrize("V,k,n", [(5, 3, 40), (50, 32, 500),
                                   (64, 33, 2000), (9, 96, 300)])
def test_bitops_match_numpy(V, k, n):
    rng = np.random.default_rng(V * k)
    bm = rbitops.alloc_np(V, k)
    rbitops.set_np(bm, rng.integers(0, V, n // 2), rng.integers(0, k, n // 2))
    # duplicate (vertex, word) and (vertex, bit) updates inside one call,
    # including the sign bit of each word
    v = rng.integers(0, V, n)
    p = rng.integers(0, k, n)
    v[: n // 4] = v[0]
    p[: n // 8] = min(31, k - 1)
    mask = rng.random(n) < 0.8
    want = bm.copy()
    rbitops.set_np(want, v[mask], p[mask])

    t = convert.words_to_torch(bm, "cpu")
    bitops.set_(t, torch.from_numpy(v), torch.from_numpy(p),
                mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(convert.words_to_numpy(t), want)

    qv, qp = rng.integers(0, V, 300), rng.integers(0, k, 300)
    np.testing.assert_array_equal(
        bitops.get(t, torch.from_numpy(qv), torch.from_numpy(qp)).numpy(),
        rbitops.get_np(want, qv, qp))
    np.testing.assert_array_equal(bitops.popcount(t).numpy(),
                                  rbitops.popcount_np(want))
    np.testing.assert_array_equal(bitops.popcount_np(want),
                                  rbitops.popcount_np(want))


def _score_inputs(E, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 5000, E).astype(np.int32),
            rng.integers(0, 5000, E).astype(np.int32),
            rng.integers(0, 100_000, E).astype(np.int32),
            rng.integers(0, 100_000, E).astype(np.int32),
            *(rng.integers(0, 2, E).astype(bool) for _ in range(6)))


def _torch_score(args, pen):
    t = [torch.from_numpy(a) for a in args]
    return scoring.twopsl_score(*t[:8], hrep_u=t[8], hrep_v=t[9],
                                dcn_penalty=pen).numpy()


def _jax_score(args, pen):
    f = jax.jit(rscoring.twopsl_score, static_argnames="dcn_penalty")
    return np.asarray(f(*args[:8], args[8], args[9], dcn_penalty=pen))


@pytest.mark.parametrize("pen", [0.0, 0.7])
def test_twopsl_score_bit_equal_to_jitted_reference(pen):
    args = _score_inputs(1_000_000, seed=11)
    got = _torch_score(args, pen)
    want = _jax_score(args, pen)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_literal_source_form_is_not_bit_equal():
    """The reference's source text reads ``1.0 + (1.0 - d/dsum)``; under
    ``jit`` XLA computes ``2.0 - d/dsum``.  A literal transcription differs
    from the jitted reference in the last ulp for a few percent of inputs,
    which is why the port writes ``2 - θ``."""
    args = _score_inputs(200_000, seed=5)
    t = [torch.from_numpy(a) for a in args[:8]]
    du, dv, vu, vv, ru, rv, cu, cv = t
    dsum = (du + dv).to(torch.float32).clamp_min(1.0)
    vsum = (vu + vv).to(torch.float32).clamp_min(1.0)
    literal = (torch.where(ru, 1.0 + (1.0 - du / dsum), 0.0)
               + torch.where(rv, 1.0 + (1.0 - dv / dsum), 0.0)
               + torch.where(cu, vu / vsum, 0.0)
               + torch.where(cv, vv / vsum, 0.0)).numpy()
    want = _jax_score(args, 0.0)
    differ = int((literal.view(np.int32) != want.view(np.int32)).sum())
    assert differ > 1000, differ
    assert int((_torch_score(args, 0.0).view(np.int32)
                != want.view(np.int32)).sum()) == 0


def test_host_affinity_penalty_matches_reference():
    rng = np.random.default_rng(2)
    hu, hv = (rng.integers(0, 2, 1000).astype(bool) for _ in range(2))
    got = scoring.host_affinity_penalty(torch.from_numpy(hu),
                                        torch.from_numpy(hv), 2.5).numpy()
    want = np.asarray(rscoring.host_affinity_penalty(hu, hv, 2.5))
    np.testing.assert_array_equal(got, want)


def test_spec_registry_round_trips_into_the_reference():
    assert sorted(specs.SPEC_REGISTRY) == sorted(rspecs.SPEC_REGISTRY)
    for name in specs.SPEC_REGISTRY:
        ours = specs.spec_for(name)
        theirs = rspecs.spec_from_dict(ours.to_dict())
        assert theirs.to_dict() == ours.to_dict()
        assert specs.spec_from_dict(theirs.to_dict()) == ours
    for bad in ({"scoring_backend": "cuda"}, {"alpha": 0.5},
                {"dcn_penalty": 1.0}):
        with pytest.raises(specs.SpecError):
            specs.spec_for("2psl", **bad)
        with pytest.raises(rspecs.SpecError):
            rspecs.spec_for("2psl", **bad)


def test_numpy_copies_match_reference(tmp_path):
    from repro.core import metrics as rmetrics, stream as rstream
    from repro.core.mapping import map_clusters_lpt as r_lpt
    from repro.data import rmat_graph as r_rmat
    from repro_torch.core import metrics, stream
    from repro_torch.core.mapping import map_clusters_lpt
    from repro_torch.data import rmat_graph

    edges = rmat_graph(9, edge_factor=4, seed=2)
    np.testing.assert_array_equal(edges, r_rmat(9, edge_factor=4, seed=2))
    path = str(tmp_path / "g.bin")
    s = stream.MemmapEdgeStream.write(path, edges)
    rs = rstream.MemmapEdgeStream(path)
    assert (s.num_edges, s.num_vertices) == (rs.num_edges, rs.num_vertices)
    np.testing.assert_array_equal(stream.compute_degrees(s, 100),
                                  rstream.compute_degrees(rs, 100))
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 50, 300)
    host_of = metrics.host_assignment(8, 2)
    for kw in ({}, {"host_of": host_of}):
        for got, want in zip(map_clusters_lpt(vol, 8, **kw),
                             r_lpt(vol, 8, **kw)):
            np.testing.assert_array_equal(got, want)
    asg = rng.integers(0, 8, len(edges)).astype(np.int32)
    q = metrics.quality_from_assignment(edges, asg, s.num_vertices, 8)
    rq = rmetrics.quality_from_assignment(edges, asg, s.num_vertices, 8)
    assert (q.replication_factor, q.balance) == (rq.replication_factor,
                                                 rq.balance)
