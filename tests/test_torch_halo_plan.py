"""The port's halo planner (``repro_torch.dist``: a numpy copy of the
reference's ``plan_halo_exchange{,_stream}``, ``plan_capacities`` and the
host-grouped ``HostHaloPlan``) against the reference on the edge cases of
``tests/test_halo_plan_edge_cases.py``: k = 1, a partition with no edges,
isolated vertices, quantile caps that force the overflow lane, and host
groups from one host to k — every array equal, the invariants held."""
import dataclasses

import numpy as np
import pytest

from repro.core import InMemoryEdgeStream as RStream
from repro.dist import multihost as rmh
from repro.dist import partitioned_gnn as rpg
from repro_torch import obs
from repro_torch.core import InMemoryEdgeStream
from repro_torch.dist import (capacities_from_plan, host_plan_from_halo,
                              load_halo_plan, normalize_host_groups,
                              plan_capacities, plan_capacities_stream,
                              plan_halo_exchange, plan_halo_exchange_stream)


def _graph(seed=0, V=60, E=400):
    rng = np.random.default_rng(seed)
    e = rng.integers(0, V, (E, 2)).astype(np.int32)
    return e[e[:, 0] != e[:, 1]]


def _assert_equal(a, b, what="plan"):
    """Every field of two plans (HaloPlan or HostHaloPlan) equal, dtypes
    included; a HostHaloPlan's base plan too."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name == "base":
            _assert_equal(va, vb, f"{what}.base")
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype, (what, f.name)
            np.testing.assert_array_equal(va, vb, err_msg=f"{what}.{f.name}")
        else:
            assert va == vb and type(va) is type(vb), (what, f.name)


def _both(edges, asg, V, k, **kw):
    """The port's plan, checked equal to the reference's on copies."""
    ours = plan_halo_exchange(edges, asg, V, k, **kw)
    theirs = rpg.plan_halo_exchange(edges.copy(), asg.copy(), V, k, **kw)
    _assert_equal(ours, theirs)
    return ours


def _assert_coverage(plan, edges, assignment):
    assert plan.edge_mask.sum() == len(edges)
    for p in range(plan.k):
        n = int(plan.edge_mask[p].sum())
        glob = plan.vmap_global[p][plan.edges[p, :n]]
        expect = edges[assignment == p]
        np.testing.assert_array_equal(np.sort(glob, axis=0),
                                      np.sort(expect, axis=0))


def _assert_symmetry(plan):
    for p in range(plan.k):
        assert (plan.send_idx[p, p] < 0).all()
        for q in range(plan.k):
            s, r = plan.send_idx[p, q], plan.recv_idx[q, p]
            ns, nr = (s >= 0).sum(), (r >= 0).sum()
            assert ns == nr
            if ns:
                np.testing.assert_array_equal(plan.vmap_global[p][s[:ns]],
                                              plan.vmap_global[q][r[:nr]])


def test_k_equals_one():
    edges = _graph(seed=1)
    V = int(edges.max()) + 1
    asg = np.zeros(len(edges), np.int64)
    plan = _both(edges, asg, V, 1)
    _assert_coverage(plan, edges, asg)
    _assert_symmetry(plan)
    assert plan.b_cap == 0 and plan.o_cap == 0
    assert plan.replication_factor == 1.0
    assert plan.v_cap == len(np.unique(edges))


def test_partition_with_zero_edges():
    edges = _graph(seed=2)
    V = int(edges.max()) + 1
    k = 4
    asg = np.arange(len(edges)) % (k - 1)
    plan = _both(edges, asg, V, k)
    _assert_coverage(plan, edges, asg)
    _assert_symmetry(plan)
    assert plan.edge_counts[k - 1] == 0
    assert (plan.vmap_global[k - 1] == -1).all()
    assert (plan.send_idx[k - 1] < 0).all()
    assert (plan.recv_idx[:, k - 1] < 0).all()


def test_no_edges_at_all():
    edges = np.zeros((0, 2), np.int32)
    asg = np.zeros(0, np.int64)
    plan = _both(edges, asg, 10, 4)
    assert plan.edge_mask.sum() == 0 and plan.replication_factor == 0.0
    assert plan_capacities(edges, asg, 10, 4) \
        == rpg.plan_capacities(edges, asg, 10, 4)


def test_isolated_vertices_absent_everywhere():
    edges = _graph(seed=3, V=40)
    V = int(edges.max()) + 1 + 25
    k = 4
    asg = (edges[:, 0] % k).astype(np.int64)
    plan = _both(edges, asg, V, k)
    _assert_coverage(plan, edges, asg)
    present = np.unique(plan.vmap_global[plan.vmap_global >= 0])
    np.testing.assert_array_equal(present, np.unique(edges))
    caps = plan_capacities(edges, asg, V, k)
    assert caps == rpg.plan_capacities(edges, asg, V, k)
    assert caps["covered_vertices"] == len(np.unique(edges))


@pytest.mark.parametrize("quantile", [0.25, 0.5, 1.0])
def test_quantile_cap_and_capacities(quantile):
    edges = _graph(seed=4, V=50, E=600)
    V = int(edges.max()) + 1
    k = 6
    asg = np.random.default_rng(7).integers(0, k, len(edges))
    plan = _both(edges, asg, V, k, pair_cap_quantile=quantile)
    _assert_coverage(plan, edges, asg)
    _assert_symmetry(plan)
    if quantile < 1.0:
        assert plan.o_cap > 0 and (plan.ov_idx >= 0).any()
    assert (plan.send_idx >= 0).sum(axis=-1).max() <= plan.b_cap
    caps = plan_capacities(edges, asg, V, k, pair_cap_quantile=quantile)
    assert caps == rpg.plan_capacities(edges, asg, V, k,
                                       pair_cap_quantile=quantile)
    assert caps == capacities_from_plan(plan)
    streamed = plan_capacities_stream(
        InMemoryEdgeStream(edges, num_vertices=V), asg, V, k,
        pair_cap_quantile=quantile, chunk_size=97)
    assert streamed == caps


def test_streamed_planner_equals_in_memory_and_the_reference():
    edges = _graph(seed=5, V=80, E=700)
    V = int(edges.max()) + 1
    asg = np.random.default_rng(1).integers(0, 8, len(edges))
    mem = plan_halo_exchange(edges, asg, V, 8, pair_cap_quantile=0.6)
    for chunk in (1, 123, 10_000):
        ooc = plan_halo_exchange_stream(
            InMemoryEdgeStream(edges, num_vertices=V), asg, V, 8,
            pair_cap_quantile=0.6, chunk_size=chunk)
        _assert_equal(ooc, mem)
    ref = rpg.plan_halo_exchange_stream(
        RStream(edges.copy(), num_vertices=V), asg.copy(), V, 8,
        pair_cap_quantile=0.6, chunk_size=123)
    _assert_equal(mem, ref)
    with pytest.raises(ValueError, match="mismatch"):
        plan_halo_exchange(edges, asg[:-1], V, 8)


# ---------------------------------------------------------------------------
# host groups
# ---------------------------------------------------------------------------

def _host_case(seed=6, V=70, E=500, k=8):
    edges = _graph(seed=seed, V=V, E=E)
    V = int(edges.max()) + 1
    asg = np.random.default_rng(seed + 100).integers(0, k, len(edges))
    return edges, asg, V, k


def test_normalize_host_groups_matches_the_reference():
    cases = [(8, 2), (4, ((0, 1), (2, 3))), (8, 3), (4, ((0, 2), (1, 3))),
             (4, ((0,), (1, 2, 3))), (4, ((0, 1), (2, 2))), (6, 0)]
    for k, groups in cases:
        try:
            want = rmh.normalize_host_groups(k, groups)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                normalize_host_groups(k, groups)
            assert str(got.value) == str(e)
        else:
            assert normalize_host_groups(k, groups) == want


@pytest.mark.parametrize("hosts", [1, 2, 4, 8])
@pytest.mark.parametrize("quantile", [1.0, 0.4])
def test_host_plan_equals_the_reference(hosts, quantile):
    """In memory, streamed and re-sliced from a built plan: the same
    ``HostHaloPlan`` as the reference's, for one host to k."""
    edges, asg, V, k = _host_case()
    hp = _both(edges, asg, V, k, pair_cap_quantile=quantile,
               host_groups=hosts)
    ooc = plan_halo_exchange_stream(
        InMemoryEdgeStream(edges, num_vertices=V), asg, V, k,
        pair_cap_quantile=quantile, chunk_size=123, host_groups=hosts)
    _assert_equal(ooc, hp)
    _assert_equal(host_plan_from_halo(hp.base, hosts), hp)
    theirs = rmh.host_plan_from_halo(
        rpg.plan_halo_exchange(edges.copy(), asg.copy(), V, k,
                               pair_cap_quantile=quantile), hosts)
    assert hp.dcn_summary() == theirs.dcn_summary()
    assert hp.cross_host_replication_factor() \
        == theirs.cross_host_replication_factor()
    for key, arr in hp.device_arrays().items():
        np.testing.assert_array_equal(arr, theirs.device_arrays()[key])
    assert (hp.k, hp.v_cap, hp.e_cap, hp.b_cap, hp.o_cap) == (
        hp.base.k, hp.base.v_cap, hp.base.e_cap, hp.base.b_cap,
        hp.base.o_cap)


def test_single_host_group_collapses_to_base_plan():
    edges, asg, V, k = _host_case()
    plain = plan_halo_exchange(edges, asg, V, k)
    hp = plan_halo_exchange(edges, asg, V, k, host_groups=1)
    _assert_equal(hp.base, plain)
    np.testing.assert_array_equal(hp.intra_send, plain.send_idx)
    np.testing.assert_array_equal(hp.intra_recv, plain.recv_idx)
    assert hp.num_hosts == 1 and hp.hb_cap == 0


@pytest.mark.parametrize("hosts,quantile", [(2, 1.0), (4, 0.4), (8, 1.0)])
def test_host_exchange_simulation_matches_global(hosts, quantile):
    """Emulate the two-level exchange over the port's tables: every replica
    ends with the global per-vertex sum."""
    edges, asg, V, k = _host_case(seed=12)
    hp = plan_halo_exchange(edges, asg, V, k, pair_cap_quantile=quantile,
                            host_groups=hosts)
    h, d = hp.num_hosts, hp.parts_per_host
    x = np.random.default_rng(0).standard_normal((k, hp.v_cap, 5))
    x *= hp.base.node_mask[..., None]
    truth = np.zeros((V, 5))
    for p in range(k):
        ok = hp.vmap_global[p] >= 0
        np.add.at(truth, hp.vmap_global[p][ok], x[p, ok])
    ov, o_cap = hp.base.ov_idx, hp.o_cap
    ov_tot = np.zeros((o_cap, 5))
    for p in range(k):
        held = ov[p] >= 0
        ov_tot[held] += x[p, ov[p][held]]
    add = np.zeros_like(x)
    for p in range(k):
        lo = (p // d) * d
        for j in range(d):
            s, r = hp.intra_send[lo + j, p - lo], hp.intra_recv[p, j]
            add[p, r[r >= 0]] += x[lo + j, s[s >= 0]]
    y = x + add
    if h > 1 and hp.hb_cap:
        lane = np.zeros((h, h, hp.hb_cap, 5))
        for p in range(k):
            for b in range(h):
                s = hp.hsend_idx[p, b]
                lane[p // d, b, s >= 0] += y[p, s[s >= 0]]
        add = np.zeros_like(y)
        for p in range(k):
            for b in range(h):
                r = hp.hrecv_idx[p, b]
                add[p, r[r >= 0]] += lane[b, p // d, r >= 0]
        y = y + add
    for p in range(k):
        held = ov[p] >= 0
        y[p, ov[p][held]] = ov_tot[held]
    for p in range(k):
        ok = hp.vmap_global[p] >= 0
        np.testing.assert_allclose(y[p, ok], truth[hp.vmap_global[p][ok]],
                                   atol=1e-9)


def test_planning_gauges_and_spans_match_the_reference():
    """The planner records the reference's ``halo_plan`` / ``host_plan``
    spans and ``halo.*`` gauges."""
    from repro import obs as robs
    edges, asg, V, k = _host_case(seed=3)
    snaps, names = [], []
    for o, plan in ((obs, plan_halo_exchange),
                    (robs, rpg.plan_halo_exchange)):
        tr, reg = o.Tracer(), o.MetricsRegistry()
        with o.use_tracer(tr), o.use_registry(reg):
            plan(edges.copy(), asg.copy(), V, k, host_groups=2)
        snaps.append(reg.snapshot())
        names.append(o.validate_chrome_trace(o.chrome_trace(tr)))
    assert snaps[0] == snaps[1]
    assert names[0] == names[1] >= {"halo_plan", "host_plan"}


def test_load_halo_plan_by_path(tmp_path):
    import repro_torch.core as T
    edges = _graph(seed=8, V=90, E=800)
    res = T.run_spec(T.spec_for("dbh", chunk_size=256),
                     T.InMemoryEdgeStream(edges), 4, device="cpu")
    d = str(tmp_path / "art")
    T.PartitionArtifact.save(d, res, num_vertices=int(edges.max()) + 1,
                             num_edges=len(edges), edges=edges)
    _assert_equal(load_halo_plan(d), rpg.load_halo_plan(d))
    _assert_equal(load_halo_plan(T.PartitionArtifact.load(d)),
                  plan_halo_exchange(edges, res.assignment,
                                     int(edges.max()) + 1, 4))
