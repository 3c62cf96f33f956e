"""The port's sharded multi-worker partitioning (``repro_torch.shard``)
against the reference's (``repro.shard``), on the CPU, for every registered
spec: each partitioner's merge rules, ``merge_state_dicts`` on real
per-shard states (and its algebra), ``shards=1`` against the sequential
engine, sharded runs byte-equal to the reference's at W in {2, 3} and
``round_chunks`` in {1, 2} (hosted 2PS-L and capped HDRF included), the
per-round capacity quota as a (k,) tensor, ``ShardLayout``, ``ShardState``
files across the two packages, a mixed run over one ``FileExchange``
directory (rank 0 the reference, rank 1 the port), and round checkpoints
resumed in-process, in the port and across the packages."""
import copy
import itertools
import os
import threading

import numpy as np
import pytest
import torch

import repro.core as R
import repro.shard as RS
import repro_torch.core as T
import repro_torch.shard as TS
from repro_torch import obs
from repro_torch.core import partitioning as P
from repro_torch.core.convert import state_to_torch
from repro_torch.core.engine import _Timer
from repro_torch.shard.engine import _numpy_copy, _uniform_eff_chunk

ALGOS = sorted(T.SPEC_REGISTRY)
V, K, CHUNK = 350, 8, 512
N_SHARDS = 3                   # disjoint chunk groups for the merge checks
#: spec variants beyond the registry's defaults: the host-aware scoring
#: pass and HDRF under its hard capacity (the quota vector's paths)
VARIANTS = {"2psl-hosted": ("2psl", {"host_groups": 4, "dcn_penalty": 1.0}),
            "hdrf-capped": ("hdrf", {"use_cap": True})}
CASES = ALGOS + sorted(VARIANTS)


def _graph():
    rng = np.random.default_rng(17)
    e = rng.integers(0, V, (3500, 2)).astype(np.int32)
    return e[e[:, 0] != e[:, 1]]


_GRAPH = _graph()


def _stream(pkg):
    return pkg.InMemoryEdgeStream(_GRAPH.copy(), num_vertices=V)


def _spec(pkg, case, chunk_size=CHUNK):
    name, overrides = VARIANTS.get(case, (case, {}))
    return pkg.spec_for(name, **overrides).with_test_geometry(chunk_size)


_REF: dict = {}


def _reference(case, shards, round_chunks=1):
    key = (case, shards, round_chunks)
    if key not in _REF:
        _REF[key] = RS.run_spec_sharded(_spec(R, case), _stream(R), K,
                                        num_shards=shards,
                                        round_chunks=round_chunks)
    return _REF[key]


def _port(case, shards, round_chunks=1, **kw):
    return TS.run_spec_sharded(_spec(T, case), _stream(T), K,
                               num_shards=shards, round_chunks=round_chunks,
                               device="cpu", **kw)


def _assert_same_run(got, want, label):
    np.testing.assert_array_equal(np.asarray(got.assignment),
                                  np.asarray(want.assignment), err_msg=label)
    assert got.quality.replication_factor \
        == want.quality.replication_factor, label
    assert got.quality.balance == want.quality.balance, label


# ---------------------------------------------------------------------------
# merge rules and the merge itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_merge_rules_equal_the_reference(case):
    port = T.build_partitioner(_spec(T, case), "cpu").merge_rules()
    ref = R.build_partitioner(_spec(R, case)).merge_rules()
    assert port == ref
    assert set(port.values()) <= set(T.MERGE_RULES)
    assert T.MERGE_RULES == R.MERGE_RULES


_STATES: dict = {}


def _run_chunks(part, sp, base_dev, base_host, eff, keep):
    """Stream the chunks selected by ``keep(ci)`` through one pass from the
    given base on the CPU — what one shard does in one round."""
    st = state_to_torch(base_dev, "cpu")
    part.restore_host_state(copy.deepcopy(base_host))
    for ci, chunk in enumerate(_stream(T).iter_chunks(eff)):
        if not keep(ci):
            continue
        pc = P.pad_chunk(chunk, eff, "cpu")
        st, asg = sp.chunk_fn(st, pc)
        if sp.host_fold is not None:
            sp.host_fold(chunk, asg.numpy()[:pc.n])
    return _numpy_copy(st), copy.deepcopy(part.host_state())


def _pass_states(case):
    """Per pass of the port's ``case``: (rules, base_dev, base_host,
    [(shard_dev, shard_host)] * N_SHARDS), shard g having streamed the
    chunks with index % N_SHARDS == g from the shared base."""
    if case in _STATES:
        return _STATES[case]
    spec = _spec(T, case)
    part = T.build_partitioner(spec, "cpu")
    state = part.init_state(_stream(T), K, _Timer(), None)
    out = []
    for sp in part.passes():
        if sp.setup is not None:
            state = sp.setup(state)
        eff = spec.chunk_size * max(1, int(sp.window))
        base_dev = _numpy_copy(state)
        base_host = copy.deepcopy(part.host_state())
        shards = [_run_chunks(part, sp, base_dev, base_host, eff,
                              lambda ci, g=g: ci % N_SHARDS == g)
                  for g in range(N_SHARDS)]
        out.append((part.merge_rules(), base_dev, base_host, shards))
        dev, _ = _run_chunks(part, sp, base_dev, base_host, eff,
                             lambda ci: True)
        state = state_to_torch(dev, "cpu")
    _STATES[case] = out
    return out


def _merge(merge, rules, base_dev, base_host, shards):
    return (merge(base_dev, [d for d, _ in shards], rules),
            merge(base_host, [h for _, h in shards], rules))


def _assert_state_equal(a, b, label):
    assert sorted(a) == sorted(b), (label, sorted(a), sorted(b))
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype, (label, key, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{label}: {key!r}")


@pytest.mark.parametrize("case", CASES)
def test_merge_state_dicts_equals_the_reference(case):
    """The port's merge of real per-shard states (words as uint32, the
    reference's layout) equals the reference's merge of the same states,
    and every shard state key has a rule."""
    for pi, (rules, base_dev, base_host, shards) in \
            enumerate(_pass_states(case)):
        keys = set(base_dev) | set(base_host)
        for dev, host in shards:
            keys |= set(dev) | set(host)
        assert not keys - set(rules), (case, pi, sorted(keys - set(rules)))
        for key in ("bits", "hbits"):
            if key in base_dev:
                assert base_dev[key].dtype == np.uint32
        got = _merge(T.merge_state_dicts, rules, base_dev, base_host,
                     shards)
        want = _merge(R.merge_state_dicts, rules, base_dev, base_host,
                      shards)
        _assert_state_equal(got[0], want[0], f"{case} pass {pi} dev")
        _assert_state_equal(got[1], want[1], f"{case} pass {pi} host")


@pytest.mark.parametrize("case", CASES)
def test_merge_is_commutative_and_associative(case):
    """Every arrival order merges to the same state, and merging a partial
    merge with the last shard equals merging all three at once."""
    for pi, (rules, base_dev, base_host, shards) in \
            enumerate(_pass_states(case)):
        flat = _merge(T.merge_state_dicts, rules, base_dev, base_host,
                      shards)
        for perm in itertools.permutations(range(N_SHARDS)):
            got = _merge(T.merge_state_dicts, rules, base_dev, base_host,
                         [shards[i] for i in perm])
            _assert_state_equal(got[0], flat[0], f"{case} {pi} {perm}")
            _assert_state_equal(got[1], flat[1], f"{case} {pi} {perm}")
        ab = _merge(T.merge_state_dicts, rules, base_dev, base_host,
                    shards[:2])
        two_step = _merge(T.merge_state_dicts, rules, base_dev, base_host,
                          [ab, shards[2]])
        _assert_state_equal(two_step[0], flat[0], f"{case} {pi} assoc")
        _assert_state_equal(two_step[1], flat[1], f"{case} {pi} assoc")


def test_merge_single_shard_returns_its_own_state():
    base = {"x": np.zeros(3, np.int32)}
    shard = {"x": np.array([4, 5, 6], np.int32)}
    out = T.merge_state_dicts(base, [shard], {})     # no rule needed
    np.testing.assert_array_equal(out["x"], shard["x"])


def test_merge_sum_widens_and_casts_back():
    base = {"s": np.array([2_000_000_000, 0], np.int32)}
    shards = [{"s": np.array([2_100_000_000, 1], np.int32)},
              {"s": np.array([2_000_000_000, 2], np.int32)}]
    for merge in (T.merge_state_dicts, R.merge_state_dicts):
        out = merge(base, shards, {"s": "sum"})
        assert out["s"].dtype == np.int32
        np.testing.assert_array_equal(out["s"], [2_100_000_000, 3])


def test_merge_needs_at_least_one_shard():
    with pytest.raises(ValueError):
        T.merge_state_dicts({"x": np.zeros(3)}, [], {"x": "sum"})


def test_merge_rejects_uncovered_key_and_unknown_rule():
    base = {"x": np.zeros(3, np.int32)}
    with pytest.raises(KeyError, match="no merge rule"):
        T.merge_state_dicts(base, [base, base], {})
    with pytest.raises(ValueError, match="unknown merge rule"):
        T.merge_state_dicts(base, [base, base], {"x": "max"})


# ---------------------------------------------------------------------------
# the per-round capacity quota
# ---------------------------------------------------------------------------

def test_quota_is_a_device_tensor_and_restores_the_scalar():
    part = T.build_partitioner(_spec(T, "2psl"), "cpu")
    part.init_state(_stream(T), K, _Timer(), None)
    full = part.cap
    base = np.arange(K, dtype=np.int32) * 50
    part.begin_shard_round(base, 100, 300)
    assert isinstance(part.cap, torch.Tensor)
    assert part.cap.dtype == torch.int32 and part.cap.shape == (K,)
    head = np.maximum(full - base.astype(np.int64), 0)
    np.testing.assert_array_equal(part.cap.numpy(),
                                  base + -(-head * 100 // 300))
    part.begin_shard_round(base, 300, 300)      # sole owner: full headroom
    assert part.cap == full
    part.begin_shard_round(base, 1, 3)
    part.end_shard_run()
    assert part.cap == full and isinstance(part.cap, int)


def test_hash_partitioners_have_no_quota():
    part = T.build_partitioner(_spec(T, "random"), "cpu")
    part.init_state(_stream(T), K, _Timer(), None)
    part.begin_shard_round(None, 1, 3)
    assert getattr(part, "cap", None) is None


@pytest.mark.parametrize("fill", ["ranked", "rounds"])
def test_vector_cap_admits_as_the_reference(fill):
    """The admission code under a (k,) cap against the reference's, on
    the same inputs: ranked admission and the least-loaded rounds."""
    import jax.numpy as jnp
    import repro.core.partitioning as RP
    rng = np.random.default_rng(5)
    k, n = 8, 300
    sizes = rng.integers(0, 40, k).astype(np.int32)
    cap = (sizes + rng.integers(0, 30, k)).astype(np.int32)
    target = rng.integers(0, k, n).astype(np.int32)
    eligible = rng.random(n) < 0.8
    if fill == "ranked":
        ok, s = P._ranked_admit(torch.from_numpy(target),
                                torch.from_numpy(eligible),
                                torch.from_numpy(sizes.copy()),
                                torch.from_numpy(cap), k)
        rok, rs = RP._ranked_admit(jnp.asarray(target),
                                   jnp.asarray(eligible),
                                   jnp.asarray(sizes), cap, k)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    else:
        asg0 = np.where(eligible, -1, 0).astype(np.int32)
        ok, s = P._fill_rounds(torch.from_numpy(asg0.copy()),
                               torch.from_numpy(eligible),
                               torch.from_numpy(sizes.copy()),
                               torch.from_numpy(cap), k)
        rok, rs = RP._least_loaded_rounds(jnp.asarray(asg0),
                                          jnp.asarray(eligible),
                                          jnp.asarray(sizes), cap, k)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


# ---------------------------------------------------------------------------
# whole runs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_shards1_equals_run_spec_and_the_reference(case):
    got = _port(case, 1)
    seq = T.run_spec(_spec(T, case), _stream(T), K, device="cpu")
    np.testing.assert_array_equal(np.asarray(got.assignment),
                                  np.asarray(seq.assignment))
    assert got.quality.replication_factor == seq.quality.replication_factor
    _assert_same_run(got, _reference(case, 1), f"{case} shards=1")
    assert got.extras["shards"] == 1


@pytest.mark.parametrize("round_chunks", [1, 2])
@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_sharded_equals_the_reference(case, shards, round_chunks):
    got = _port(case, shards, round_chunks)
    want = _reference(case, shards, round_chunks)
    _assert_same_run(got, want, f"{case} W={shards} R={round_chunks}")
    for key in ("shards", "round_chunks", "rounds", "shard_backend"):
        assert got.extras[key] == want.extras[key], key
    assert got.extras["shard_slices"] == want.extras["shard_slices"]
    if "cross_host_rf" in want.extras:
        assert got.extras["cross_host_rf"] == want.extras["cross_host_rf"]


def test_sharded_run_records_spans_and_metrics():
    tracer, registry = obs.Tracer(), obs.MetricsRegistry()
    res = _port("2psl", 2, tracer=tracer, metrics=registry)
    names = {e["name"] for e in tracer.events()}
    assert {"shard:merge", "shard:exchange", "shard:stitch"} <= names
    snap = registry.snapshot()
    assert snap["engine.shards"]["value"] == 2
    assert snap["shard.merge_seconds"]["count"] >= 1
    assert snap["engine.replication_state_bytes"]["value"] > 0
    assert len(res.extras["shard_slices"]) == 2


def test_sharded_run_writes_a_loadable_artifact(tmp_path):
    res = _port("2psl", 2)
    shards = {"num_shards": 2, "round_chunks": 1,
              "rounds": res.extras["rounds"], "backend": "emulated",
              "slices": res.extras["shard_slices"]}
    d = str(tmp_path / "art")
    T.PartitionArtifact.save(d, res, num_vertices=V,
                             num_edges=_stream(T).num_edges, shards=shards)
    for pkg in (T, R):
        art = pkg.PartitionArtifact.load(d)
        assert art.manifest["shards"] == shards
        np.testing.assert_array_equal(np.asarray(art.assignment),
                                      np.asarray(res.assignment))
    ref_dir = str(tmp_path / "ref")
    want = _reference("2psl", 2)
    R.PartitionArtifact.save(ref_dir, want, num_vertices=V,
                             num_edges=_stream(R).num_edges, shards=shards)
    assert T.PartitionArtifact.load(ref_dir).manifest["shards"] == shards


# ---------------------------------------------------------------------------
# layout and state files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,round_chunks,num_edges,eff",
                         [(1, 1, 3487, 512), (2, 1, 3487, 512),
                          (3, 2, 3487, 512), (4, 3, 10_000, 700),
                          (5, 1, 512, 512), (3, 1, 1, 512)])
def test_shard_layout_equals_the_reference(world, round_chunks, num_edges,
                                           eff):
    got = TS.ShardLayout(num_edges=num_edges, eff_chunk=eff, world=world,
                         round_chunks=round_chunks)
    want = RS.ShardLayout(num_edges=num_edges, eff_chunk=eff, world=world,
                          round_chunks=round_chunks)
    assert (got.num_chunks, got.num_rounds) \
        == (want.num_chunks, want.num_rounds)
    seen = np.zeros(num_edges, np.int32)
    for rank in range(world):
        assert got.extents(rank) == want.extents(rank)
        assert got.local_rows(rank) == want.local_rows(rank)
        for rnd in range(got.num_rounds):
            assert got.round_span(rnd, rank) == want.round_span(rnd, rank)
        for g_lo, n, _ in got.extents(rank):
            seen[g_lo:g_lo + n] += 1
    assert (seen == 1).all()


def _state(pkg):
    return pkg.ShardState.snapshot(
        {"rank": 1, "round": 3, "pass_index": 0},
        device={"bits": np.arange(6, dtype=np.uint32),
                "sizes": np.array([3, 4], np.int32)},
        host={"d": np.ones(4, np.int32),
              "sizes": np.arange(2, dtype=np.int64)},
        arrays={"asg": np.full(5, -1, np.int32)})


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                           ("port", "port")])
def test_shard_state_files_cross_packages(tmp_path, writer, reader):
    pkgs = {"port": TS, "ref": RS}
    s = _state(pkgs[writer])
    path = str(tmp_path / "state.npz")
    s.save(path)
    back = pkgs[reader].ShardState.load(path)
    assert back.meta == s.meta
    for group in ("device", "host", "arrays"):
        _assert_state_equal(getattr(back, group), getattr(s, group), group)


def test_snapshot_copies_arrays():
    live = np.zeros(4, np.int32)
    s = TS.ShardState.snapshot({}, device={"x": live})
    live[:] = 7
    assert int(s.device["x"].sum()) == 0


def test_file_exchange_gathers_in_rank_order(tmp_path):
    d = str(tmp_path / "x")
    views = [TS.FileExchange(d, r, 2, timeout_s=30, poll_s=0.01)
             for r in range(2)]
    out = [None, None]

    def run(r):
        out[r] = views[r].exchange(
            "p00_r00000", TS.ShardState.snapshot({"rank": r}))
    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for got in out:
        assert [s.meta["rank"] for s in got] == [0, 1]
    lonely = TS.FileExchange(str(tmp_path / "y"), 0, 2, timeout_s=0.05,
                             poll_s=0.01)
    with pytest.raises(TS.ExchangeTimeout):
        lonely.exchange("final", TS.ShardState.snapshot({"rank": 0}))


# ---------------------------------------------------------------------------
# the two packages on one exchange, and round checkpoints
# ---------------------------------------------------------------------------

def _mixed_run(case, tmp_path):
    """Rank 0 the reference's ``run_worker``, rank 1 the port's (CPU),
    over one FileExchange directory; both workers' results."""
    d = str(tmp_path / "xchg")
    out, errors = [None, None], [None, None]

    def ref_rank():
        try:
            out[0] = RS.run_worker(_spec(R, case), _stream(R), K,
                                   RS.FileExchange(d, 0, 2, timeout_s=120))
        except BaseException as e:
            errors[0] = e

    def port_rank():
        try:
            out[1] = TS.run_worker(_spec(T, case), _stream(T), K,
                                   TS.FileExchange(d, 1, 2, timeout_s=120),
                                   device="cpu")
        except BaseException as e:
            errors[1] = e
    threads = [threading.Thread(target=ref_rank),
               threading.Thread(target=port_rank)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return out


@pytest.mark.parametrize("case", CASES)
def test_mixed_reference_and_port_workers(case, tmp_path):
    """The two packages' workers exchange and merge each other's states;
    either side's stitch equals the reference's emulated W = 2 run."""
    ref_worker, port_worker = _mixed_run(case, tmp_path)
    want = _reference(case, 2)
    eff = _uniform_eff_chunk(_spec(T, case),
                             list(port_worker.partitioner.passes()))
    layout = RS.ShardLayout(num_edges=_stream(R).num_edges, eff_chunk=eff,
                            world=2)
    ref_res = RS.finalize_shard_run(ref_worker, layout, _spec(R, case),
                                    _stream(R), K, backend="fs")
    _assert_same_run(ref_res, want, f"{case} mixed, reference stitch")
    port_res = TS.finalize_shard_run(
        port_worker, TS.ShardLayout(num_edges=layout.num_edges,
                                    eff_chunk=eff, world=2),
        _spec(T, case), _stream(T), K, backend="fs")
    _assert_same_run(port_res, want, f"{case} mixed, port stitch")


class _Crashed(BaseException):
    pass


def _crash_exit(code):
    raise _Crashed(code)


def _crash_then(monkeypatch, run):
    """Run ``run()`` with every worker dying after its first round
    checkpoint (``REPRO_CRASH_AFTER_CHECKPOINTS``, ``os._exit`` raising)."""
    monkeypatch.setenv("REPRO_CRASH_AFTER_CHECKPOINTS", "1")
    monkeypatch.setattr(os, "_exit", _crash_exit)
    with pytest.raises(_Crashed):
        run()
    monkeypatch.delenv("REPRO_CRASH_AFTER_CHECKPOINTS")


@pytest.mark.parametrize("case", ALGOS)
def test_emulated_resume_mid_pass(case, tmp_path, monkeypatch):
    """Both ranks of an emulated W = 2 run die after their first round
    checkpoint (mid-pass); resuming them gives the clean bytes."""
    d = str(tmp_path / "ckpt")
    _crash_then(monkeypatch, lambda: _port(
        case, 2, checkpoint_dir=d, checkpoint_every_rounds=1))
    from repro_torch.robust import load_engine_checkpoint
    for rank in range(2):
        meta = load_engine_checkpoint(os.path.join(d, f"rank{rank:03d}")).meta
        assert (meta["pass_index"], meta["next_chunk"]) == (0, 1)
        assert (meta["shard"], meta["num_shards"]) == (rank, 2)
        assert meta["assignment_in_checkpoint"] is True
    res = _port(case, 2, checkpoint_dir=d, checkpoint_every_rounds=1,
                resume=True)
    _assert_same_run(res, _reference(case, 2), f"{case} resumed")
    assert res.extras["resumes"] == 2


@pytest.mark.parametrize("case", ["2psl", "2psl-hosted", "hdrf-capped",
                                  "buffered", "hep"])
def test_reference_round_checkpoint_resumes_in_the_port(case, tmp_path,
                                                        monkeypatch):
    d = str(tmp_path / "ckpt")
    _crash_then(monkeypatch, lambda: RS.run_spec_sharded(
        _spec(R, case), _stream(R), K, num_shards=2, checkpoint_dir=d,
        checkpoint_every_rounds=1))
    res = _port(case, 2, checkpoint_dir=d, checkpoint_every_rounds=1,
                resume=True)
    _assert_same_run(res, _reference(case, 2), f"{case} ref -> port")
    assert res.extras["resumes"] == 2
