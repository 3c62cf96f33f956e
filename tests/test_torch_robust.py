"""The port's robustness layer (``repro_torch.robust``) against the
reference's: fault-injected streams with bounded retry, the checkpoint
store, mid-run resume identical for every registered spec (buffered's
window boundaries, the memmap tail rewrite, a cut-point fuzz), the
checkpoint's layout against the reference's for the same run, 2PS-L
checkpoints resumed across the two packages in both directions (flat and
hosted), and the crash drill through the port's CLI."""
import glob
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core as R
import repro.robust as RR
import repro_torch.core as T
from repro_torch.robust import (ChunkFault, ChunkReadError, EngineCheckpoint,
                                FaultyStream, ResilientFetcher,
                                ResilientStream, RetryPolicy,
                                latest_checkpoint, load_engine_checkpoint,
                                save_engine_checkpoint, spec_hash)
from repro_torch.robust.checkpoint import (CheckpointMismatchError,
                                           check_compatible)

ALL_ALGOS = sorted(T.SPEC_REGISTRY)
_NO_SLEEP = RetryPolicy(max_retries=3, backoff_base_s=0.0)
_SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def tspec(name, chunk_size=512, **overrides):
    """The port's registered spec at the reference tests' geometry."""
    return T.spec_for(name, **overrides).with_test_geometry(chunk_size)


def rspec(name, chunk_size=512, **overrides):
    return R.spec_for(name, **overrides).with_test_geometry(chunk_size)


@pytest.fixture(scope="module")
def seed_graph():
    rng = np.random.default_rng(11)
    e = rng.integers(0, 400, (4000, 2)).astype(np.int32)
    return e[e[:, 0] != e[:, 1]]


def _fresh(seed_graph):
    return T.InMemoryEdgeStream(seed_graph, num_vertices=400)


@pytest.fixture(scope="module")
def stream(seed_graph):
    return _fresh(seed_graph)


def _run(spec, stream, k=8, **kw):
    return T.run_spec(spec, stream, k, device="cpu", **kw)


_REF: dict = {}


def _reference(name, seed_graph, k=8, **overrides):
    key = (name, k, tuple(sorted(overrides.items())))
    if key not in _REF:
        _REF[key] = R.run_spec(
            rspec(name, **overrides),
            R.InMemoryEdgeStream(seed_graph.copy(), num_vertices=400), k)
    return _REF[key]


# ---------------------------------------------------------------------------
# FaultyStream and ResilientStream: the copies behave as the reference's
# ---------------------------------------------------------------------------

def test_faulty_stream_ioerror_raises_then_heals(stream):
    fs = FaultyStream(stream, [ChunkFault(1, "ioerror", count=1)])
    it = fs.iter_chunks(512)
    next(it)
    with pytest.raises(IOError):
        next(it)
    clean = list(stream.iter_chunks(512))
    got = list(fs.iter_chunks_from(512, 1))
    np.testing.assert_array_equal(got[0], clean[1])
    assert fs.fired == 1


def test_faulty_stream_partial_corrupt_and_attempts(stream):
    clean = list(stream.iter_chunks(512))
    fs = FaultyStream(stream, [ChunkFault(0, "partial"),
                               ChunkFault(2, "corrupt")])
    chunks = list(fs.iter_chunks(512))
    assert chunks[0].shape[0] == clean[0].shape[0] // 2
    assert int(chunks[2].max()) >= stream.num_vertices
    np.testing.assert_array_equal(chunks[1], clean[1])
    fs = FaultyStream(stream, [ChunkFault(0, "ioerror", count=2)])
    for _ in range(2):
        with pytest.raises(IOError):
            next(fs.iter_chunks(512))
    np.testing.assert_array_equal(next(fs.iter_chunks(512)), clean[0])
    with pytest.raises(ValueError):
        ChunkFault(0, "gamma-ray")
    with pytest.raises(ValueError):
        ChunkFault(-1)
    with pytest.raises(ValueError):
        FaultyStream(stream, [ChunkFault(0), ChunkFault(0)])


@pytest.mark.parametrize("kind", ["ioerror", "partial", "corrupt"])
def test_resilient_stream_recovers_like_the_reference(seed_graph, kind):
    faults = [ChunkFault(2, kind, count=2), ChunkFault(5, kind)]
    got = ResilientStream(FaultyStream(_fresh(seed_graph), faults),
                          _NO_SLEEP)
    ref = RR.ResilientStream(
        RR.FaultyStream(R.InMemoryEdgeStream(seed_graph, num_vertices=400),
                        [RR.ChunkFault(f.chunk_index, f.kind, f.count)
                         for f in faults]),
        RR.RetryPolicy(max_retries=3, backoff_base_s=0.0))
    for start in (0, 3):
        a = list(got.iter_chunks_from(512, start))
        b = list(ref.iter_chunks_from(512, start))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert got.retries == ref.retries == 3


def test_resilient_stream_exhaustion_and_backoff(stream):
    for start in (0, 3):
        fs = FaultyStream(stream, [ChunkFault(4, "ioerror", count=10 ** 9)])
        rs = ResilientStream(fs, RetryPolicy(max_retries=2,
                                             backoff_base_s=0.0))
        with pytest.raises(ChunkReadError, match="giving up"):
            list(rs.iter_chunks_from(512, start))
        assert rs.retries == 2
    p = RetryPolicy(max_retries=5, backoff_base_s=0.01, backoff_factor=2.0,
                    max_backoff_s=0.03)
    rp = RR.RetryPolicy(max_retries=5, backoff_base_s=0.01,
                        backoff_factor=2.0, max_backoff_s=0.03)
    assert [p.backoff_s(a) for a in range(4)] \
        == [rp.backoff_s(a) for a in range(4)] == [0.01, 0.02, 0.03, 0.03]


@pytest.mark.parametrize("name", ["2psl", "hdrf", "buffered"])
def test_run_spec_retry_policy_is_identical(name, seed_graph):
    """Faults on every read kind, through the degree pass, clustering and
    every partitioning pass: the retried run gives the reference's clean
    assignment and counts each retry."""
    ref = _reference(name, seed_graph)
    faulty = FaultyStream(_fresh(seed_graph),
                          [ChunkFault(0, "ioerror"), ChunkFault(2, "partial"),
                           ChunkFault(4, "corrupt", count=2)])
    res = _run(tspec(name), faulty, retry_policy=_NO_SLEEP)
    assert res.assignment.tobytes() == np.asarray(ref.assignment).tobytes()
    assert res.extras["io_retries"] == 4
    assert res.quality.replication_factor == ref.quality.replication_factor


# ---------------------------------------------------------------------------
# ResilientFetcher
# ---------------------------------------------------------------------------

def test_resilient_fetcher_passthrough_retry_and_degrade():
    feat = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    f = ResilientFetcher(lambda g: feat[g], 4, policy=_NO_SLEEP)
    np.testing.assert_array_equal(f(np.array([3, 9, 11])), feat[[3, 9, 11]])
    calls = {"n": 0}

    def flaky(gids):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise IOError("shard down")
        return feat[gids]

    f = ResilientFetcher(flaky, 4, policy=_NO_SLEEP)
    np.testing.assert_array_equal(f(np.array([5, 6])), feat[[5, 6]])
    assert f.retries == 2 and f.failures == 0

    def dead(gids):
        raise IOError("shard gone")

    f = ResilientFetcher(dead, 4, policy=RetryPolicy(max_retries=1,
                                                     backoff_base_s=0.0))
    np.testing.assert_array_equal(f(np.array([1, 2, 3])),
                                  np.zeros((3, 4), np.float32))
    assert f.stats()["failures"] == 3
    f = ResilientFetcher(lambda g: np.zeros((len(g), 7), np.float32), 4,
                         policy=RetryPolicy(max_retries=0))
    np.testing.assert_array_equal(f(np.array([0, 1])),
                                  np.zeros((2, 4), np.float32))
    assert f.failures == 2


def test_resilient_fetcher_times_out_hung_fetch():
    f = ResilientFetcher(lambda g: time.sleep(2.0), 2, timeout_s=0.05,
                         policy=RetryPolicy(max_retries=0))
    t0 = time.perf_counter()
    rows = f(np.array([0]))
    assert time.perf_counter() - t0 < 5.0
    np.testing.assert_array_equal(rows, np.zeros((1, 2), np.float32))
    assert f.failures == 1


# ---------------------------------------------------------------------------
# the checkpoint store
# ---------------------------------------------------------------------------

def _meta(spec, stream, k=8, next_chunk=1, **kw):
    base = {"spec_hash": spec_hash(spec), "algorithm": spec.algorithm,
            "k": k, "num_edges": stream.num_edges,
            "num_vertices": stream.num_vertices, "chunk_size": 512,
            "pass_index": 0, "next_chunk": next_chunk,
            "edge_lo": next_chunk * 512, "assigned": 0, "pass_counts": {},
            "resumes": 0, "assignment_in_checkpoint": True}
    base.update(kw)
    return base


def test_checkpoint_roundtrip_and_reference_reads_it(tmp_path, stream):
    spec = T.spec_for("2psl", chunk_size=512)
    assert spec_hash(spec) == RR.spec_hash(R.spec_for("2psl",
                                                      chunk_size=512))
    ck = EngineCheckpoint(
        meta=_meta(spec, stream),
        device_state={"sizes": np.arange(8, dtype=np.int32)},
        host_state={"bits": np.arange(12, dtype=np.uint32)},
        assignment=np.full(stream.num_edges, -1, np.int32))
    save_engine_checkpoint(str(tmp_path), ck)
    for load in (load_engine_checkpoint, RR.load_engine_checkpoint):
        got = load(str(tmp_path))
        assert got.meta == ck.meta
        assert got.device_state["sizes"].dtype == np.int32
        assert got.host_state["bits"].dtype == np.uint32
        np.testing.assert_array_equal(got.host_state["bits"],
                                      ck.host_state["bits"])
        np.testing.assert_array_equal(got.assignment, ck.assignment)


def test_latest_checkpoint_ignores_tmp_and_keeps_n(tmp_path, stream):
    spec = T.spec_for("2psl", chunk_size=512)
    for nc in (1, 2, 3, 4):
        save_engine_checkpoint(
            str(tmp_path),
            EngineCheckpoint(meta=_meta(spec, stream, next_chunk=nc)),
            keep_n=2)
    done = sorted(d for d in os.listdir(tmp_path) if not d.endswith(".tmp"))
    assert done == ["ckpt_00_00000003", "ckpt_00_00000004"]
    os.makedirs(tmp_path / "ckpt_00_00000009.tmp")
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_00_00000004")
    assert latest_checkpoint(str(tmp_path / "nope")) is None
    assert load_engine_checkpoint(str(tmp_path / "nope")) is None


def test_check_compatible_rejects_mismatches(tmp_path, stream):
    spec = T.spec_for("2psl", chunk_size=512)
    meta = _meta(spec, stream)
    check_compatible(meta, spec, stream, 8, None)
    with pytest.raises(CheckpointMismatchError, match="PartitionerSpec"):
        check_compatible(meta, T.spec_for("2psl", chunk_size=512,
                                          alpha=1.3), stream, 8, None)
    with pytest.raises(CheckpointMismatchError, match="k="):
        check_compatible(meta, spec, stream, 16, None)
    with pytest.raises(CheckpointMismatchError, match="assignment sink"):
        check_compatible(meta, spec, stream, 8, str(tmp_path / "a.bin"))
    meta2 = dict(meta, assignment_in_checkpoint=False)
    with pytest.raises(CheckpointMismatchError, match="does not exist"):
        check_compatible(meta2, spec, stream, 8, str(tmp_path / "a.bin"))


def test_crash_hook_reads_the_reference_variable(monkeypatch):
    from repro_torch.robust.checkpoint import crash_after_checkpoints
    exits = []
    monkeypatch.setattr(os, "_exit", exits.append)
    monkeypatch.delenv("REPRO_CRASH_AFTER_CHECKPOINTS", raising=False)
    crash_after_checkpoints(5)
    monkeypatch.setenv("REPRO_CRASH_AFTER_CHECKPOINTS", "2")
    crash_after_checkpoints(1)
    crash_after_checkpoints(2)
    assert exits == [137]


# ---------------------------------------------------------------------------
# engine resume: identical restart for every spec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ALL_ALGOS)
def test_resume_from_mid_run_checkpoint_identical(name, seed_graph, stream,
                                                  tmp_path):
    """Checkpoint every 3 chunks, restart from the latest snapshot: the
    replay gives the reference's uninterrupted assignment (for the 2PS
    specs the snapshot sits inside the scoring pass, so its state is
    post-``setup``: the bits uploaded and folded since)."""
    ref = _reference(name, seed_graph)
    spec = tspec(name)
    d = str(tmp_path / "ck")
    res0 = _run(spec, stream, checkpoint_every_chunks=3, checkpoint_dir=d)
    assert res0.assignment.tobytes() == np.asarray(ref.assignment).tobytes()
    assert res0.extras["checkpoints_written"] > 0
    ck = load_engine_checkpoint(d)
    if name in ("2psl", "2ps-hdrf"):
        assert ck.meta["pass_index"] == 1
        assert "bits" in ck.device_state
    res = _run(spec, stream, resume_from=d)
    assert res.assignment.tobytes() == np.asarray(ref.assignment).tobytes()
    assert res.extras["resumes"] == 1
    assert res.quality.replication_factor == ref.quality.replication_factor
    assert res.quality.balance == ref.quality.balance


def test_buffered_checkpoints_at_window_boundaries(seed_graph, stream,
                                                   tmp_path):
    spec = tspec("buffered")
    eff = spec.chunk_size * spec.window_chunks
    assert spec.window_chunks == 2
    clean = _reference("buffered", seed_graph)
    d = str(tmp_path / "ck")
    _run(spec, stream, checkpoint_every_chunks=3, checkpoint_dir=d)
    ck = load_engine_checkpoint(d)
    assert ck.meta["next_chunk"] == 3
    assert ck.meta["edge_lo"] == 3 * eff
    assert {"bits", "sizes", "wv2c", "wc2p", "wvol"} <= set(ck.device_state)
    res = _run(spec, stream, resume_from=d)
    assert res.assignment.tobytes() == np.asarray(clean.assignment).tobytes()
    assert res.extras["resumes"] == 1
    assert res.extras["windows"] < clean.extras["windows"]


@pytest.mark.parametrize("name", ["hdrf", "greedy", "random"])
def test_interrupted_run_resumes_identical(name, seed_graph, stream,
                                           tmp_path):
    """A permanent IO fault aborts the run after two checkpoints; a resumed
    run on a healthy stream finishes into the clean assignment."""
    spec = tspec(name)
    clean = _reference(name, seed_graph)
    d = str(tmp_path / "ck")
    dead = FaultyStream(_fresh(seed_graph),
                        [ChunkFault(5 if name == "hdrf" else 3, "ioerror",
                                    count=10 ** 9)])
    with pytest.raises(IOError):
        _run(spec, dead, checkpoint_every_chunks=2, checkpoint_dir=d)
    assert latest_checkpoint(d) is not None
    res = _run(spec, stream, checkpoint_every_chunks=2, checkpoint_dir=d,
               resume_from=d)
    assert res.assignment.tobytes() == np.asarray(clean.assignment).tobytes()
    assert res.extras["resumes"] == 1


@pytest.mark.parametrize("name,torn", [("hdrf", True), ("2psl", False)])
def test_resume_memmap_out_path_rewrites_tail(name, torn, seed_graph, stream,
                                              tmp_path):
    """Memmap runs re-open out_path in place.  In a single pass, garbage
    past the cursor (a torn post-checkpoint write) is rewritten by the
    replay; 2PS-L's scoring pass merges (it writes only the rows it
    assigns, in both packages), so there the tail is left as the crashed
    run wrote it."""
    spec = T.spec_for(name, chunk_size=512)
    out_clean = str(tmp_path / "clean.bin")
    _run(spec, stream, out_path=out_clean)
    out = str(tmp_path / "a.bin")
    d = str(tmp_path / "ck")
    _run(spec, stream, out_path=out, checkpoint_every_chunks=3,
         checkpoint_dir=d)
    ck = load_engine_checkpoint(d)
    assert not ck.meta["assignment_in_checkpoint"] and ck.assignment is None
    if torn:
        mm = np.memmap(out, dtype=np.int32, mode="r+")
        mm[ck.meta["edge_lo"]:] = 7
        mm.flush()
        del mm
    res = _run(spec, stream, out_path=out, resume_from=d)
    assert isinstance(res.assignment, np.memmap)
    assert open(out, "rb").read() == open(out_clean, "rb").read()


def test_resume_memmap_vs_inmemory_modality_guard(stream, tmp_path):
    spec = T.spec_for("random", chunk_size=1024)
    d = str(tmp_path / "ck")
    _run(spec, stream, checkpoint_every_chunks=2, checkpoint_dir=d)
    with pytest.raises(CheckpointMismatchError, match="assignment sink"):
        _run(spec, stream, out_path=str(tmp_path / "a.bin"), resume_from=d)


def test_resume_from_empty_dir_is_fresh_run(seed_graph, stream, tmp_path):
    res = _run(tspec("2psl"), stream, resume_from=str(tmp_path / "none"))
    ref = _reference("2psl", seed_graph)
    assert res.assignment.tobytes() == np.asarray(ref.assignment).tobytes()
    assert "resumes" not in res.extras


def test_resume_counts_spans_and_gauge(seed_graph, stream, tmp_path):
    """The ``resume`` and ``checkpoint`` spans and the ``engine.resumes``
    / ``engine.checkpoints`` counters, as in the reference; HEP's
    replication gauge is refreshed on restore (its pinned rows)."""
    from repro_torch import obs
    spec = tspec("hep")
    d = str(tmp_path / "ck")
    tr, reg = obs.Tracer(), obs.MetricsRegistry()
    _run(spec, stream, checkpoint_every_chunks=2, checkpoint_dir=d,
         tracer=tr, metrics=reg)
    n_ck = reg.snapshot()["engine.checkpoints"]["value"]
    assert n_ck == sum(1 for e in obs.chrome_trace(tr)["traceEvents"]
                       if e.get("name") == "checkpoint")
    assert n_ck >= 2
    tr, reg = obs.Tracer(), obs.MetricsRegistry()
    res = _run(spec, stream, resume_from=d, tracer=tr, metrics=reg)
    snap = reg.snapshot()
    assert snap["engine.resumes"]["value"] == 1
    names = {e.get("name") for e in obs.chrome_trace(tr)["traceEvents"]}
    assert "resume" in names and "init" not in names
    assert snap["engine.replication_state_bytes"]["value"] \
        == res.extras["hot_state_bytes"]
    assert "resume" in res.timings


@settings(max_examples=6, deadline=None)
@given(name=st.sampled_from(ALL_ALGOS),
       seed=st.integers(min_value=0, max_value=2 ** 31 - 1),
       depth=st.sampled_from((1, 2, 4)), every=st.sampled_from((1, 2, 3)))
def test_resume_equivalence_fuzz(name, seed, depth, every,
                                 tmp_path_factory):
    """Kill at any checkpoint boundary: for fuzzed graphs, pipeline depths
    and intervals, resuming from each retained checkpoint replays into
    the uninterrupted assignment."""
    rng = np.random.default_rng(seed)
    n_v = int(rng.integers(16, 200))
    e = rng.integers(0, n_v, (int(rng.integers(600, 3000)), 2))
    e = e[e[:, 0] != e[:, 1]].astype(np.int32)
    if not len(e):
        return
    s = T.InMemoryEdgeStream(e, num_vertices=n_v)
    spec = tspec(name, pipeline_depth=depth)
    clean = T.run_spec(spec, s, 4, device="cpu")
    d = str(tmp_path_factory.mktemp("resume") / "ck")
    T.run_spec(spec, s, 4, device="cpu", checkpoint_every_chunks=every,
               checkpoint_dir=d)
    for ck in sorted(glob.glob(os.path.join(d, "ckpt_*"))):
        one = str(tmp_path_factory.mktemp("one") / "ck")
        os.makedirs(one)
        os.rename(ck, os.path.join(one, os.path.basename(ck)))
        res = T.run_spec(spec, s, 4, device="cpu", resume_from=one)
        assert res.assignment.tobytes() == clean.assignment.tobytes(), \
            (name, seed, depth, every, os.path.basename(ck))


# ---------------------------------------------------------------------------
# the checkpoint's layout, and resume across the two packages
# ---------------------------------------------------------------------------

def _arrays_equal(a: dict, b: dict, what: str) -> None:
    assert sorted(a) == sorted(b), what
    for key in a:
        assert a[key].dtype == b[key].dtype, (what, key)
        assert a[key].shape == b[key].shape, (what, key)
        assert a[key].tobytes() == b[key].tobytes(), (what, key)


@pytest.mark.parametrize("name", ALL_ALGOS)
def test_checkpoint_layout_matches_reference(name, seed_graph, tmp_path):
    """For the same run and interval the port writes the reference's
    checkpoints: the same directories, meta, device and host arrays
    (word matrices as uint32), and in-memory assignment."""
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    R.run_spec(rspec(name),
               R.InMemoryEdgeStream(seed_graph.copy(), num_vertices=400), 8,
               checkpoint_every_chunks=2, checkpoint_dir=d_ref)
    _run(tspec(name), _fresh(seed_graph), checkpoint_every_chunks=2,
         checkpoint_dir=d_port)
    assert sorted(os.listdir(d_ref)) == sorted(os.listdir(d_port))
    ref = RR.load_engine_checkpoint(d_ref)
    port = load_engine_checkpoint(d_port)
    assert port.meta == ref.meta
    _arrays_equal(port.device_state, ref.device_state, "device")
    _arrays_equal(port.host_state, ref.host_state, "host")
    assert port.assignment.tobytes() == ref.assignment.tobytes()
    for key in ("bits", "hbits"):
        for group in (port.device_state, port.host_state):
            if key in group:
                assert group[key].dtype == np.uint32


_CROSS = [("flat", {}), ("hosted", {"host_groups": 2, "dcn_penalty": 1.0})]


class _Killed(Exception):
    pass


def _crash_after(monkeypatch, n: int) -> None:
    """``REPRO_CRASH_AFTER_CHECKPOINTS=n`` in this process, with the hard
    exit turned into an exception: both packages' runs stop right after
    their nth checkpoint, as a killed process would."""
    def _exit(code):
        raise _Killed(code)
    monkeypatch.setenv("REPRO_CRASH_AFTER_CHECKPOINTS", str(n))
    monkeypatch.setattr(os, "_exit", _exit)


#: (checkpoints before the crash, pass of the last one): every 2 chunks of
#: eight, the 2nd lands in pre-partitioning and the 6th in scoring
_CUTS = [(2, 0), (6, 1)]


@pytest.mark.parametrize("cut,pass_index", _CUTS)
@pytest.mark.parametrize("layout,kw", _CROSS, ids=[c[0] for c in _CROSS])
def test_reference_checkpoint_resumes_in_the_port(layout, kw, cut,
                                                  pass_index, seed_graph,
                                                  tmp_path, monkeypatch):
    """2PS-L: a run of the reference killed after a checkpoint, resumed by
    the port, gives the reference's uninterrupted assignment."""
    ref = _reference("2psl", seed_graph, **kw)
    d = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _crash_after(m, cut)
        with pytest.raises(_Killed):
            R.run_spec(rspec("2psl", **kw),
                       R.InMemoryEdgeStream(seed_graph.copy(),
                                            num_vertices=400), 8,
                       checkpoint_every_chunks=2, checkpoint_dir=d)
    assert load_engine_checkpoint(d).meta["pass_index"] == pass_index
    res = _run(tspec("2psl", **kw), _fresh(seed_graph), resume_from=d)
    assert res.assignment.tobytes() == np.asarray(ref.assignment).tobytes()
    assert res.extras["resumes"] == 1
    if kw:
        assert res.extras["cross_host_rf"] == ref.extras["cross_host_rf"]


@pytest.mark.parametrize("cut,pass_index", _CUTS)
@pytest.mark.parametrize("layout,kw", _CROSS, ids=[c[0] for c in _CROSS])
def test_port_checkpoint_resumes_in_the_reference(layout, kw, cut,
                                                  pass_index, seed_graph,
                                                  tmp_path, monkeypatch):
    ref = _reference("2psl", seed_graph, **kw)
    d = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        _crash_after(m, cut)
        with pytest.raises(_Killed):
            _run(tspec("2psl", **kw), _fresh(seed_graph),
                 checkpoint_every_chunks=2, checkpoint_dir=d)
    assert RR.load_engine_checkpoint(d).meta["pass_index"] == pass_index
    res = R.run_spec(rspec("2psl", **kw),
                     R.InMemoryEdgeStream(seed_graph.copy(),
                                          num_vertices=400), 8,
                     resume_from=d)
    assert np.asarray(res.assignment).tobytes() \
        == np.asarray(ref.assignment).tobytes()
    assert res.extras["resumes"] == 1


# ---------------------------------------------------------------------------
# the crash drill through the port's CLI
# ---------------------------------------------------------------------------

def _cli(graph_bin, artifact_dir, *extra, env_extra=None):
    env = dict(os.environ,
               PYTHONPATH=_SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.partition",
         "--input", graph_bin, "--k", "8", "--algorithm", "2psl",
         "--chunk-size", "512", "--artifact-dir", artifact_dir,
         "--no-plan", "--device", "cpu", "--json", *extra],
        env=env, capture_output=True, text=True)


def _sha(path):
    return hashlib.sha256(open(path, "rb").read()).hexdigest()


def test_cli_kill_and_resume(seed_graph, tmp_path):
    """The port's CLI is killed hard after its second checkpoint
    (``REPRO_CRASH_AFTER_CHECKPOINTS``, the reference's variable), then
    ``--resume``d: the assignment bytes are the uninterrupted run's and
    the reference's, and the manifest records the resume."""
    graph_bin = str(tmp_path / "graph.bin")
    seed_graph.astype(np.uint32).tofile(graph_bin)
    clean_dir = str(tmp_path / "clean")
    p = _cli(graph_bin, clean_dir)
    assert p.returncode == 0, p.stderr
    clean_sha = _sha(os.path.join(clean_dir, "assignment.bin"))
    ref = R.run_spec(R.spec_for("2psl", chunk_size=512),
                     R.InMemoryEdgeStream(seed_graph.copy()), 8)
    assert clean_sha == hashlib.sha256(
        np.asarray(ref.assignment).tobytes()).hexdigest()

    crash_dir = str(tmp_path / "crash")
    p = _cli(graph_bin, crash_dir, "--checkpoint-every", "2",
             env_extra={"REPRO_CRASH_AFTER_CHECKPOINTS": "2"})
    assert p.returncode == 137, (p.returncode, p.stderr)
    assert not os.path.exists(os.path.join(crash_dir, "manifest.json"))

    p = _cli(graph_bin, crash_dir, "--checkpoint-every", "2", "--resume")
    assert p.returncode == 0, p.stderr
    report = json.loads(p.stdout)
    assert report["resumes"] == 1
    assert _sha(os.path.join(crash_dir, "assignment.bin")) == clean_sha
    manifest = json.load(open(os.path.join(crash_dir, "manifest.json")))
    assert manifest["extras"]["resumes"] >= 1
    assert "assignment.bin" in manifest["integrity"]["files"]
    R.PartitionArtifact.load(crash_dir)


def test_cli_io_retries_flag(seed_graph, tmp_path, capsys):
    from repro_torch.launch.partition import main
    graph_bin = str(tmp_path / "graph.bin")
    seed_graph.astype(np.uint32).tofile(graph_bin)
    common = ["--input", graph_bin, "--k", "8", "--algorithm", "random",
              "--chunk-size", "512", "--device", "cpu", "--json"]
    main(common + ["--out", str(tmp_path / "a.bin")])
    capsys.readouterr()
    main(common + ["--out", str(tmp_path / "b.bin"), "--io-retries", "2"])
    assert json.loads(capsys.readouterr().out)["io_retries"] == 0
    assert ((tmp_path / "a.bin").read_bytes()
            == (tmp_path / "b.bin").read_bytes())

