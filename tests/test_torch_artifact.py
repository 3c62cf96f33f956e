"""The port's partition artifact (``repro_torch.core.artifact``) against the
reference's: for every registered spec the two packages write the same
sidecars byte for byte (assignment, halo plan, host plan, local CSCs) and
checksums, each package loads the other's artifact, integrity checks
refuse flipped and missing files, and the port's CLI takes every flag of
the reference's (``--torch-profile`` for ``--jax-profile``), refusing the
same argument mixes and writing the same artifact."""
import contextlib
import dataclasses
import glob
import io
import json
import os
import re

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.sample import build_local_graphs as ref_build_local_graphs
from repro_torch import obs
from repro_torch.robust import ArtifactIntegrityError
from repro_torch.sample import build_local_graphs

ALL_ALGOS = sorted(T.SPEC_REGISTRY)
K = 8


@pytest.fixture(scope="module")
def seed_graph():
    rng = np.random.default_rng(42)
    e = rng.integers(0, 300, (3000, 2)).astype(np.int32)
    return e[e[:, 0] != e[:, 1]]


def _stream(pkg, edges):
    return pkg.InMemoryEdgeStream(edges.copy(), num_vertices=300)


def _save_both(name, edges, tmp_path, *, host_groups=2, local=True):
    """Both packages run ``name`` at the test geometry and save an artifact
    with the in-memory halo plan, the host plan and the local graphs."""
    dirs = {}
    for tag, pkg, kw in (("ref", R, {}), ("port", T, {"device": "cpu"})):
        spec = pkg.spec_for(name).with_test_geometry(512)
        res = pkg.run_spec(spec, _stream(pkg, edges), K, **kw)
        d = str(tmp_path / tag)
        art = pkg.PartitionArtifact.save(
            d, res, num_vertices=300, num_edges=len(edges), edges=edges,
            host_groups=host_groups)
        if local:
            (ref_build_local_graphs if pkg is R else build_local_graphs)(
                art, _stream(pkg, edges), chunk_size=700)
        dirs[tag] = d
    return dirs["ref"], dirs["port"]


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def _same_manifests(m_ref, m_port):
    """Equal but for the timings, the stall report and the port's route."""
    m_ref, m_port = dict(m_ref), dict(m_port)
    for m in (m_ref, m_port):
        m.pop("timings_s")
        m.pop("stall_report")
    route = m_port["extras"].pop("kernel_backend", "torch-cpu")
    assert route == "torch-cpu"
    assert m_port == m_ref


@pytest.mark.parametrize("name", ALL_ALGOS)
def test_sidecars_byte_equal_and_cross_loadable(name, seed_graph, tmp_path):
    d_ref, d_port = _save_both(name, seed_graph, tmp_path)
    files = sorted(os.listdir(d_ref))
    assert files == sorted(os.listdir(d_port))
    assert {"assignment.bin", "halo_plan.npz", "host_plan.npz",
            "manifest.json"} <= set(files)
    assert sum(f.startswith("local_csc_p") for f in files) == K
    for f in files:
        if f != "manifest.json":
            assert (open(os.path.join(d_ref, f), "rb").read()
                    == open(os.path.join(d_port, f), "rb").read()), f
    m_ref, m_port = _manifest(d_ref), _manifest(d_port)
    assert m_port["integrity"] == m_ref["integrity"]
    assert m_port["format_version"] == 4
    _same_manifests(m_ref, m_port)
    # each package loads (and verifies) the other's artifact
    theirs = R.PartitionArtifact.load(d_port)
    ours = T.PartitionArtifact.load(d_ref)
    assert theirs.spec == R.spec_for(name).with_test_geometry(512)
    assert ours.spec == T.spec_for(name).with_test_geometry(512)
    np.testing.assert_array_equal(np.asarray(theirs.assignment),
                                  np.asarray(ours.assignment))
    for a, b in ((theirs.halo_plan(), ours.halo_plan()),
                 (theirs.host_halo_plan().base, ours.host_halo_plan().base)):
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes()
            else:
                assert va == vb, f.name
    assert theirs.host_halo_plan().dcn_summary() \
        == ours.host_halo_plan().dcn_summary()
    for p in range(K):
        a, b = theirs.local_graph(p), ours.local_graph(p)
        for arr in a._ARRAYS:
            np.testing.assert_array_equal(getattr(a, arr), getattr(b, arr))


def test_artifact_roundtrip_and_plan_is_fresh(seed_graph, tmp_path):
    """Reload is identical and the cached plan equals a fresh plan of the
    port and of the reference, field for field."""
    from repro.dist.partitioned_gnn import plan_halo_exchange as ref_plan
    from repro_torch.dist import plan_halo_exchange
    stream = _stream(T, seed_graph)
    spec = T.spec_for("2psl", chunk_size=512)
    res = T.run_spec(spec, stream, 4, device="cpu")
    d = str(tmp_path / "art")
    T.PartitionArtifact.save(d, res, num_vertices=300,
                             num_edges=stream.num_edges, edges=seed_graph)
    art = T.PartitionArtifact.load(d)
    np.testing.assert_array_equal(np.asarray(art.assignment), res.assignment)
    assert art.assignment.dtype == np.int32
    assert art.spec == spec and art.k == 4
    assert (art.num_edges, art.num_vertices) == (stream.num_edges, 300)
    cached = art.halo_plan()
    for fresh in (plan_halo_exchange(seed_graph, res.assignment, 300, 4),
                  ref_plan(seed_graph, res.assignment.copy(), 300, 4)):
        for f in dataclasses.fields(fresh):
            a, b = getattr(cached, f.name), getattr(fresh, f.name)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, f.name


def test_streamed_planning_equals_in_memory(seed_graph, tmp_path):
    """``save(stream=...)`` plans out-of-core against the assignment
    memmap the engine wrote in place (flushed, not rewritten): the same
    files as the in-memory plan."""
    dirs = {}
    for how in ("edges", "stream"):
        d = str(tmp_path / how)
        os.makedirs(d)
        out = os.path.join(d, "assignment.bin")
        res = T.run_spec(T.spec_for("hdrf", chunk_size=512),
                         _stream(T, seed_graph), K, device="cpu",
                         out_path=out)
        kw = ({"edges": seed_graph} if how == "edges"
              else {"stream": _stream(T, seed_graph)})
        T.PartitionArtifact.save(d, res, num_vertices=300,
                                 num_edges=len(seed_graph), host_groups=4,
                                 **kw)
        dirs[how] = d
    for f in ("assignment.bin", "halo_plan.npz", "host_plan.npz"):
        assert (open(os.path.join(dirs["edges"], f), "rb").read()
                == open(os.path.join(dirs["stream"], f), "rb").read()), f


def test_artifact_without_plan_and_needs_no_graph(seed_graph, tmp_path):
    res = T.run_spec(T.spec_for("grid"), _stream(T, seed_graph), 4,
                     device="cpu")
    d = str(tmp_path / "art")
    T.PartitionArtifact.save(d, res, num_vertices=300,
                             num_edges=len(seed_graph))
    art = T.PartitionArtifact.load(d)
    assert not art.has_halo_plan() and art.manifest["halo_plan"] is None
    with pytest.raises(FileNotFoundError):
        art.halo_plan()
    with pytest.raises(FileNotFoundError):
        art.host_halo_plan()
    with pytest.raises(FileNotFoundError):
        art.local_graph(0)
    with pytest.raises(ValueError, match="host_groups"):
        T.PartitionArtifact.save(str(tmp_path / "b"), res, num_vertices=300,
                                 num_edges=len(seed_graph), host_groups=2)
    res.spec = None
    with pytest.raises(ValueError):
        T.PartitionArtifact.save(str(tmp_path / "c"), res, num_vertices=300,
                                 num_edges=len(seed_graph))
    d2 = str(tmp_path / "plan")
    res2 = T.run_spec(T.spec_for("random"), _stream(T, seed_graph), 4,
                      device="cpu")
    T.PartitionArtifact.save(d2, res2, num_vertices=300,
                             num_edges=len(seed_graph), edges=seed_graph)
    plan = T.PartitionArtifact.load(d2).halo_plan()
    assert plan.k == 4 and plan.edge_mask.sum() == len(seed_graph)
    assert sorted(os.listdir(d2)) == ["assignment.bin", "halo_plan.npz",
                                      "manifest.json"]


# ---------------------------------------------------------------------------
# integrity (manifest format 4)
# ---------------------------------------------------------------------------

@pytest.fixture()
def saved(seed_graph, tmp_path):
    _, d_port = _save_both("2psl", seed_graph, tmp_path, local=False)
    return d_port


def test_v4_checksums_every_sidecar(saved):
    art = T.PartitionArtifact.load(saved)
    files = art.manifest["integrity"]["files"]
    assert set(files) == {"assignment.bin", "halo_plan.npz",
                          "host_plan.npz"}
    assert all(v.startswith("sha256:") for v in files.values())
    assert not glob.glob(os.path.join(saved, "*.tmp*"))


@pytest.mark.parametrize("victim", ["assignment.bin", "halo_plan.npz",
                                    "host_plan.npz"])
def test_load_rejects_bit_flip(saved, victim):
    p = os.path.join(saved, victim)
    blob = bytearray(open(p, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(p, "wb").write(bytes(blob))
    with pytest.raises(ArtifactIntegrityError, match=victim):
        T.PartitionArtifact.load(saved)
    T.PartitionArtifact.load(saved, verify=False)


def test_load_rejects_missing_sidecar_and_bad_version(saved):
    os.remove(os.path.join(saved, "halo_plan.npz"))
    with pytest.raises(ArtifactIntegrityError, match="missing"):
        T.PartitionArtifact.load(saved)
    m = _manifest(saved)
    m["format_version"] = 9
    with open(os.path.join(saved, "manifest.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="unsupported artifact format"):
        T.PartitionArtifact.load(saved)


def test_pre_v4_loads_without_verification(saved):
    m = _manifest(saved)
    m.pop("integrity")
    m["format_version"] = 3
    with open(os.path.join(saved, "manifest.json"), "w") as f:
        json.dump(m, f)
    with open(os.path.join(saved, "halo_plan.npz"), "ab") as f:
        f.write(b"x")
    assert T.PartitionArtifact.load(saved).manifest["format_version"] == 3


def test_register_local_graphs_extends_integrity(saved, seed_graph):
    build_local_graphs(saved, _stream(T, seed_graph))
    files = T.PartitionArtifact.load(saved).manifest["integrity"]["files"]
    victim = next(f for f in files if f.startswith("local_csc_p"))
    assert sum(f.startswith("local_csc_p") for f in files) == K
    with open(os.path.join(saved, victim), "ab") as f:
        f.write(b"x")
    for load in (T.PartitionArtifact.load, R.PartitionArtifact.load):
        with pytest.raises(Exception, match=victim):
            load(saved)


# ---------------------------------------------------------------------------
# the CLI: every flag of the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graph_bin(seed_graph, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "g.bin")
    seed_graph.astype(np.uint32).tofile(path)
    return path


def _both_cli(argv, capsys):
    """Run both CLIs on ``argv`` (the port on the CPU): their parsed JSON
    reports, or their usage errors' (exit code, last stderr line)."""
    from repro.launch.partition import main as ref_main
    from repro_torch.launch.partition import main as port_main
    out = []
    for main, extra in ((ref_main, []), (port_main, ["--device", "cpu"])):
        try:
            main(argv + extra)
        except SystemExit as e:
            err = capsys.readouterr().err.strip().splitlines()[-1]
            out.append((e.code, err))
            continue
        out.append(json.loads(capsys.readouterr().out))
    return out


_BAD = [
    ["--hosts", "2", "--artifact-dir", "{d}", "--no-plan"],
    ["--local-graphs"],
    ["--dcn-penalty", "1.0"],
    ["--checkpoint-every", "2"],
    ["--resume"],
    ["--scoring-backend", "cuda"],
    ["--algorithm", "random", "--dcn-penalty", "1.0", "--hosts", "2"],
    ["--algorithm", "hdrf", "--buffer-edges", "4096"],
]


@pytest.mark.parametrize("bad", _BAD, ids=[" ".join(b) for b in _BAD])
def test_cli_argument_errors_match_the_reference(bad, graph_bin, tmp_path,
                                                 capsys):
    argv = ["--input", graph_bin, "--k", "8", "--json"] + [
        a.format(d=str(tmp_path / "art")) for a in bad]
    ref, port = _both_cli(argv, capsys)
    assert ref[0] == port[0] == 2
    assert ref[1] == port[1]


def test_cli_full_artifact_run_matches_the_reference(graph_bin, tmp_path,
                                                     capsys):
    """``--artifact-dir --local-graphs --plan-json --hosts --dcn-penalty
    --pair-cap-quantile --throttle-mbps --trace --trace-summary``: the
    same files, the same report keys (plus the port's ``device`` and
    ``kernel_backend``), a valid trace with the planning spans."""
    runs = {}
    for tag in ("ref", "port"):
        runs[tag] = [
            "--input", graph_bin, "--k", "8", "--chunk-size", "512",
            "--hosts", "2", "--dcn-penalty", "1.0",
            "--pair-cap-quantile", "0.5", "--throttle-mbps", "1",
            "--artifact-dir", str(tmp_path / tag), "--local-graphs",
            "--plan-json", str(tmp_path / f"{tag}.json"),
            "--trace", str(tmp_path / f"{tag}_trace.json"),
            "--trace-summary", "--json"]
    from repro.launch.partition import main as ref_main
    from repro_torch.launch.partition import main as port_main
    ref_main(runs["ref"])
    ref = json.loads(capsys.readouterr().out)
    port_main(runs["port"] + ["--device", "cpu"])
    cap = capsys.readouterr()
    port = json.loads(cap.out)
    assert "critical" in cap.err
    assert set(port) - set(ref) == {"device", "kernel_backend"}
    assert set(ref) - set(port) == set()
    for key in ("edges", "replication_factor", "b_cap", "v_cap",
                "host_plan", "local_graphs", "simulated_io_s"):
        assert port[key] == ref[key], key
    assert port["simulated_io_s"] > 0
    for f in sorted(os.listdir(tmp_path / "ref")):
        if f != "manifest.json":
            assert ((tmp_path / "ref" / f).read_bytes()
                    == (tmp_path / "port" / f).read_bytes()), f
    _same_manifests(_manifest(str(tmp_path / "ref")),
                    _manifest(str(tmp_path / "port")))
    p_ref = json.load(open(tmp_path / "ref.json"))
    p_port = json.load(open(tmp_path / "port.json"))
    for m in (p_ref, p_port):
        m.pop("assignment_path")
    assert p_port == p_ref
    doc = json.load(open(tmp_path / "port_trace.json"))
    names = obs.validate_chrome_trace(doc)
    assert {"pass:prepartition", "pass:scoring", "halo_plan", "host_plan",
            "local_graphs"} <= names


def test_cli_scoring_backend_is_recorded_and_changes_nothing(graph_bin,
                                                             tmp_path,
                                                             capsys):
    from repro_torch.launch.partition import main
    for backend in ("jnp", "pallas"):
        main(["--input", graph_bin, "--k", "8", "--chunk-size", "512",
              "--scoring-backend", backend, "--device", "cpu",
              "--artifact-dir", str(tmp_path / backend), "--no-plan"])
        capsys.readouterr()
    m = _manifest(str(tmp_path / "pallas"))
    assert m["spec"]["scoring_backend"] == "pallas"
    assert m["extras"]["kernel_backend"] == "torch-cpu"
    assert R.PartitionArtifact.load(str(tmp_path / "pallas")).spec \
        .scoring_backend == "pallas"
    assert ((tmp_path / "jnp" / "assignment.bin").read_bytes()
            == (tmp_path / "pallas" / "assignment.bin").read_bytes())


def test_cli_torch_profile_writes_a_trace(graph_bin, tmp_path, capsys):
    from repro_torch.launch.partition import main
    prof = str(tmp_path / "prof")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--input", graph_bin, "--k", "8", "--chunk-size", "512",
              "--torch-profile", prof, "--device", "cpu", "--json"])
    report = json.loads(buf.getvalue())
    assert report["torch_profile"] == prof
    assert report["critical_stage"]
    with open(os.path.join(prof, obs.TORCH_TRACE_FILE)) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
    with obs.torch_profiler_session(None) as prof_none:
        assert prof_none is None


def test_cli_offers_every_reference_flag(capsys):
    """Every option of the reference's CLI but ``--jax-profile``, whose
    counterpart is ``--torch-profile``."""
    from repro.launch.partition import main as ref_main
    from repro_torch.launch.partition import main as port_main
    usage = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        with pytest.raises(SystemExit):
            main(["--help"])
        usage[tag] = set(re.findall(r"^\s+(--[a-z][a-z-]*)",
                                    capsys.readouterr().out, re.M))
    assert {"--artifact-dir", "--resume", "--trace"} <= usage["ref"]
    assert usage["ref"] - usage["port"] == {"--jax-profile"}
    assert usage["port"] - usage["ref"] == {"--torch-profile", "--device"}
