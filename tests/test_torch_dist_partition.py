"""The port's distributed partitioning CLI
(``repro_torch.launch.dist_partition``) against the reference's: every flag
of the reference's (``--backend torch`` for ``jax``, ``--device`` added), the
same argument checks, the emulated artifact equal to the reference CLI's
(assignment bytes, the manifest's ``shards`` block) and loadable by the
reference, and real multi-process runs on the CPU — the fs backend's
spawned ranks, two ranks over a ``torch.distributed`` gloo group on
localhost, and the sharded crash drill — stitching the emulated bytes."""
import contextlib
import hashlib
import io
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest

import repro.core as R
import repro_torch.core as T
from repro.launch.dist_partition import main as ref_main
from repro_torch.launch.dist_partition import main as port_main

ALGOS = sorted(T.SPEC_REGISTRY)
_SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


@pytest.fixture(scope="module")
def graph_bin(tmp_path_factory):
    rng = np.random.default_rng(11)
    e = rng.integers(0, 400, (4000, 2)).astype(np.uint32)
    e = e[e[:, 0] != e[:, 1]]
    path = str(tmp_path_factory.mktemp("dist") / "graph.bin")
    e.tofile(path)
    return path


def _args(graph_bin, artifact_dir, algorithm="2psl", workers=2, *extra):
    return ["--input", graph_bin, "--k", "8", "--algorithm", algorithm,
            "--chunk-size", "512", "--workers", str(workers),
            "--artifact-dir", artifact_dir, "--timeout", "120", "--json",
            *extra]


def _in_process(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return json.loads(buf.getvalue())


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def test_cli_offers_every_reference_flag(capsys):
    """Every option of the reference's CLI, plus ``--device``."""
    usage = {}
    for tag, main in (("ref", ref_main), ("port", port_main)):
        with pytest.raises(SystemExit):
            main(["--help"])
        usage[tag] = set(re.findall(r"^\s+(--[a-z][a-z-]*)",
                                    capsys.readouterr().out, re.M))
    assert {"--backend", "--coordinator", "--round-chunks",
            "--checkpoint-every", "--trace"} <= usage["ref"]
    assert usage["ref"] <= usage["port"]
    assert usage["port"] - usage["ref"] == {"--device"}


@pytest.mark.parametrize("argv,message", [
    (["--backend", "jax"], "invalid choice"),
    (["--backend", "emulated", "--rank", "0"], "--rank is for"),
    (["--backend", "torch"], "needs --exchange-dir"),
    (["--backend", "fs"], "needs --exchange-dir"),
    (["--resume"], "need --checkpoint-dir"),
    (["--algorithm", "hdrf", "--buffer-edges", "1024"], "buffer_edges"),
])
def test_cli_refuses_what_the_reference_refuses(graph_bin, capsys, argv,
                                                message):
    base = ["--input", graph_bin, "--k", "8", "--device", "cpu"]
    with pytest.raises(SystemExit):
        port_main(base + argv)
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("algorithm", ALGOS)
def test_emulated_artifact_equals_the_reference_cli(graph_bin, tmp_path,
                                                    algorithm):
    """The same flags through both CLIs: byte-equal assignment, equal
    report quality and ``shards`` block; the reference loads the port's
    artifact (checksums verified) and the port the reference's."""
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    extra = ["--no-plan"] if algorithm != "2psl" else []
    want = _in_process(ref_main, _args(graph_bin, ref_dir, algorithm, 3,
                                       *extra))
    got = _in_process(port_main, _args(graph_bin, port_dir, algorithm, 3,
                                       *extra, "--device", "cpu"))
    assert _sha(os.path.join(port_dir, "assignment.bin")) \
        == _sha(os.path.join(ref_dir, "assignment.bin"))
    for key in ("algorithm", "workers", "backend", "edges", "vertices",
                "replication_factor", "alpha_measured", "shards",
                "rounds", "round_chunks"):
        assert got[key] == want[key], key
    assert got["device"] == "cpu"
    assert _manifest(port_dir)["shards"] == _manifest(ref_dir)["shards"]
    art = R.PartitionArtifact.load(port_dir)
    assert art.manifest["shards"]["num_shards"] == 3
    assert art.has_halo_plan() == (algorithm == "2psl")
    assert T.PartitionArtifact.load(ref_dir).manifest["shards"] \
        == art.manifest["shards"]


def test_emulated_trace_and_round_chunks(graph_bin, tmp_path):
    trace = str(tmp_path / "t.json")
    d = str(tmp_path / "art")
    rep = _in_process(port_main, _args(
        graph_bin, d, "hdrf", 2, "--no-plan", "--round-chunks", "2",
        "--trace", trace, "--device", "cpu"))
    want = _in_process(ref_main, _args(
        graph_bin, str(tmp_path / "ref"), "hdrf", 2, "--no-plan",
        "--round-chunks", "2"))
    assert rep["round_chunks"] == 2 and rep["rounds"] == want["rounds"]
    assert rep["replication_factor"] == want["replication_factor"]
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"shard:merge", "shard:exchange", "shard:stitch"} <= names


def _env():
    return dict(os.environ, PYTHONPATH=_SRC + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _port_cmd(graph_bin, artifact_dir, backend, *extra):
    return [sys.executable, "-m", "repro_torch.launch.dist_partition",
            *_args(graph_bin, artifact_dir, "2psl", 2, "--no-plan"),
            "--backend", backend, "--device", "cpu", *extra]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def emulated_sha(graph_bin, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("emu") / "art")
    _in_process(port_main, _args(graph_bin, d, "2psl", 2, "--no-plan",
                                 "--device", "cpu"))
    return _sha(os.path.join(d, "assignment.bin"))


def test_torch_backend_two_processes_match_emulated(graph_bin, tmp_path,
                                                    emulated_sha):
    """Two ranks over a gloo process group on localhost (the coordinator
    is its init_method): the stitched bytes are the emulated run's, and the
    two ranks exchanged the same state files an fs run does."""
    d = str(tmp_path / "torch")
    cmd = _port_cmd(graph_bin, d, "torch", "--coordinator",
                    f"tcp://127.0.0.1:{_free_port()}")
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    report = json.loads(outs[0][0])
    assert report["backend"] == "torch" and report["workers"] == 2
    assert outs[1][0] == ""                 # only rank 0 reports
    assert _sha(os.path.join(d, "assignment.bin")) == emulated_sha
    files = sorted(os.listdir(os.path.join(d, "exchange")))
    assert "final_w000.npz" in files and "final_w001.npz" in files
    assert "p00_r00000_w001.npz" in files


@pytest.mark.slow
def test_fs_spawned_ranks_match_emulated(graph_bin, tmp_path, emulated_sha):
    """The fs parent mode spawns one ``python -m
    repro_torch.launch.dist_partition --rank r`` per rank."""
    d = str(tmp_path / "fs")
    p = subprocess.run(_port_cmd(graph_bin, d, "fs"), env=_env(),
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr
    report = json.loads(p.stdout)
    assert report["workers"] == 2 and report["backend"] == "fs"
    assert _sha(os.path.join(d, "assignment.bin")) == emulated_sha
    assert len(_manifest(d)["shards"]["slices"]) == 2


@pytest.mark.slow
def test_dist_kill_one_worker_and_resume(graph_bin, tmp_path, emulated_sha):
    """Rank 1 of a 2-rank fs run dies hard after its first round
    checkpoint while rank 0 waits at the next rendezvous; relaunched with
    --resume it re-joins mid-pass and the stitched bytes are the clean
    run's (the reference's drill, through the port's CLI)."""
    d = str(tmp_path / "crash")
    cmd = _port_cmd(graph_bin, d, "fs", "--checkpoint-every", "1")
    p0 = subprocess.Popen(cmd + ["--rank", "0"], env=_env(),
                          stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
    try:
        p1 = subprocess.Popen(cmd + ["--rank", "1"],
                              env=dict(_env(),
                                       REPRO_CRASH_AFTER_CHECKPOINTS="1"),
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
        assert p1.wait(timeout=240) == 137
        assert p0.poll() is None, "rank 0 must be waiting, not dead"
        p1b = subprocess.Popen(cmd + ["--rank", "1", "--resume"],
                               env=_env(), stdout=subprocess.DEVNULL)
        assert p1b.wait(timeout=240) == 0
        assert p0.wait(timeout=240) == 0
    finally:
        if p0.poll() is None:
            p0.kill()
    assert _sha(os.path.join(d, "assignment.bin")) == emulated_sha
    manifest = _manifest(d)
    assert manifest["shards"]["num_shards"] == 2
    assert manifest["extras"]["resumes"] >= 1
