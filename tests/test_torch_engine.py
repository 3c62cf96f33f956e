"""The port's engine end to end against the reference: byte-equal
assignments and equal quality for 2PS-L at every pipeline depth, for
2PS-HDRF, HDRF, Greedy and the DBH, Grid and Random hashes, for several k,
flat and host-aware; the CLI's ``--out`` file; and the port's independence
from jax and the reference package."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T

ROOT = Path(__file__).resolve().parents[1]
_REF_CACHE: dict = {}


def _reference(graph_name, edges, k, name="2psl", **kw):
    key = (graph_name, name, k, tuple(sorted(kw.items())))
    if key not in _REF_CACHE:
        _REF_CACHE[key] = R.run_spec(R.spec_for(name, chunk_size=512, **kw),
                                     R.InMemoryEdgeStream(edges), k)
    return _REF_CACHE[key]


def _assert_same(res, ref):
    assert res.assignment.dtype == np.int32
    assert res.assignment.tobytes() == np.asarray(ref.assignment).tobytes()
    assert res.quality.replication_factor == ref.quality.replication_factor
    assert res.quality.balance == ref.quality.balance
    np.testing.assert_array_equal(res.quality.part_sizes,
                                  ref.quality.part_sizes)
    if res.spec.algorithm in ("2psl", "2ps-hdrf"):
        for key in ("prepartition_ratio", "num_clusters", "max_vol"):
            assert res.extras[key] == ref.extras[key]
    if "cross_host_rf" in ref.extras:
        assert res.extras["cross_host_rf"] == ref.extras["cross_host_rf"]
        assert res.extras["num_hosts"] == ref.extras["num_hosts"]


#: (registry name, spec overrides) of the ported baselines and variants
_BASELINES = [("2ps-hdrf", {}), ("hdrf", {}), ("hdrf", {"use_cap": True}),
              ("greedy", {}), ("greedy", {"use_cap": True}), ("dbh", {}),
              ("grid", {}), ("random", {})]


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("name,kw", _BASELINES,
                         ids=[n + "-cap" * bool(kw) for n, kw in _BASELINES])
def test_baselines_byte_equal(name, kw, k, small_rmat):
    ref = _reference("small_rmat", small_rmat, k, name, **kw)
    res = T.run_spec(T.spec_for(name, chunk_size=512, **kw),
                     T.InMemoryEdgeStream(small_rmat), k, device="cpu")
    _assert_same(res, ref)
    assert set(res.timings) == set(ref.timings)
    if name in ("2ps-hdrf", "hdrf", "greedy"):
        assert res.extras["kernel_backend"] == "torch-cpu"


@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("name,kw", [
    ("2ps-hdrf", {"dcn_penalty": 1.0}), ("hdrf", {"dcn_penalty": 1.0}),
    ("greedy", {"dcn_penalty": 1.0}), ("dbh", {}), ("random", {})])
def test_baselines_hosted_byte_equal(name, kw, k, small_planted):
    """4 host groups: the stateful scorers with the host penalty; the
    hashes with ``host_groups`` alone (only the cross-host RF changes)."""
    kw = {"host_groups": 4, **kw}
    ref = _reference("small_planted", small_planted, k, name, **kw)
    res = T.run_spec(T.spec_for(name, chunk_size=512, **kw),
                     T.InMemoryEdgeStream(small_planted), k, device="cpu")
    _assert_same(res, ref)
    assert res.extras["num_hosts"] == 4


@pytest.mark.parametrize("graph", ["small_rmat", "small_planted"])
@pytest.mark.parametrize("k", [4, 8, 32])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_run_spec_byte_equal(graph, k, depth, request):
    edges = request.getfixturevalue(graph)
    ref = _reference(graph, edges, k)
    res = T.run_spec(T.spec_for("2psl", chunk_size=512, pipeline_depth=depth),
                     T.InMemoryEdgeStream(edges), k, device="cpu")
    _assert_same(res, ref)
    assert res.extras["kernel_backend"] == "torch-cpu"
    assert set(res.timings) == set(ref.timings)


@pytest.mark.parametrize("graph", ["small_rmat", "small_planted"])
@pytest.mark.parametrize("k", [4, 8, 32])
def test_run_spec_hosted_byte_equal(graph, k, request):
    edges = request.getfixturevalue(graph)
    kw = {"host_groups": 2, "dcn_penalty": 1.0}
    ref = _reference(graph, edges, k, **kw)
    res = T.run_spec(T.spec_for("2psl", chunk_size=512, **kw),
                     T.InMemoryEdgeStream(edges), k, device="cpu")
    _assert_same(res, ref)
    assert res.extras["cross_host_rf"] == ref.extras["cross_host_rf"]
    assert res.extras["num_hosts"] == 2


def test_traced_run_is_identical_and_reports_stalls(small_rmat):
    from repro_torch.obs import MetricsRegistry, Tracer
    tracer, metrics = Tracer(), MetricsRegistry()
    res = T.run_spec(T.spec_for("2psl", chunk_size=512),
                     T.InMemoryEdgeStream(small_rmat), 8, device="cpu",
                     tracer=tracer, metrics=metrics)
    _assert_same(res, _reference("small_rmat", small_rmat, 8))
    names = {e["name"] for e in tracer.events() if e["ph"] == "X"}
    assert {"read", "dispatch", "writeback", "pass:scoring"} <= names
    assert res.extras["stall_report"]["critical_stage"] in (
        "prefetch", "dispatch", "writeback")
    snap = metrics.snapshot()
    assert snap["engine.edges_streamed"]["value"] == 2 * len(small_rmat)


def test_cli_out_byte_equal_to_reference_cli(small_rmat, tmp_path, capsys):
    from repro.launch.partition import main as ref_main
    from repro_torch.launch.partition import main as port_main
    graph = tmp_path / "g.bin"
    np.ascontiguousarray(small_rmat, dtype=np.uint32).tofile(graph)
    common = ["--input", str(graph), "--k", "8", "--chunk-size", "512",
              "--json"]
    ref_main(common + ["--out", str(tmp_path / "ref.bin")])
    ref_report = json.loads(capsys.readouterr().out)
    port_main(common + ["--out", str(tmp_path / "port.bin"),
                        "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "ref.bin").read_bytes())
    for key in ("edges", "vertices", "replication_factor", "alpha_measured",
                "prepartition_ratio"):
        assert report[key] == ref_report[key]
    assert report["kernel_backend"] == "torch-cpu"
    assert report["device"] == "cpu"


def test_cli_hosted_matches_reference_cli(small_planted, tmp_path, capsys):
    from repro.launch.partition import main as ref_main
    from repro_torch.launch.partition import main as port_main
    graph = tmp_path / "g.bin"
    np.ascontiguousarray(small_planted, dtype=np.uint32).tofile(graph)
    common = ["--input", str(graph), "--k", "8", "--chunk-size", "512",
              "--hosts", "2", "--dcn-penalty", "1.0", "--json"]
    ref_main(common + ["--out", str(tmp_path / "ref.bin")])
    ref_report = json.loads(capsys.readouterr().out)
    port_main(common + ["--out", str(tmp_path / "port.bin"),
                        "--device", "cpu", "--pipeline-depth", "1"])
    report = json.loads(capsys.readouterr().out)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "ref.bin").read_bytes())
    assert report["cross_host_rf"] == ref_report["cross_host_rf"]


def test_cli_2ps_hdrf_out_byte_equal_to_reference_cli(small_rmat, tmp_path,
                                                     capsys):
    from repro.launch.partition import main as ref_main
    from repro_torch.launch.partition import main as port_main
    graph = tmp_path / "g.bin"
    np.ascontiguousarray(small_rmat, dtype=np.uint32).tofile(graph)
    common = ["--input", str(graph), "--k", "8", "--chunk-size", "512",
              "--algorithm", "2ps-hdrf", "--cluster-passes", "2", "--json"]
    ref_main(common + ["--out", str(tmp_path / "ref.bin")])
    ref_report = json.loads(capsys.readouterr().out)
    port_main(common + ["--out", str(tmp_path / "port.bin"),
                        "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "ref.bin").read_bytes())
    for key in ("algorithm", "replication_factor", "alpha_measured",
                "prepartition_ratio", "cluster_passes"):
        assert report[key] == ref_report[key]


@pytest.mark.parametrize("algorithm", ["hdrf", "greedy", "dbh", "grid",
                                       "random"])
def test_cli_runs_every_ported_algorithm(algorithm, small_rmat, tmp_path,
                                         capsys):
    """``--cluster-passes`` goes only to the 2PS specs (the others have no
    such field), so e.g. ``--algorithm hdrf --chunk-size 1024`` runs and
    writes what the reference CLI writes."""
    from repro.launch.partition import main as ref_main
    from repro_torch.launch.partition import main as port_main
    graph = tmp_path / "g.bin"
    np.ascontiguousarray(small_rmat, dtype=np.uint32).tofile(graph)
    common = ["--input", str(graph), "--k", "8", "--chunk-size", "1024",
              "--algorithm", algorithm, "--json"]
    ref_main(common + ["--out", str(tmp_path / "ref.bin")])
    ref_report = json.loads(capsys.readouterr().out)
    port_main(common + ["--out", str(tmp_path / "port.bin"),
                        "--device", "cpu"])
    report = json.loads(capsys.readouterr().out)
    assert ((tmp_path / "port.bin").read_bytes()
            == (tmp_path / "ref.bin").read_bytes())
    assert report["replication_factor"] == ref_report["replication_factor"]


def test_cli_offers_exactly_the_ported_specs(small_rmat, tmp_path, capsys):
    """Every registered spec is ported: ``PORTED`` is the registry, each
    builds, and the CLI's ``--algorithm`` offers each."""
    from repro_torch.core import (PORTED, SPEC_REGISTRY, build_partitioner,
                                  spec_for)
    from repro_torch.launch.partition import main as port_main
    assert PORTED == tuple(SPEC_REGISTRY)
    assert set(PORTED) == set(R.SPEC_REGISTRY)
    for name in PORTED:
        build_partitioner(spec_for(name), device="cpu")
    with pytest.raises(SystemExit):
        port_main(["--help"])
    usage = capsys.readouterr().out
    for name in PORTED:
        assert name in usage
    for flag in ("--memory-budget-bytes", "--buffer-edges"):
        assert flag in usage


def test_run_spec_defaults_to_cuda_and_raises_without_it(small_rmat,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.run_spec(T.spec_for("2psl", chunk_size=512),
                   T.InMemoryEdgeStream(small_rmat), 8)
    from repro_torch.launch.partition import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--input", "unused.bin", "--k", "8"])


def test_robustness_arguments_are_refused(small_rmat, tmp_path):
    """The robustness layer is ported: ``run_spec`` refuses what the
    reference refuses (a checkpoint interval without a directory, or below
    1) and runs the rest (``tests/test_torch_robust.py``)."""
    for kw, match in (({"checkpoint_every_chunks": 2}, "checkpoint_dir"),
                      ({"checkpoint_every_chunks": 0,
                        "checkpoint_dir": str(tmp_path)}, ">= 1")):
        with pytest.raises(ValueError, match=match):
            T.run_spec(T.spec_for("2psl", chunk_size=512),
                       T.InMemoryEdgeStream(small_rmat), 8, device="cpu",
                       **kw)
    res = T.run_spec(T.spec_for("2psl", chunk_size=512),
                     T.InMemoryEdgeStream(small_rmat), 8, device="cpu",
                     checkpoint_every_chunks=2, checkpoint_dir=str(tmp_path))
    assert res.extras["checkpoints_written"] > 0


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return (files + sorted((ROOT / "examples_torch").glob("*.py"))
            + [ROOT / "chip_smoke.py"])


def test_port_imports_neither_jax_nor_repro():
    sources = _port_sources()
    for module in ("core/hybrid.py", "core/buffered.py",
                   "core/incremental.py", "sample/local_graph.py"):
        assert ROOT / "src" / "repro_torch" / module in sources, module
    for twin in ("quickstart", "out_of_core_partition",
                 "partition_and_train_gnn", "train_lm_100m"):
        assert ROOT / "examples_torch" / f"{twin}.py" in sources, twin
    for path in sources:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_port_runs_without_jax_or_repro_loaded(tmp_path):
    code = (
        "import sys\n"
        "import repro_torch.kernels.edge_score\n"
        "import repro_torch, repro_torch.core.engine, repro_torch.obs\n"
        "import repro_torch.launch.partition as cli\n"
        "import numpy as np\n"
        "from repro_torch.data import rmat_graph\n"
        "e = rmat_graph(8, edge_factor=4, seed=1)\n"
        f"p = {str(tmp_path / 'g.bin')!r}\n"
        "np.ascontiguousarray(e, dtype=np.uint32).tofile(p)\n"
        "cli.main(['--input', p, '--k', '4', '--chunk-size', '256',\n"
        "          '--device', 'cpu', '--json'])\n"
        "import contextlib, io\n"
        "for algo in ('hep', 'buffered'):\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        cli.main(['--input', p, '--k', '4', '--chunk-size',\n"
        "                  '256', '--algorithm', algo, '--device', 'cpu'])\n"
        "import repro_torch.launch.serve as serve\n"
        "rep = serve.main(['--arch', 'dien', '--requests', '8',\n"
        "                  '--device', 'cpu'])\n"
        "assert rep['requests'] == 8 and 0 < rep['mean_ctr'] < 1, rep\n"
        "rep = serve.main(['--arch', 'starcoder2-3b', '--requests', '2',\n"
        "                  '--max-new', '3', '--device', 'cpu'])\n"
        "assert rep['generated_tokens'] == 6, rep\n"
        "import torch\n"
        "from repro_torch.kernels.spmm import (prepare_tiles,\n"
        "                                      segment_sum_tiles, spmm)\n"
        "from repro_torch.kernels.embedding_bag import embedding_bag\n"
        "src, dst = e[:, 0].astype(np.int64), e[:, 1].astype(np.int64)\n"
        "n = int(e.max()) + 1\n"
        "prep = prepare_tiles(dst, n)\n"
        "x = torch.randn(n, 8)\n"
        "y = spmm(x, torch.from_numpy(src), None, prep)\n"
        "z = segment_sum_tiles(x[torch.from_numpy(src)], prep)\n"
        "assert y.shape == (n, 8) and torch.allclose(y, z), (y - z)\n"
        "pooled = embedding_bag(x, torch.from_numpy(e[:6].reshape(3, 4)),\n"
        "                       mode='mean')\n"
        "assert pooled.shape == (3, 8)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("CLEAN")
    assert json.loads(out.stdout[:out.stdout.rindex("}") + 1])["k"] == 4


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this case checks the behaviour without a card")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (alone, alone / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_card_run_equals_cpu_run(small_rmat):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from repro_torch.kernels.edge_score import launches
    spec = T.spec_for("2psl", chunk_size=512)
    launches.reset()
    card = T.run_spec(spec, T.InMemoryEdgeStream(small_rmat), 8,
                      device="cuda")
    assert launches.count == -(-len(small_rmat) // 512)
    assert card.extras["kernel_backend"] == "cuda"
    cpu = T.run_spec(spec, T.InMemoryEdgeStream(small_rmat), 8,
                     device="cpu")
    assert card.assignment.tobytes() == cpu.assignment.tobytes()
