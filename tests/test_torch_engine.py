"""The port's 2PS-L engine end to end against the reference: byte-equal
assignments and equal quality at every pipeline depth, for several k, flat
and host-aware; the CLI's ``--out`` file; and the port's independence from
jax and the reference package."""
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


def _reference(graph_name, edges, k, **kw):
    key = (graph_name, k, tuple(sorted(kw.items())))
    if key not in _REF_CACHE:
        _REF_CACHE[key] = R.run_spec(R.spec_for("2psl", chunk_size=512, **kw),
                                     R.InMemoryEdgeStream(edges), k)
    return _REF_CACHE[key]


def _assert_same(res, ref):
    assert res.assignment.dtype == np.int32
    assert res.assignment.tobytes() == np.asarray(ref.assignment).tobytes()
    assert res.quality.replication_factor == ref.quality.replication_factor
    assert res.quality.balance == ref.quality.balance
    np.testing.assert_array_equal(res.quality.part_sizes,
                                  ref.quality.part_sizes)
    for key in ("prepartition_ratio", "num_clusters", "max_vol"):
        assert res.extras[key] == ref.extras[key]


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


def test_run_spec_defaults_to_cuda_and_raises_without_it(small_rmat,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.run_spec(T.spec_for("2psl", chunk_size=512),
                   T.InMemoryEdgeStream(small_rmat), 8)
    from repro_torch.launch.partition import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--input", "unused.bin", "--k", "8"])


@pytest.mark.parametrize("name", sorted(set(R.SPEC_REGISTRY) - {"2psl"}))
def test_unported_specs_name_their_roadmap_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.build_partitioner(T.spec_for(name), "cpu")


def test_robustness_arguments_are_refused(small_rmat, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.run_spec(T.spec_for("2psl", chunk_size=512),
                   T.InMemoryEdgeStream(small_rmat), 8, device="cpu",
                   checkpoint_every_chunks=2, checkpoint_dir=str(tmp_path))


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    for path in _port_sources():
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
