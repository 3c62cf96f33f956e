"""The example twins (``examples_torch/``) against the reference's examples
(``examples/``) on the same inputs, on the CPU: the partition twins at the
examples' own sizes (assignments byte-equal, rf, alpha, halo capacities,
DCN rows and the artifact's halo plan equal), the GIN's first losses from
the reference's initial state, and the LM trainer's loop at a small
config from carried parameters."""
import dataclasses
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.core.integration import (build_device_shards,
                                    comm_volume_per_layer)
from repro.data.gnn_batches import full_graph_batch
from repro.data.lm_data import TokenStream
from repro.dist.multihost import host_plan_from_halo
from repro.dist.partitioned_gnn import plan_capacities, plan_halo_exchange
from repro.launch import steps as RS
from repro.models.gnn import GINConfig
from repro.models.transformer import init_params as ref_init_params
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime import StepWatchdog as RefWatchdog
from repro.runtime import TrainLoopRunner as RefRunner
from repro_torch.checkpoint import latest_step
from repro_torch.core import InMemoryEdgeStream, run_spec
from repro_torch.launch import steps as S

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engine's small eager operations run no
    faster on more, and several test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(directory: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"{directory}_{name}", ROOT / directory / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ref_spec(spec):
    return R.spec_from_dict(spec.to_dict())


def _assert_same_run(res, ref):
    assert np.asarray(res.assignment, np.int32).tobytes() == \
        np.asarray(ref.assignment, np.int32).tobytes()
    assert res.quality.replication_factor == ref.quality.replication_factor
    assert res.quality.balance == ref.quality.balance


# ---------------------------------------------------------------------------
# quickstart: 2 graphs x 4 partitioners at k = 32
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart_rows():
    """The twin's 8 runs on the CPU, from its graphs and specs, in its
    printed order (``partition_rows`` runs each twice, the first a
    warm-up; its script runs whole in ``test_torch_examples_main.py``)."""
    twin = _load("examples_torch", "quickstart")
    rows = []
    for name, edges in twin.graphs().items():
        stream = InMemoryEdgeStream(edges)
        rows += [{"graph": name, "stream": stream, "k": twin.K,
                  "result": run_spec(spec, stream, twin.K, device=CPU)}
                 for _, spec in twin.specs()]
    return rows


@pytest.mark.parametrize("i", range(8))
def test_quickstart_twin_equals_reference(quickstart_rows, i):
    row = quickstart_rows[i]
    edges = row["stream"].edges
    ref = R.run_spec(_ref_spec(row["result"].spec),
                     R.InMemoryEdgeStream(edges), row["k"])
    _assert_same_run(row["result"], ref)


def test_quickstart_twin_runs_the_reference_graphs_and_specs(
        quickstart_rows):
    twin = _load("examples_torch", "quickstart")
    assert [(r["graph"], r["result"].spec.algorithm) for r in
            quickstart_rows] == [
        (g, a) for g in ("social (R-MAT, power-law)",
                         "web (planted communities)")
        for a in ("2psl", "hdrf", "dbh", "random")]
    assert [s.chunk_size for _, s in twin.specs()[:2]] == [1 << 14, 4096]
    assert [r["stream"].num_edges for r in quickstart_rows[::4]] == \
        [110_716, 257_434]


# ---------------------------------------------------------------------------
# out of core: the k sweep from the memmapped RMAT-14 file, the artifact
# ---------------------------------------------------------------------------

#: the reference's printed rf at k = 4, 32, 128 (its example's table)
OUT_OF_CORE_RF = {"2psl": (1.962, 6.275, 10.364),
                  "hdrf": (1.738, 3.781, 5.806),
                  "dbh": (1.795, 4.726, 8.435)}


@pytest.fixture(scope="module")
def out_of_core(tmp_path_factory):
    twin = _load("examples_torch", "out_of_core_partition")
    d = str(tmp_path_factory.mktemp("out_of_core"))
    stream = twin.write_stream(d)
    sweep = {k: {name: run_spec(spec, stream, k, device=CPU)
                 for name, spec in twin.specs()} for k in twin.KS}
    return twin, d, stream, sweep


@pytest.mark.parametrize("k", (4, 32, 128))
@pytest.mark.parametrize("name", ("2psl", "hdrf", "dbh"))
def test_out_of_core_twin_equals_reference(out_of_core, name, k):
    twin, _, stream, sweep = out_of_core
    res = sweep[k][name]
    ref = R.run_spec(_ref_spec(res.spec), R.MemmapEdgeStream(stream.path),
                     k)
    _assert_same_run(res, ref)
    assert round(res.quality.replication_factor, 3) == \
        OUT_OF_CORE_RF[name][twin.KS.index(k)]


def test_out_of_core_artifact_plan_equals_reference(out_of_core,
                                                    tmp_path):
    twin, d, stream, _ = out_of_core
    art, plan, _ = twin.save_and_reload(stream, d, CPU)
    ref_stream = R.MemmapEdgeStream(stream.path)
    res = R.run_spec(R.spec_for("2psl", chunk_size=1 << 15), ref_stream,
                     twin.ARTIFACT_K)
    R.PartitionArtifact.save(
        str(tmp_path / "ref"), res, num_vertices=ref_stream.num_vertices,
        num_edges=ref_stream.num_edges, stream=ref_stream,
        graph_path=stream.path)
    ref_art = R.PartitionArtifact.load(str(tmp_path / "ref"))
    ref_plan = ref_art.halo_plan()
    assert plan.b_cap == ref_plan.b_cap == 2055
    assert art.manifest["replication_factor"] == \
        ref_art.manifest["replication_factor"]
    for f in dataclasses.fields(ref_plan):
        np.testing.assert_array_equal(np.asarray(getattr(plan, f.name)),
                                      np.asarray(getattr(ref_plan, f.name)),
                                      err_msg=f.name)
    # the twin's artifact also loads in the reference, to the same plan
    cross = R.PartitionArtifact.load(os.path.join(d, "artifact")).halo_plan()
    np.testing.assert_array_equal(cross.send_idx, ref_plan.send_idx)


# ---------------------------------------------------------------------------
# partition and train: every printed partition figure, the GIN's losses
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gnn_twin():
    twin = _load("examples_torch", "partition_and_train_gnn")
    base = twin.make_graph()
    edges = np.asarray(base["edges"])
    stream = InMemoryEdgeStream(edges)
    report = twin.partition_report(edges, stream, CPU)
    return twin, base, edges, stream, report


def _ref_report(edges, k):
    stream = R.InMemoryEdgeStream(edges)
    out = {}
    for spec in (R.spec_for("2psl", chunk_size=1 << 14),
                 R.spec_for("random")):
        res = R.run_spec(spec, stream, k)
        asg = np.asarray(res.assignment)
        sh = build_device_shards(edges, asg, stream.num_vertices, k)
        out[spec.algorithm] = {
            "result": res, "rf": sh.replication_factor,
            "sync_bytes": comm_volume_per_layer(sh, d_hidden=64),
            "caps": plan_capacities(edges, asg, stream.num_vertices, k)}
    return out


def test_partition_and_train_twin_figures_equal_reference(gnn_twin):
    twin, base, edges, stream, report = gnn_twin
    ref_base = full_graph_batch(4096, 40000, 64, n_classes=8, seed=0)
    for key, v in ref_base.items():
        if v is None:
            assert base[key] is None
        else:
            np.testing.assert_array_equal(base[key], v, err_msg=key)
    ref = _ref_report(edges, twin.K)
    for name in ("2psl", "random"):
        _assert_same_run(report[name]["result"], ref[name]["result"])
        assert report[name]["rf"] == ref[name]["rf"]
        assert report[name]["sync_bytes"] == ref[name]["sync_bytes"]
        assert report[name]["caps"] == ref[name]["caps"]
    # the reference example's printed figures
    assert round(report["2psl"]["rf"], 3) == 4.306
    assert (report["2psl"]["caps"]["v_cap"], report["2psl"]["caps"]["e_cap"],
            report["2psl"]["caps"]["b_cap"]) == (2826, 5216, 1687)
    assert round(report["random"]["rf"], 3) == 7.254
    assert report["random"]["caps"]["b_cap"] == 3399


def test_partition_and_train_twin_hosts_equal_reference(gnn_twin):
    twin, _, edges, stream, report = gnn_twin
    V = stream.num_vertices
    dcn = twin.dcn_summary(edges, report["2psl"]["result"].assignment, V)
    ref_asg = np.asarray(R.run_spec(R.spec_for("2psl", chunk_size=1 << 14),
                                    R.InMemoryEdgeStream(edges),
                                    twin.K).assignment)
    ref_dcn = host_plan_from_halo(plan_halo_exchange(edges, ref_asg, V,
                                                     twin.K),
                                  host_groups=2).dcn_summary()
    assert dcn == ref_dcn
    assert (dcn["dcn_rows_aggregated"], dcn["dcn_rows_naive"]) == \
        (6886, 41694)
    spec, hosted, hosted_dcn = twin.host_aware_run(edges, stream, CPU)
    ref_spec = R.spec_for("2psl", chunk_size=1 << 14, host_groups=2,
                          dcn_penalty=1.0)
    ref_hosted = R.run_spec(ref_spec, R.InMemoryEdgeStream(edges), twin.K)
    _assert_same_run(hosted, ref_hosted)
    assert hosted_dcn == host_plan_from_halo(
        plan_halo_exchange(edges, np.asarray(ref_hosted.assignment), V,
                           twin.K), host_groups=2).dcn_summary()
    assert (round(dcn["cross_host_rf"], 4),
            round(hosted_dcn["cross_host_rf"], 4)) == (1.8406, 1.8220)
    assert hosted_dcn["dcn_rows_aggregated"] == 6734
    assert round(hosted.quality.balance, 3) == 1.05


def test_partition_and_train_twin_gin_losses_match_reference(gnn_twin):
    twin, base, *_ = gnn_twin
    cfg = GINConfig(name="gin", d_in=twin.D_FEAT, n_classes=twin.N_CLASSES)
    params = RS.gnn_init(cfg, jax.random.key(0))
    state = {"params": params, "opt": ref_adamw_init(params)}
    carried = S.state_from_reference("gnn", jax.tree.map(np.asarray, state))
    step = jax.jit(RS.make_gnn_train_step(cfg, "full", lr=2e-3))
    batch = {kk: jnp.asarray(v) for kk, v in base.items() if v is not None}
    want = []
    for _ in range(10):
        state, metrics = step(state, batch)
        want.append(float(metrics["loss"]))
    got, *_ = twin.train_gin(base, CPU, state=carried, steps=10)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# the LM trainer: the runner loop at a small config, the full size's count
# ---------------------------------------------------------------------------

def test_lm_twin_parameter_count_equals_reference():
    twin = _load("examples_torch", "train_lm_100m")
    ref = _load("examples", "train_lm_100m")
    assert twin.lm_100m().num_params() == ref.lm_100m().num_params() \
        == 154_140_672


def test_lm_twin_loop_matches_reference(tmp_path):
    twin = _load("examples_torch", "train_lm_100m")
    ref_mod = _load("examples", "train_lm_100m")
    small = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=256,
                 vocab=512)
    cfg = dataclasses.replace(twin.lm_100m(), **small)
    ref_cfg = dataclasses.replace(ref_mod.lm_100m(), **small)
    ref_fields = dataclasses.asdict(ref_cfg)
    assert ref_fields.pop("unroll_layers") is False   # a jit option
    assert dataclasses.asdict(cfg) == ref_fields
    params = ref_init_params(ref_cfg, jax.random.key(0))
    state = {"params": params, "opt": ref_adamw_init(params)}
    carried = S.state_from_reference("lm", jax.tree.map(np.asarray, state))
    batch, seq, steps = 2, 16, 6

    def ref_batch(i):
        s = TokenStream(ref_cfg.vocab, batch, seq, seed=1000 + i)
        return {k: jnp.asarray(v) for k, v in s.next_batch().items()}

    ref_dir, dir_ = str(tmp_path / "ref"), str(tmp_path / "twin")
    runner = RefRunner(jax.jit(RS.make_lm_train_step(ref_cfg, lr=6e-4)),
                       ref_batch, RefCheckpointManager(ref_dir, interval=2),
                       watchdog=RefWatchdog())
    _, ref_metrics = runner.run(state, steps)
    _, metrics, _, twin_runner = twin.train(
        cfg, carried, steps, twin.batch_fn(cfg, batch, seq, CPU), CPU, dir_,
        interval=2)
    want = [float(m["loss"]) for m in ref_metrics]
    got = [float(m["loss"]) for m in metrics]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert latest_step(dir_) == steps
    assert sorted(os.listdir(dir_)) == sorted(os.listdir(ref_dir))
    assert twin_runner.restarts == 0


@pytest.mark.parametrize("name", ("quickstart", "out_of_core_partition",
                                  "partition_and_train_gnn",
                                  "train_lm_100m"))
def test_twin_raises_without_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("this case checks the behaviour without a card")
    twin = _load("examples_torch", name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twin.main([])
