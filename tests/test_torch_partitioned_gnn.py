"""The port's partitioned GNN execution (``repro_torch.dist.partitioned_gnn``:
the halo combine, the partitioned GIN, GatedGCN and EGNN losses and
``make_partitioned_*_step``) against the reference.

Plans come from the reference's and the port's planners, equal array for
array first; weights are the reference's ``gnn_init``, carried over with
``params_from_reference``.  The losses and gradients are held in process
to ``jax.value_and_grad`` of the dense masked losses that
``tests/test_partitioned_gnn.py`` defines (the reference's own
``shard_map`` gradients equal these), one case to the reference's step on
8 emulated devices in a subprocess, and the ``torch.distributed`` ranks
route (4 gloo ranks) to the one-process route.  Tolerances: a combine's
every element within 1e-6 of the largest sum; a loss within 1e-5
relative; every gradient leaf within 1e-4 of the leaf's largest
reference magnitude; a step's loss and parameters within 1e-5."""
import functools
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import InMemoryEdgeStream as RStream
from repro.core import run_2psl
from repro.dist import partitioned_gnn as rpg
from repro.launch import steps as RS
from repro.models import gnn as RG
from repro.models import layers as RL
from repro.models.gnn import EGNNConfig, GatedGCNConfig, GINConfig
from repro_torch.dist import partitioned_gnn as PG
from repro_torch.dist import plan_halo_exchange
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.gnn import params_from_reference
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.training import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
V, E, K, D_FEAT, N_CLS = 100, 600, 8, 12, 4
LOSS_RTOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-5


def _problem(seed=0, k=K, quantile=1.0, hosts=None, V=V, E=E):
    """Graph, features, 2PS-L assignment, the plan (port == reference) and
    the (k, v_cap, ...) batch arrays with a last-writer-wins master mask."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, V, (E, 2)).astype(np.int32)
    edges = edges[edges[:, 0] != edges[:, 1]]
    feats = rng.standard_normal((V, D_FEAT)).astype(np.float32)
    coords = rng.standard_normal((V, 3)).astype(np.float32)
    labels = rng.integers(0, N_CLS, V).astype(np.int32)
    res = run_2psl(RStream(edges, num_vertices=V), k, chunk_size=128)
    asg = np.asarray(res.assignment)
    kw = dict(pair_cap_quantile=quantile, host_groups=hosts)
    plan = plan_halo_exchange(edges, asg, V, k, **kw)
    ref = rpg.plan_halo_exchange(edges.copy(), asg.copy(), V, k, **kw)
    ours, theirs = plan.device_arrays(), ref.device_arrays()
    assert set(ours) == set(theirs)
    for name in ours:
        assert ours[name].dtype == np.asarray(theirs[name]).dtype, name
        np.testing.assert_array_equal(ours[name], theirs[name], name)
    vm = plan.vmap_global
    master = np.full(V, -1, np.int64)
    for p in range(k - 1, -1, -1):
        master[vm[p][vm[p] >= 0]] = p
    v_cap = plan.v_cap
    nodes = np.zeros((k, v_cap, D_FEAT), np.float32)
    crds = np.zeros((k, v_cap, 3), np.float32)
    labs = np.zeros((k, v_cap), np.int32)
    lmask = np.zeros((k, v_cap), np.float32)
    for p in range(k):
        ok = vm[p] >= 0
        nodes[p, ok] = feats[vm[p][ok]]
        crds[p, ok] = coords[vm[p][ok]]
        labs[p, ok] = labels[vm[p][ok]]
        lmask[p, ok] = (master[vm[p][ok]] == p).astype(np.float32)
    return {"edges": edges, "feats": feats, "coords": coords,
            "labels": labels, "covered": master >= 0, "plan": plan,
            "ref_plan": ref,
            "batch": {"nodes": nodes, "labels": labs, "loss_mask": lmask,
                      "coords": crds, "plan": ours}}


def _layout(hosts):
    if hosts is None:
        return PG._AxisLayout(pair=("data", "model"), host=(),
                              all=("data", "model"))
    return PG._AxisLayout(pair=("device",), host=("host",),
                          all=("host", "device"))


def _torch_batch(batch):
    return {k: v if k == "plan" else torch.from_numpy(v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the halo combine, one-process route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantile,hosts", [
    (1.0, None), (0.5, None), (1.0, 2), (0.5, 2)])
def test_halo_combine_sums_every_replica(quantile, hosts):
    """After the combine every replica holds the global sum of its
    vertex's partials (padding rows keep theirs), on the flat plan with
    and without the overflow lane and on a (2, 4) host-grouped plan."""
    pr = _problem(seed=1, quantile=quantile, hosts=hosts)
    plan, arrays = pr["plan"], pr["batch"]["plan"]
    base = plan if hosts is None else plan.base
    if quantile < 1.0:
        assert (base.ov_idx >= 0).any(), "no overflow lane exercised"
    if hosts:
        assert (plan.hsend_idx >= 0).any(), "no host lane exercised"
    rng = np.random.default_rng(2)
    x = rng.standard_normal((K, plan.v_cap, 7)).astype(np.float32)
    combine = PG._combiner(arrays, _layout(hosts), plan.v_cap)
    assert combine.keywords["lanes"].launches == 2
    y = combine(torch.from_numpy(x.reshape(-1, 7))).numpy().reshape(x.shape)
    vm = base.vmap_global
    total = np.zeros((V, 7), np.float64)
    for p in range(K):
        ok = vm[p] >= 0
        np.add.at(total, vm[p][ok], x[p][ok])
    want = x.copy()
    for p in range(K):
        ok = vm[p] >= 0
        want[p][ok] = total[vm[p][ok]]
    np.testing.assert_allclose(y, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------------------------
# losses and gradients against the dense JAX reference, in process
# ---------------------------------------------------------------------------

def _dense_gin(pr):
    edges, covered = pr["edges"], pr["covered"]

    def loss(params):
        src, dst = edges[:, 0], edges[:, 1]
        h = RL.dense(params["encoder"], jnp.asarray(pr["feats"]))
        for lp in params["layers"]:
            agg = jax.ops.segment_sum(h[src], jnp.asarray(dst),
                                      num_segments=len(covered))
            pre = (1.0 + lp["eps"]) * h + agg
            h = RL.dense(lp["mlp"]["l2"],
                         jax.nn.relu(RL.dense(lp["mlp"]["l1"], pre)))
            h = jax.nn.relu(h)
        return _dense_xent(RL.dense(params["head"], h), pr["labels"],
                           covered)
    return loss


def _dense_gatedgcn(pr):
    edges, covered = pr["edges"], pr["covered"]

    def loss(params):
        src, dst = edges[:, 0], edges[:, 1]
        h = RL.dense(params["encoder"], jnp.asarray(pr["feats"]))
        ef = RL.dense(params["edge_encoder"],
                      jnp.ones((len(edges), 1), h.dtype))
        for lp in params["layers"]:
            e_new = (RL.dense(lp["A"], h)[src] + RL.dense(lp["B"], h)[dst]
                     + RL.dense(lp["C"], ef))
            eta = jax.nn.sigmoid(e_new)
            num = jax.ops.segment_sum(eta * RL.dense(lp["V"], h)[src],
                                      jnp.asarray(dst),
                                      num_segments=len(covered))
            den = jax.ops.segment_sum(eta, jnp.asarray(dst),
                                      num_segments=len(covered))
            h = h + jax.nn.relu(RL.dense(lp["U"], h) + num / (den + 1e-6))
            ef = ef + jax.nn.relu(e_new)
        return _dense_xent(RL.dense(params["head"], h), pr["labels"],
                           covered)
    return loss


def _dense_egnn(cfg, pr):
    covered = pr["covered"]
    batch = {"nodes": jnp.asarray(pr["feats"]),
             "edges": jnp.asarray(pr["edges"]),
             "edge_mask": jnp.ones(len(pr["edges"]), jnp.float32),
             "coords": jnp.asarray(pr["coords"]),
             "node_mask": jnp.asarray(covered, jnp.float32),
             "graph_ids": jnp.zeros(len(covered), jnp.int32)}

    def loss(params):
        out = RG.egnn_apply(cfg, params, batch)
        return _dense_xent(out["node_logits"], pr["labels"], covered)
    return loss


def _dense_xent(logits, labels, covered):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    ll = jnp.take_along_axis(logp, jnp.asarray(labels)[:, None],
                             axis=-1)[:, 0]
    m = jnp.asarray(covered, jnp.float32)
    return -(ll * m).sum() / m.sum()


_MODELS = {
    "gin": (GINConfig(name="gin", n_layers=3, d_hidden=16, d_in=D_FEAT,
                      n_classes=N_CLS), lambda cfg, pr: _dense_gin(pr)),
    "gatedgcn": (GatedGCNConfig(name="ggcn", n_layers=2, d_hidden=8,
                                d_in=D_FEAT, n_classes=N_CLS),
                 lambda cfg, pr: _dense_gatedgcn(pr)),
    "egnn": (EGNNConfig(name="egnn", n_layers=3, d_hidden=16, d_in=D_FEAT,
                        n_classes=N_CLS), _dense_egnn),
}


def _assert_grads(got, want):
    want = jax.tree.leaves(want)
    got = tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * scale)


@pytest.mark.parametrize("model,quantile,hosts", [
    ("gin", 1.0, None), ("gin", 0.5, None), ("gin", 0.5, 2),
    ("gatedgcn", 1.0, None), ("gatedgcn", 0.5, 2), ("egnn", 1.0, 2)])
def test_loss_and_grads_match_dense_reference(model, quantile, hosts):
    """The partitioned loss and every gradient leaf against
    ``jax.value_and_grad`` of the dense masked loss (no batch norm), on
    the one-process route over all k partitions."""
    cfg, dense = _MODELS[model]
    pr = _problem(seed=3, quantile=quantile, hosts=hosts)
    params = RS.gnn_init(cfg, jax.random.key(0))
    ref_loss, ref_grads = jax.value_and_grad(dense(cfg, pr))(params)
    body = functools.partial(PG.PARTITIONED_LOSSES[model], cfg,
                             axes=_layout(hosts), v_cap=pr["plan"].v_cap)
    loss, grads = value_and_grad(
        body, params_from_reference(jax.tree.map(np.asarray, params)),
        _torch_batch(pr["batch"]))
    assert abs(float(loss) - float(ref_loss)) <= LOSS_RTOL * abs(
        float(ref_loss))
    _assert_grads(grads, ref_grads)


def test_egnn_forward_matches_dense_per_replica():
    """``partitioned_egnn_forward``'s features and coordinates on every
    replica equal the dense EGNN's at the replica's vertex."""
    cfg, _ = _MODELS["egnn"]
    pr = _problem(seed=4, hosts=2)
    params = RS.gnn_init(cfg, jax.random.key(1))
    covered = pr["covered"]
    out = RG.egnn_apply(cfg, params, {
        "nodes": jnp.asarray(pr["feats"]), "edges": jnp.asarray(pr["edges"]),
        "edge_mask": jnp.ones(len(pr["edges"]), jnp.float32),
        "coords": jnp.asarray(pr["coords"]),
        "node_mask": jnp.asarray(covered, jnp.float32),
        "graph_ids": jnp.zeros(V, jnp.int32)})
    h, x = PG.partitioned_egnn_forward(
        cfg, params_from_reference(jax.tree.map(np.asarray, params)),
        _torch_batch(pr["batch"]), axes=_layout(2), v_cap=pr["plan"].v_cap)
    assert h.shape == (K, pr["plan"].v_cap, cfg.d_hidden)
    vm = pr["plan"].vmap_global
    ref_h, ref_x = np.asarray(out["node_repr"]), np.asarray(out["coords"])
    for p in range(K):
        ok = vm[p] >= 0
        np.testing.assert_allclose(x[p].numpy()[ok], ref_x[vm[p][ok]],
                                   rtol=0, atol=5e-5)
        np.testing.assert_allclose(h[p].numpy()[ok], ref_h[vm[p][ok]],
                                   rtol=0, atol=5e-4)


# ---------------------------------------------------------------------------
# the reference's shard_map step on 8 emulated devices, in a subprocess
# ---------------------------------------------------------------------------

_REFERENCE_STEP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.dist.partitioned_gnn import make_partitioned_gin_step
    from repro.dist import plan_halo_exchange
    from repro.launch import steps as S
    from repro.models.gnn import GINConfig
    from repro.optim import adamw_init

    z = np.load(sys.argv[1])
    plan = plan_halo_exchange(z["edges"], z["assignment"], int(z["V"]), 8,
                              pair_cap_quantile=float(z["quantile"]),
                              host_groups=2)
    cfg = GINConfig(name="gin", n_layers=3, d_hidden=16,
                    d_in=z["nodes"].shape[-1], n_classes=int(z["n_cls"]))
    params = S.gnn_init(cfg, jax.random.key(0))
    mesh = jax.make_mesh((2, 4), ("host", "device"), devices=jax.devices(),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    step = make_partitioned_gin_step(cfg, mesh, plan)
    batch = {"nodes": jnp.asarray(z["nodes"]),
             "labels": jnp.asarray(z["labels"]),
             "loss_mask": jnp.asarray(z["loss_mask"]),
             "plan": {k: jnp.asarray(v)
                      for k, v in plan.device_arrays().items()}}
    with mesh:
        state, metrics = jax.jit(step)(
            {"params": params, "opt": adamw_init(params)}, batch)
    leaves = jax.tree.leaves(state["params"])
    np.savez(sys.argv[2], loss=np.asarray(metrics["loss"]),
             **{f"p{i}": np.asarray(a) for i, a in enumerate(leaves)})
    print("REFERENCE_STEP_OK")
""")


def test_gin_step_matches_reference_shard_map_step(tmp_path):
    """One ``make_partitioned_gin_step`` step on a (2, 4) ``("host",
    "device")`` mesh with the overflow and host lanes active: the port's
    one-process step against the reference's ``shard_map`` step on 8
    emulated devices, loss and updated parameters within 1e-5."""
    pr = _problem(seed=5, quantile=0.5, hosts=2)
    plan = pr["plan"]
    assert (plan.base.ov_idx >= 0).any() and (plan.hsend_idx >= 0).any()
    res = run_2psl(RStream(pr["edges"], num_vertices=V), K, chunk_size=128)
    b = pr["batch"]
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, edges=pr["edges"], assignment=np.asarray(res.assignment),
             V=V, quantile=0.5, n_cls=N_CLS, nodes=b["nodes"],
             labels=b["labels"], loss_mask=b["loss_mask"])
    out = tmp_path / "out.npz"
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _REFERENCE_STEP, str(inputs),
                        str(out)], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert "REFERENCE_STEP_OK" in r.stdout, (r.stdout[-800:],
                                             r.stderr[-3000:])
    want = np.load(out)

    cfg, _ = _MODELS["gin"]
    params = params_from_reference(jax.tree.map(
        np.asarray, RS.gnn_init(cfg, jax.random.key(0))))
    mesh = make_host_mesh((2, 4), ("host", "device"), device="cpu")
    step = PG.make_partitioned_gin_step(cfg, mesh, plan)
    state, metrics = step({"params": params, "opt": adamw_init(params)},
                          _torch_batch(b))
    assert abs(float(metrics["loss"]) - float(want["loss"])) <= STEP_TOL
    leaves = tree_leaves(state["params"])
    assert len(leaves) == len([f for f in want.files if f != "loss"])
    for i, leaf in enumerate(leaves):
        np.testing.assert_allclose(leaf.numpy(), want[f"p{i}"], rtol=0,
                                   atol=STEP_TOL)


# ---------------------------------------------------------------------------
# the torch.distributed ranks route: 4 gloo ranks against one process
# ---------------------------------------------------------------------------

RANKS = 4
RANK_CASES = {"flat": None, "two_hosts": 2}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_problem(hosts):
    pr = _problem(seed=6, k=RANKS, quantile=0.5, hosts=hosts, V=60, E=300)
    assert (pr["batch"]["plan"]["ov_idx"] >= 0).any()
    cfg, _ = _MODELS["gin"]
    params = jax.tree.map(np.asarray, RS.gnn_init(cfg, jax.random.key(2)))
    return cfg, pr, params


def _one_step(step, params, batch):
    state = {"params": params, "opt": adamw_init(params)}
    state, metrics = step(state, batch)
    return float(metrics["loss"]), [t.clone() for t in
                                    tree_leaves(state["params"])]


def _rank_worker(rank, port, out_dir):
    """One gloo rank, each case of the parent's problems in turn: this
    rank's loss and summed gradients (the ranks route's loss body, then
    ``_sum_over_ranks``) and one step's loss and parameters, saved for
    the parent."""
    import pickle
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    torch.set_num_threads(1)          # 4 ranks share the host's cores
    with open(os.path.join(out_dir, "problems.pkl"), "rb") as f:
        problems = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=RANKS)
    try:
        for case, (cfg, pr, ref_params) in problems.items():
            hosts = RANK_CASES[case]
            names = ("host", "device") if hosts else ("data", "model")
            mesh = DeviceMesh("cpu", torch.arange(RANKS).reshape(2, 2),
                              mesh_dim_names=names)
            plan = pr["plan"]
            step = PG.make_partitioned_gin_step(cfg, mesh, plan)
            batch = _torch_batch(pr["batch"])
            if rank % 2:              # a rank may pass its own rows alone
                batch = {k: v if k == "plan" else v[rank:rank + 1]
                         for k, v in batch.items()}
            part = step.prepare(batch["plan"])
            groups = part.lanes.groups
            body = functools.partial(
                PG.partitioned_gin_loss, cfg,
                axes=_layout(hosts)._replace(groups=groups),
                v_cap=plan.v_cap)
            loss, grads = value_and_grad(
                body, params_from_reference(ref_params),
                {**batch, "plan": part})
            grads = PG._sum_over_ranks(grads, group=groups.all)
            step_loss, leaves = _one_step(
                step, params_from_reference(ref_params), batch)
            np.savez(os.path.join(out_dir, f"{case}{rank}.npz"),
                     loss=float(loss), step_loss=step_loss,
                     **{f"g{i}": g.numpy() for i, g in
                        enumerate(tree_leaves(grads))},
                     **{f"p{i}": p.numpy() for i, p in enumerate(leaves)})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """Both cases on 4 gloo ranks (``torch.multiprocessing.spawn``, one
    spawn): the problems made here and handed over in a file (spawn
    arguments larger than a pipe's buffer would start the ranks one at a
    time), each rank's results on disk."""
    import pickle
    import torch.multiprocessing as mp
    out = tmp_path_factory.mktemp("ranks")
    problems = {case: _rank_problem(h) for case, h in RANK_CASES.items()}
    with open(out / "problems.pkl", "wb") as f:
        pickle.dump(problems, f)
    mp.spawn(_rank_worker, args=(_free_port(), str(out)), nprocs=RANKS,
             join=True)
    return problems, out


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_ranks_route_matches_one_process(rank_runs, case):
    """4 gloo ranks on a (2, 2) mesh, the overflow lane active (and the
    host lanes on the 2-host plan): every rank's loss and its gradients
    (not scaled by the world size) equal ``jax.value_and_grad`` of the
    dense masked GIN loss and the one-process route's, its updated
    parameters the one-process route's, and every rank's parameters are
    identical."""
    problems, out = rank_runs
    cfg, pr, ref_params = problems[case]
    dense_loss, dense_grads = jax.value_and_grad(_dense_gin(pr))(ref_params)
    dense_grads = [np.asarray(g) for g in jax.tree.leaves(dense_grads)]
    hosts = RANK_CASES[case]
    plan = pr["plan"]
    body = functools.partial(PG.partitioned_gin_loss, cfg,
                             axes=_layout(hosts), v_cap=plan.v_cap)
    batch = _torch_batch(pr["batch"])
    loss, grads = value_and_grad(body, params_from_reference(ref_params),
                                 batch)
    mesh = make_host_mesh((2, 2), ("host", "device") if hosts
                          else ("data", "model"), device="cpu")
    step_loss, leaves = _one_step(
        PG.make_partitioned_gin_step(cfg, mesh, plan),
        params_from_reference(ref_params), batch)
    grads = tree_leaves(grads)
    ranks = [np.load(out / f"{case}{r}.npz") for r in range(RANKS)]
    assert len(dense_grads) == len(grads)
    for got in ranks:
        assert abs(float(got["loss"]) - float(dense_loss)) <= LOSS_RTOL * abs(
            float(dense_loss))
        for i, w in enumerate(dense_grads):
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(got[f"g{i}"], w, rtol=0,
                                       atol=GRAD_TOL * scale)
        assert abs(float(got["loss"]) - float(loss)) <= STEP_TOL
        assert abs(float(got["step_loss"]) - step_loss) <= STEP_TOL
        for i, g in enumerate(grads):
            scale = max(float(g.abs().max()), 1e-30)
            np.testing.assert_allclose(got[f"g{i}"], g.numpy(), rtol=0,
                                       atol=GRAD_TOL * scale)
        for i, p in enumerate(leaves):
            np.testing.assert_allclose(got[f"p{i}"], p.numpy(), rtol=0,
                                       atol=STEP_TOL)
            np.testing.assert_array_equal(got[f"p{i}"], ranks[0][f"p{i}"])


# ---------------------------------------------------------------------------
# errors, the step factory's inputs, and the port's imports
# ---------------------------------------------------------------------------

def test_errors_kept():
    """k != the mesh's device count, and plan arrays from another plan
    than the step's layout, raise as the reference does."""
    pr = _problem(seed=7, hosts=2)
    plan = pr["plan"]
    cfg, _ = _MODELS["gin"]
    with pytest.raises(ValueError, match="k=8 partitions but mesh has 4"):
        PG.make_partitioned_gin_step(
            cfg, make_host_mesh((2, 2), device="cpu"), plan)
    flat, grouped = _layout(None), _layout(2)
    host_arrays, flat_arrays = plan.device_arrays(), plan.base.device_arrays()
    PG._combiner(host_arrays, grouped, plan.v_cap)
    PG._combiner(flat_arrays, flat, plan.v_cap)
    with pytest.raises(ValueError, match="mismatch"):
        PG._combiner(host_arrays, flat, plan.v_cap)
    with pytest.raises(ValueError, match="mismatch"):
        PG._combiner(flat_arrays, grouped, plan.v_cap)
    step = PG.make_partitioned_gin_step(
        cfg, make_host_mesh((2, 4), ("host", "device"), device="cpu"), plan)
    params = params_from_reference(jax.tree.map(
        np.asarray, RS.gnn_init(cfg, jax.random.key(0))))
    batch = {**_torch_batch(pr["batch"]), "plan": flat_arrays}
    with pytest.raises(ValueError, match="has no host lanes"):
        step({"params": params, "opt": adamw_init(params)}, batch)


def test_plan_dims_of_every_source(tmp_path):
    """``_plan_dims`` of a plan, a host plan, a capacities dict and a
    saved artifact (host-grouped when it persisted the host plan) equals
    the reference's."""
    from repro.core import PartitionArtifact as RArtifact
    from repro_torch.core import PartitionArtifact
    pr = _problem(seed=8, hosts=2)
    plan, ref = pr["plan"], pr["ref_plan"]
    res = run_2psl(RStream(pr["edges"], num_vertices=V), K, chunk_size=128)
    RArtifact.save(str(tmp_path / "a"), res, num_vertices=V,
                   num_edges=len(pr["edges"]), edges=pr["edges"],
                   host_groups=2)
    art = PartitionArtifact.load(str(tmp_path / "a"))
    for ours, theirs in ((plan, ref), (plan.base, ref.base),
                         ({"k": 8, "v_cap": 5}, {"k": 8, "v_cap": 5}),
                         ({"k": 8, "v_cap": 5, "num_hosts": 2},) * 2,
                         (art, RArtifact.load(str(tmp_path / "a")))):
        assert PG._plan_dims(ours) == rpg._plan_dims(theirs)
    assert PG._plan_dims(art) == (K, plan.v_cap, 2)


def test_host_mesh_and_exports():
    """``make_host_mesh`` carries the mesh's shape for
    ``split_mesh_axes`` and one explicit device (the card unless asked);
    ``repro_torch.dist`` exports what the reference's does from
    ``partitioned_gnn``."""
    import repro.dist as rdist
    import repro_torch.dist as tdist
    from repro_torch.dist import split_mesh_axes
    mesh = make_host_mesh((4, 8), ("host", "device"), device="cpu")
    assert mesh.devices.shape == (4, 8) and mesh.device.type == "cpu"
    assert split_mesh_axes(mesh, 4) == (("host",), ("device",))
    assert make_host_mesh().device.type == "cuda"
    with pytest.raises(ValueError):
        make_host_mesh((2, 2), ("data",))
    ref = {n for n in rdist.__all__
           if getattr(rdist, n).__module__ == rpg.__name__}
    assert ref <= set(tdist.__all__)
    for n in ref:
        assert getattr(tdist, n) is getattr(PG, n)


def test_partitioned_step_runs_without_jax_or_repro(tmp_path):
    """The new modules import neither jax nor the reference: a port-only
    process plans a small graph and takes two one-process GIN steps on
    the CPU, the loss finite and the parameters moved."""
    code = textwrap.dedent("""
        import sys
        import numpy as np, torch
        from repro_torch.dist import (make_partitioned_gin_step,
                                      plan_halo_exchange)
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.gnn import GINConfig, gin_init
        from repro_torch.optim import adamw_init
        rng = np.random.default_rng(0)
        e = rng.integers(0, 50, (300, 2)).astype(np.int32)
        e = e[e[:, 0] != e[:, 1]]
        plan = plan_halo_exchange(e, rng.integers(0, 4, len(e)), 50, 4,
                                  pair_cap_quantile=0.5, host_groups=2)
        cfg = GINConfig(name="gin", n_layers=2, d_hidden=8, d_in=5,
                        n_classes=3)
        params = gin_init(cfg, torch.Generator().manual_seed(0))
        before = params["head"]["w"].clone()
        step = make_partitioned_gin_step(
            cfg, make_host_mesh((2, 2), ("host", "device"), device="cpu"),
            plan)
        nm = plan.base.node_mask
        batch = {"nodes": torch.randn(4, plan.v_cap, 5),
                 "labels": torch.zeros(4, plan.v_cap, dtype=torch.int32),
                 "loss_mask": torch.from_numpy(nm), "plan":
                 plan.device_arrays()}
        state = {"params": params, "opt": adamw_init(params)}
        for _ in range(2):
            state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
        assert not torch.equal(before, state["params"]["head"]["w"])
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print("CLEAN")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("CLEAN")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("model,quantile,hosts", [
    ("gin", 0.5, 2), ("gin", 1.0, None), ("gatedgcn", 0.5, None),
    ("egnn", 1.0, 2)])
def test_card_step_equals_cpu_step(model, quantile, hosts):
    """The one-process route on the card against the CPU: the loss and
    gradients within 1e-4 of each leaf's scale, exactly the stated
    ``spmm`` launches (every one on the bound route but the segment
    sums'), and, for GIN, two steps from the same state bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the spmm kernel has no CPU mode)")
    from repro_torch.kernels import spmm as spmm_ops
    cfg, _ = _MODELS[model]
    pr = _problem(seed=9, quantile=quantile, hosts=hosts)
    plan = pr["plan"]
    params = jax.tree.map(np.asarray, RS.gnn_init(cfg, jax.random.key(0)))
    body = functools.partial(PG.PARTITIONED_LOSSES[model], cfg,
                             axes=_layout(hosts), v_cap=plan.v_cap)
    cpu = value_and_grad(body, params_from_reference(params),
                         _torch_batch(pr["batch"]))
    card_batch = {k: v if k == "plan" else v.cuda()
                  for k, v in _torch_batch(pr["batch"]).items()}
    part = PG._prepare(pr["batch"]["plan"], _layout(hosts), plan.v_cap,
                       "cuda")
    spmm_ops.launches.reset()
    spmm_ops.backward_launches.reset()
    card = value_and_grad(body, params_from_reference(params, "cuda"),
                          {**card_batch, "plan": part})
    total, backward, _ = PG.step_spmm_launches(model, cfg.n_layers)
    assert spmm_ops.launches.count == total
    assert spmm_ops.backward_launches.count == backward
    assert abs(float(card[0]) - float(cpu[0])) <= 1e-4 * abs(float(cpu[0]))
    for g, w in zip(tree_leaves(card[1]), tree_leaves(cpu[1])):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale
    if model == "gin":
        mesh = make_host_mesh((2, 4), ("host", "device") if hosts
                              else ("data", "model"))
        step = PG.make_partitioned_gin_step(cfg, mesh, plan)
        runs = [_one_step(step, params_from_reference(params, "cuda"),
                          card_batch) for _ in range(2)]
        assert runs[0][0] == runs[1][0]
        assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
