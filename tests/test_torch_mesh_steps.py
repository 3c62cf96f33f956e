"""The port's remaining steps on a ``DeviceMesh`` on 8 gloo ranks: LM decode
on a DTensor cache (dense and MoE), the four GNN train steps under
``gnn_batch_specs`` and DIEN's train, serve and retrieval steps under the
recsys rules, against the port's one-process steps and the reference's
jitted single-device steps.

One module-scoped world of 8 ranks (``torch.multiprocessing.spawn``) runs
every case on three meshes: (2, 4) and (8, 1) ``("data", "model")`` and
(2, 2, 2) ``("pod", "data", "model")``, where the data-axis group spans
two axes.  The problems go to the ranks in a file (the reference's weights
carried over, numpy batches made from seeds), the results come back in a
file; the reference's side and the one-process port runs are computed
here meanwhile.  Every batch is laid out by ``ArchSpec.input_specs`` at a
smoke-sized shape of the cell's kind (the leaves the dry run feeds, their
dtypes and trailing dims) and filled with seeded random values.  The
cases hit both branches of each rule:

- decode: a batch of 8 (split over the data axes) and of 3 (whole), kv
  heads that divide ``"model"`` (4 over 4 and 2, 2 over 2) and that do not
  (2 over 4), and an MoE layer; two steps at positions 9 and 10 of a
  random 16-position cache;
- GNN: node and edge counts that divide every data-axis group (64 nodes,
  256 edges; molecules of 40 and 32) and that divide none (63, 255), and
  a sampled subgraph's caps (63 nodes, 60 edges: whole on (8, 1)), every
  mix of the two among the four models;
- DIEN: tables of 1,000 rows (over ``"model"``) and 999 (whole), embed
  dims 8 (over the data axes) and 6 (over 2 only), batches of 8 and 5,
  1-user retrievals over 96 and 50 candidates with repeats (equal scores).

Tolerances: against one process, the loss within 1e-5 (relative) and each
gradient, parameter, logit and cache leaf within 1e-5 of its leaf's largest
magnitude, with two exceptions for the GNNs' batch norms.  A bias just
before a batch norm has an analytically zero gradient and holds float32
noise alone (below 1e-6 of the tree's largest gradient): it must stay
below that.  And AdamW's first step turns every gradient element, noise
too, into about one learning rate whose sign the noise sets: an element
whose one-process gradient is below 1e-2 of its leaf's largest (that
floored at 1e-2 of the tree's largest) is held after the step to twice
the step's learning rate, the most AdamW moves it, as
``tests/test_torch_training.py`` holds such elements; retrieval indices
equal.  Against the reference: the train losses within
1e-4 (``tests/test_sharding_rules.py``'s bound), the gradients within 1e-4
of their floored scale (``tests/test_torch_training.py``'s), decode logits
within 1e-5 of their largest magnitude, CTR within 1e-6 and retrieval
values within 1e-5 (``tests/test_torch_recsys.py``'s), indices equal.

The module imports neither jax nor the reference at its top, so that the
ranks (which import it) start without them.
"""
import contextlib
import logging
import pickle
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

WORLD = 8
MESHES = {(2, 4): ("data", "model"), (8, 1): ("data", "model"),
          (2, 2, 2): ("pod", "data", "model")}
#: (name, heads, kv heads, batch, MoE)
DECODE = [("h4-kv2-b8", 4, 2, 8, False), ("h8-kv4-b3", 8, 4, 3, False),
          ("moe-kv4-b8", 4, 4, 8, True)]
DECODE_POS, CACHE_LEN = (9, 10), 16
#: (arch, "full", nodes, edges), (arch, "sampled", roots, fan-outs) and
#: (arch, "molecule", graphs, nodes a graph, edges a graph): the cell
#: kinds' shapes at smoke size
GNN = [("gin-tu", "full", 64, 256), ("gin-tu", "sampled", 3, 4, 4),
       ("gatedgcn", "full", 63, 256), ("gatedgcn", "full", 64, 255),
       ("egnn", "full", 64, 256), ("egnn", "full", 64, 255),
       ("nequip", "molecule", 8, 5, 4), ("nequip", "molecule", 7, 5, 8)]
#: (items, embed dim, train/serve batch, retrieval candidates)
DIEN = [(1000, 8, 8, 96), (999, 6, 5, 50)]
TOP_K = 10
ROWS_MESH = (2, 4)
TOL, LOSS_TOL, REF_LOSS_TOL, REF_GRAD_TOL = 1e-5, 1e-5, 1e-4, 1e-4
GRAD_FLOOR, VANISHING = 1e-2, 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gnn_key(case):
    return "gnn-" + "-".join(map(str, case))


def _dien_key(case):
    return "dien-" + "-".join(map(str, case))


# ---------------------------------------------------------------------------
# the problems (numpy; the reference's weights)
# ---------------------------------------------------------------------------

def _decode_cfg(module, case):
    """The decode case's ``TransformerConfig`` in ``module`` (the port's
    or the reference's transformer)."""
    name, H, Hkv, _, moe = case
    kw = dict(name=name, n_layers=2, d_model=32, n_heads=H, n_kv_heads=Hkv,
              d_ff=64, vocab=64)
    if moe:
        kw.update(qk_norm=True, moe=module.MoEConfig(
            num_experts=8, top_k=2, d_ff_expert=16, num_shared=1))
    return module.TransformerConfig(**kw)


def _input_specs(arch, shape, cfg):
    """``arch``'s ``input_specs`` at ``shape`` (a shape dict of one of its
    kinds, at smoke size) for ``cfg``: meta tensors."""
    import dataclasses
    from repro_torch.configs import get_arch
    spec = dataclasses.replace(get_arch(arch), shapes={"case": shape})
    return spec.input_specs("case", cfg)


def _numpy(t, values):
    return np.asarray(values).astype(str(t.dtype).removeprefix("torch."))


def _prefix_mask(rng, t):
    """A history mask of ``t``'s shape: each row's first half or more."""
    B, T = t.shape
    return _numpy(t, np.arange(T) < rng.integers(T // 2, T + 1, (B, 1)))


def _gnn_batch(case):
    """(the port's smoke config, the batch, n_graphs, kind) of a GNN case,
    laid out by the cell kind's input specs."""
    from repro_torch.configs import get_arch
    arch, kind, *size = case
    cfg = get_arch(arch).make_smoke_config()
    if kind == "full":
        shape = {"kind": kind, "n_nodes": size[0], "n_edges": size[1],
                 "d_feat": cfg.d_in}
    elif kind == "sampled":
        shape = {"kind": kind, "batch_nodes": size[0],
                 "fanout": tuple(size[1:]), "d_feat": cfg.d_in}
    else:
        shape = {"kind": kind, "batch": size[0], "n_nodes": size[1],
                 "n_edges": size[2]}
    specs = _input_specs(arch, shape, cfg)
    n_graphs = specs.get("n_graphs", 1)
    leaves = specs["batch"]
    N = leaves["node_mask"].shape[0]
    rng = np.random.default_rng(GNN.index(case))
    batch = {}
    for k, t in leaves.items():
        if k == "edges":
            v = rng.integers(0, N, t.shape)
        elif k == "graph_ids":
            v = np.repeat(np.arange(n_graphs), N // n_graphs)
        elif k == "labels":
            v = rng.integers(0, getattr(cfg, "n_classes", 1), t.shape)
        elif k == "nodes" and not t.dtype.is_floating_point:
            v = rng.integers(0, cfg.n_species, t.shape)     # species ids
        elif k.endswith("mask"):
            v = rng.random(t.shape) < 0.9
        else:
            v = rng.standard_normal(t.shape)
        batch[k] = _numpy(t, v)
    return cfg, batch, n_graphs, kind


def _dien_problem(case):
    """(train batch, 1-user retrieval request) of a DIEN case, laid out by
    the train and retrieval kinds' input specs."""
    from repro_torch.models import recsys as R
    items, _, B, M = case
    cfg = _dien_cfg(R, case)
    rng = np.random.default_rng(items)
    train = _input_specs("dien", {"kind": "train", "batch": B}, cfg)
    retrieval = _input_specs("dien", {"kind": "retrieval", "batch": 1,
                                      "n_candidates": M}, cfg)
    batch = {"hist": _numpy(train["hist"], rng.integers(
                 0, items, train["hist"].shape)),
             "hist_mask": _prefix_mask(rng, train["hist_mask"]),
             "target": _numpy(train["target"], rng.integers(0, items, B)),
             "label": _numpy(train["label"], rng.integers(0, 2, B))}
    # drawn from 20 items: the top k holds runs of equal scores, each item
    # on several ranks
    request = {"hist": batch["hist"][:1], "hist_mask": batch["hist_mask"][:1],
               "candidates": _numpy(retrieval["candidates"],
                                    rng.integers(0, 20, M))}
    assert all(request[k].shape == tuple(t.shape)
               for k, t in retrieval.items())
    return batch, request


def _dien_cfg(module, case):
    items, e, _, _ = case
    return module.DIENConfig(name="dien-mesh", n_items=items, embed_dim=e,
                             seq_len=6, gru_dim=8, mlp_dims=(12, 8))


# ---------------------------------------------------------------------------
# the port's side: one process, or one rank of the world
# ---------------------------------------------------------------------------

def _whole(tree):
    from repro_torch.dist.sharding import replicated_value
    from repro_torch.optim.adamw import tree_leaves
    return [replicated_value(t).detach().clone().numpy()
            for t in tree_leaves(tree)]


def _place(tree, mesh, specs):
    from repro_torch.runtime import reshard_tree
    return tree if mesh is None else reshard_tree(tree, mesh, specs)


def _tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _state(params, mesh, specs_fn):
    from repro_torch.dist.sharding import opt_state_specs
    from repro_torch.optim import adamw_init
    state = {"params": params, "opt": adamw_init(params)}
    if mesh is None:
        return state
    p = specs_fn(mesh, params)
    return _place(state, mesh, {"params": p, "opt": opt_state_specs(p)})


def run_decode(prob, case, mesh=None):
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    name = case[0]
    cfg = _decode_cfg(T, case)
    p = prob[name]
    params = T.params_from_reference(p["params"])
    cache = _tensors(p["cache"])
    tokens = [torch.from_numpy(t) for t in p["tokens"]]
    if mesh is not None:
        params = _place(params, mesh, SH.lm_param_specs(mesh, params))
        cache = _place(cache, mesh, SH.lm_cache_specs(mesh, cache))
        tokens = [_place(t, mesh, SH.lm_batch_specs(mesh, t)) for t in tokens]
    decode = S.make_lm_decode_step(cfg)
    out = {"logits": [], "cache": []}
    with mesh if mesh is not None else contextlib.nullcontext():
        for pos, t in zip(DECODE_POS, tokens):
            logits, cache = decode(params, {"cache": cache, "tokens": t,
                                            "pos": pos})
            out["logits"].append(SH.replicated_value(logits).numpy())
            out["cache"].append([SH.replicated_value(cache[k]).numpy().copy()
                                 for k in ("k", "v")])     # in place
    if mesh is not None:
        out["cache_spec"] = tuple(SH.lm_cache_specs(mesh, cache)["k"])
    return out


def run_gnn(prob, case, mesh=None, rows=None):
    """(loss, gradients, loss of the train step, parameters after it); with
    ``rows`` each ``L.dense`` call's row count appended to it."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import steps as S
    from repro_torch.models import gnn as G
    from repro_torch.models import layers as L
    from repro_torch.training import value_and_grad
    p = prob[_gnn_key(case)]
    cfg = getattr(G, p["cfg_class"])(**p["cfg"])
    params = G.params_from_reference(p["params"])
    batch = _tensors(p["batch"])
    state = _state(params, mesh, SH.gnn_param_specs)
    if mesh is not None:
        batch = _place(batch, mesh, SH.gnn_batch_specs(mesh, batch))
    step = S.make_gnn_train_step(cfg, p["kind"], n_graphs=p["n_graphs"])
    loss = S.gnn_loss_fn(cfg, p["kind"], p["n_graphs"])
    dense = L.dense
    if rows is not None:
        def counting(q, x):
            rows.append(int(x.shape[0]))
            return dense(q, x)
        L.dense = counting
    try:
        val, grads = value_and_grad(
            lambda q, b: loss(q, b, prep=step.prep_cache.get(b)),
            state["params"], batch)
        state, metrics = step(state, batch)
    finally:
        L.dense = dense
    return {"loss": float(val), "grads": _whole(grads),
            "step_loss": float(metrics["loss"]), "lr": float(metrics["lr"]),
            "params": _whole(state["params"])}


def run_dien(prob, case, mesh=None):
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import steps as S
    from repro_torch.models import recsys as R
    from repro_torch.training import value_and_grad
    p = prob[_dien_key(case)]
    cfg = _dien_cfg(R, case)
    params = R.params_from_reference(p["params"])
    batch, request = _tensors(p["batch"]), _tensors(p["request"])
    serve_b = {k: batch[k] for k in _input_specs(
        "dien", {"kind": "serve", "batch": len(p["batch"]["target"])}, cfg)}
    state = _state(params, mesh, SH.recsys_param_specs)
    if mesh is not None:
        batch = _place(batch, mesh, SH.recsys_batch_specs(mesh, batch))
        serve_b = _place(serve_b, mesh, SH.recsys_batch_specs(mesh, serve_b))
        request = _place(request, mesh, SH.recsys_batch_specs(mesh, request))
    ctr = S.make_recsys_serve_step(cfg)(state["params"], serve_b)
    values, indices = S.make_recsys_retrieval_step(cfg, top_k=TOP_K)(
        state["params"], request)
    val, grads = value_and_grad(lambda q, b: R.dien_loss(cfg, q, b),
                                state["params"], batch)
    state, metrics = S.make_recsys_train_step(cfg)(state, batch)
    out = {"ctr": SH.replicated_value(ctr).numpy(), "values": values.numpy(),
           "indices": indices.numpy(), "loss": float(val),
           "grads": _whole(grads), "step_loss": float(metrics["loss"]),
           "lr": float(metrics["lr"]), "params": _whole(state["params"])}
    if mesh is not None:
        out["table_spec"] = tuple(SH.recsys_param_specs(mesh, params)[
            "item_table"]["table"])
    return out


def _rank_worker(rank, port, out_dir):
    """One gloo rank: every case on every mesh, rank 0 saving the results
    (every rank saves its dense products' row counts)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    torch.set_num_threads(1)          # 8 ranks share the host's cores
    # DTensor warns on every collective over two mesh dims
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    out = Path(out_dir)
    with open(out / "problem.pkl", "rb") as f:
        prob = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=WORLD)
    try:
        res, rows = {}, {}
        for shape, names in MESHES.items():
            mesh = make_device_mesh(shape, names, device="cpu")
            for case in DECODE:
                res[shape, case[0]] = run_decode(prob, case, mesh)
            for case in GNN:
                counted = rows.setdefault(_gnn_key(case), []) \
                    if shape == ROWS_MESH else None
                res[shape, _gnn_key(case)] = run_gnn(prob, case, mesh,
                                                     counted)
            for case in DIEN:
                res[shape, _dien_key(case)] = run_dien(prob, case, mesh)
        with open(out / f"rows{rank}.pkl", "wb") as f:
            pickle.dump(rows, f)
        if rank == 0:
            with open(out / "results.pkl", "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the world, the reference and one process
# ---------------------------------------------------------------------------

def _reference(prob):
    """The reference's jitted single-device results of every case."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch
    from repro.launch import steps as RS
    from repro.models import recsys as RR
    from repro.models import transformer as RT
    ref = {}
    for case in DECODE:
        name = case[0]
        cfg = _decode_cfg(RT, case)
        p = prob[name]
        decode = jax.jit(RS.make_lm_decode_step(cfg))
        cache = {k: jnp.asarray(v) for k, v in p["cache"].items()}
        logits = []
        for pos, t in zip(DECODE_POS, p["tokens"]):
            lg, cache = decode(p["params"], {"cache": cache,
                                             "tokens": jnp.asarray(t),
                                             "pos": jnp.int32(pos)})
            logits.append(np.asarray(lg))
        ref[name] = {"logits": logits}
    for case in GNN:
        p = prob[_gnn_key(case)]
        cfg = get_arch(case[0]).make_smoke_config()
        loss = RS.gnn_loss_fn(cfg, p["kind"], p["n_graphs"])
        val, grads = jax.jit(jax.value_and_grad(loss))(
            p["params"], {k: jnp.asarray(v) for k, v in p["batch"].items()})
        ref[_gnn_key(case)] = {"loss": float(val), "grads": [
            np.asarray(g) for g in jax.tree.leaves(grads)]}
    for case in DIEN:
        p = prob[_dien_key(case)]
        cfg = _dien_cfg(RR, case)
        batch = {k: jnp.asarray(v) for k, v in p["batch"].items()}
        val, grads = jax.jit(jax.value_and_grad(
            lambda q, b: RR.dien_loss(cfg, q, b)))(p["params"], batch)
        ctr = jax.jit(RS.make_recsys_serve_step(cfg))(
            p["params"], {k: batch[k] for k in ("hist", "hist_mask",
                                                "target")})
        values, indices = jax.jit(RS.make_recsys_retrieval_step(
            cfg, top_k=TOP_K))(p["params"], {
                k: jnp.asarray(v) for k, v in p["request"].items()})
        ref[_dien_key(case)] = {
            "loss": float(val), "ctr": np.asarray(ctr),
            "values": np.asarray(values), "indices": np.asarray(indices),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)]}
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank world's results, with the reference's and the port's
    one-process results of the same problems computed here meanwhile."""
    import dataclasses
    import jax
    import torch.multiprocessing as mp
    from repro.configs import get_arch
    from repro.launch import steps as RS
    from repro.models import recsys as RR
    from repro.models import transformer as RT
    out = tmp_path_factory.mktemp("mesh_steps")
    prob = {}
    from repro_torch.models import transformer as T
    for case in DECODE:
        name, _, Hkv, B, _ = case
        cfg = _decode_cfg(RT, case)
        rng = np.random.default_rng(B * 10 + Hkv)
        specs = _input_specs("starcoder2-3b", {"kind": "decode", "batch": B,
                                               "seq": CACHE_LEN},
                             _decode_cfg(T, case))
        prob[name] = {
            "params": jax.tree.map(np.asarray,
                                   RT.init_params(cfg, jax.random.key(B))),
            "cache": {k: _numpy(t, rng.standard_normal(t.shape))
                      for k, t in specs["cache"].items()},
            "tokens": [_numpy(specs["tokens"], rng.integers(
                0, cfg.vocab, specs["tokens"].shape)) for _ in DECODE_POS]}
    for case in GNN:
        cfg, batch, n_graphs, kind = _gnn_batch(case)
        prob[_gnn_key(case)] = {
            "cfg_class": cfg.__class__.__name__,
            "cfg": dataclasses.asdict(cfg), "kind": kind,
            "n_graphs": n_graphs, "batch": batch,
            "params": jax.tree.map(np.asarray, RS.gnn_init(
                get_arch(case[0]).make_smoke_config(), jax.random.key(0)))}
    for case in DIEN:
        batch, request = _dien_problem(case)
        prob[_dien_key(case)] = {
            "batch": batch, "request": request,
            "params": jax.tree.map(np.asarray, RR.dien_init(
                _dien_cfg(RR, case), jax.random.key(1)))}
    with open(out / "problem.pkl", "wb") as f:
        pickle.dump(prob, f)
    ctx = mp.spawn(_rank_worker, args=(_free_port(), str(out)),
                   nprocs=WORLD, join=False)
    ref = _reference(prob)
    one = {}
    for case in DECODE:
        one[case[0]] = run_decode(prob, case)
    for case in GNN:
        one[_gnn_key(case)] = run_gnn(prob, case)
    for case in DIEN:
        one[_dien_key(case)] = run_dien(prob, case)
    while not ctx.join():
        pass
    with open(out / "results.pkl", "rb") as f:
        res = pickle.load(f)
    rows = []
    for rank in range(WORLD):
        with open(out / f"rows{rank}.pkl", "rb") as f:
            rows.append(pickle.load(f))
    return {"prob": prob, "res": res, "ref": ref, "one": one, "rows": rows}


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _within(got, want, tol, floor=0.0):
    """Each leaf of ``got`` within ``tol`` of its ``want`` leaf's largest
    magnitude, that magnitude floored at ``floor`` of the tree's largest;
    the largest share."""
    assert len(got) == len(want)
    top = max((float(np.abs(w).max()) for w in want if np.size(w)),
              default=0.0)
    worst = 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        if not b.size:
            continue
        scale = max(float(np.abs(b).max()), floor * top, 1e-30)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    assert worst <= tol, worst
    return worst


def _grads_within(got, want, tol):
    """Gradients as ``_within`` with the scale floored at ``GRAD_FLOOR`` of
    the tree's largest; a leaf of float32 noise alone (below
    ``VANISHING`` of it) must stay below that."""
    top = max(float(np.abs(w).max()) for w in want if np.size(w))
    live = [float(np.abs(w).max()) >= VANISHING * top if np.size(w)
            else True for w in want]
    for a, b, keep in zip(got, want, live):
        if not keep:
            assert float(np.abs(a).max()) <= VANISHING * top
    return _within([a for a, k in zip(got, live) if k],
                   [b for b, k in zip(want, live) if k], tol, GRAD_FLOOR)


def _params_within(got, want, grads, lr):
    """Parameters after one step within ``TOL`` of each leaf's largest
    magnitude, element by element where the one-process gradient is at
    least ``GRAD_FLOOR`` of its leaf's floored scale; elsewhere within
    twice the step's learning rate."""
    top = max(float(np.abs(g).max()) for g in grads if np.size(g))
    for a, b, g in zip(got, want, grads):
        if not np.size(b):
            continue
        err = np.abs(np.asarray(a, np.float64) - b)
        scale = max(float(np.abs(g).max()), GRAD_FLOOR * top)
        live = np.abs(g) >= GRAD_FLOOR * scale
        assert float(err[live].max(initial=0.0)) <= TOL * max(
            float(np.abs(b).max()), 1e-30)
        assert float(err[~live].max(initial=0.0)) <= 2 * lr, lr


def _loss_close(got, want, tol):
    assert abs(got - want) <= tol * abs(want), (got, want)


MESH_IDS = [f"{'x'.join(map(str, s))}" for s in MESHES]


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", DECODE, ids=[c[0] for c in DECODE])
def test_decode_on_a_dtensor_cache(world, shape, case):
    name, _, Hkv, B, _ = case
    got = world["res"][shape, name]
    want = world["one"][name]
    # the rule's branches: batch over the data axes iff it divides them,
    # kv heads over "model" iff they divide it
    names = MESHES[shape]
    nf = int(np.prod([s for s, n in zip(shape, names) if n != "model"]))
    nm = shape[names.index("model")]
    spec = got["cache_spec"]
    assert (spec[1] is not None) == (B % nf == 0), spec
    assert (spec[2] == "model") == (Hkv % nm == 0), spec
    for step in range(len(DECODE_POS)):
        _within([got["logits"][step]], [want["logits"][step]], TOL)
        _within(got["cache"][step], want["cache"][step], TOL)
        _within([got["logits"][step]],
                [world["ref"][name]["logits"][step]], TOL)


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", GNN, ids=[_gnn_key(c) for c in GNN])
def test_gnn_train_step_on_the_mesh(world, shape, case):
    key = _gnn_key(case)
    got, want, ref = world["res"][shape, key], world["one"][key], \
        world["ref"][key]
    _loss_close(got["loss"], want["loss"], LOSS_TOL)
    _loss_close(got["step_loss"], want["step_loss"], LOSS_TOL)
    assert abs(got["loss"] - ref["loss"]) < REF_LOSS_TOL
    _grads_within(got["grads"], want["grads"], TOL)
    _within(got["grads"], ref["grads"], REF_GRAD_TOL, GRAD_FLOOR)
    _params_within(got["params"], want["params"], want["grads"], want["lr"])


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", DIEN, ids=[_dien_key(c) for c in DIEN])
def test_dien_steps_on_the_mesh(world, shape, case):
    key = _dien_key(case)
    got, want, ref = world["res"][shape, key], world["one"][key], \
        world["ref"][key]
    items, e, _, _ = case
    names = MESHES[shape]
    nf = int(np.prod([s for s, n in zip(shape, names) if n != "model"]))
    nm = shape[names.index("model")]
    spec = got["table_spec"]
    assert (spec[0] == "model") == (items % nm == 0), spec
    assert (spec[1] is not None) == (e % nf == 0), spec
    _within([got["ctr"]], [want["ctr"]], TOL)
    np.testing.assert_allclose(got["ctr"], ref["ctr"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["indices"], want["indices"])
    np.testing.assert_array_equal(got["indices"], ref["indices"])
    _within([got["values"]], [want["values"]], TOL)
    np.testing.assert_allclose(got["values"], ref["values"], rtol=0,
                               atol=1e-5)
    _loss_close(got["loss"], want["loss"], LOSS_TOL)
    _loss_close(got["step_loss"], want["step_loss"], LOSS_TOL)
    assert abs(got["loss"] - ref["loss"]) < REF_LOSS_TOL
    _grads_within(got["grads"], want["grads"], TOL)
    _within(got["grads"], ref["grads"], REF_GRAD_TOL, GRAD_FLOOR)
    _params_within(got["params"], want["params"], want["grads"], want["lr"])


@pytest.mark.parametrize("case", DIEN, ids=[_dien_key(c) for c in DIEN])
def test_one_process_retrieval_orders_ties_as_the_reference(world, case):
    """Repeated candidates score equally; the one-device step returns them
    in candidate order, as ``lax.top_k`` does (``torch.topk`` promises no
    order among equal values)."""
    key = _dien_key(case)
    cand = world["prob"][key]["request"]["candidates"]
    idx = world["one"][key]["indices"]
    assert len(set(cand[idx].tolist())) < len(idx)
    np.testing.assert_array_equal(idx, world["ref"][key]["indices"])
    np.testing.assert_allclose(world["one"][key]["values"],
                               world["ref"][key]["values"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", [c for c in GNN if c[1] == "full"
                                  and c[2] % WORLD == 0],
                         ids=lambda c: _gnn_key(c))
def test_gnn_dense_products_run_on_each_ranks_rows(world, case):
    """On (2, 4) with the node rows split, every ``L.dense`` of the step
    reads a rank's own node rows (N / 2), its own edge rows (E / 2 when
    split, else all E) or the readout's graphs: never all N nodes."""
    key = _gnn_key(case)
    _, _, N, E = case
    split_edges = E % 2 == 0
    allowed = {N // 2, E // 2 if split_edges else E, 1}
    for rank_rows in world["rows"]:
        seen = rank_rows[key]
        assert seen and set(seen) <= allowed, (sorted(set(seen)), allowed)
        assert N not in seen
        assert seen.count(N // 2) >= 4
