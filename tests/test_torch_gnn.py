"""The port's GNN models (``repro_torch.models.gnn``), configs and GNN
losses against the reference's.

``torch.Generator`` cannot reproduce ``jax.random``, so every parity case
carries the reference's ``*_init`` weights into the port with
``params_from_reference`` and feeds both the same numpy batch.  Tolerance
of a model output: every element within 1e-5 of the reference's relative
to the output's largest magnitude (``_close``: float32 matmuls, einsums
and transcendentals round differently in the two frameworks, and the
segment sums add in another order).  The segment sums on the CPU are the
``spmm`` ops' plain versions; ``neighbour_sum`` takes the ``bound`` route.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.gnn as RG
from repro.configs import get_arch as r_get_arch
from repro.configs.base import GNN_SHAPES as R_GNN_SHAPES
from repro.data.gnn_batches import molecule_batch
from repro.launch import steps as RS
import repro_torch.models.gnn as G
from repro_torch.configs import get_arch
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.kernels import spmm as spmm_ops
from repro_torch.launch import steps as S

RTOL = 1e-5
ARCHS = {"gin": "gin-tu", "gatedgcn": "gatedgcn", "egnn": "egnn",
         "nequip": "nequip"}
MODELS = tuple(ARCHS)


def _close(got, want, rtol=RTOL):
    """Every element within ``rtol`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _torch(batch):
    return {k: None if v is None else torch.from_numpy(np.asarray(v))
            for k, v in batch.items()}


def _jnp(batch):
    return {k: None if v is None else jnp.asarray(v)
            for k, v in batch.items()}


def _graph_batch(seed, N=40, E=160, d_in=8, n_graphs=3, pad_nodes=3,
                 drop_edges=0.2):
    """A padded multi-graph batch: random edges, the last ``pad_nodes``
    nodes and a share of the edges masked, ``n_graphs`` graphs."""
    rng = np.random.default_rng(seed)
    node_mask = np.ones(N, np.float32)
    node_mask[N - pad_nodes:] = 0.0
    return {
        "nodes": rng.normal(size=(N, d_in)).astype(np.float32),
        "edges": rng.integers(0, N, (E, 2)).astype(np.int32),
        "edge_attr": None,
        "node_mask": node_mask,
        "edge_mask": (rng.random(E) >= drop_edges).astype(np.float32),
        "graph_ids": np.sort(rng.integers(0, n_graphs, N)).astype(np.int32),
        "coords": rng.normal(size=(N, 3)).astype(np.float32),
        "labels": rng.integers(0, 4, N).astype(np.int32),
    }, n_graphs


def _batch_for(kind, cfg, seed):
    if kind == "nequip":
        b, B = molecule_batch(4, n_nodes=10, n_edges=24,
                              n_species=cfg.n_species, seed=seed)
        return b, B
    return _graph_batch(seed, d_in=cfg.d_in)


def _config(kind, size):
    spec = r_get_arch(ARCHS[kind])
    cfg = spec.make_smoke_config() if size == "smoke" else spec.make_config()
    pcls = G.GNN_MODELS[kind][0]
    return cfg, pcls(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=[(k, s) for k in MODELS
                                        for s in ("smoke", "full")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """(kind, ref cfg, port cfg, ref params, port params)."""
    kind, size = request.param
    cfg, pcfg = _config(kind, size)
    _, r_init, _ = RG.GNN_MODELS[kind]
    r_params = r_init(cfg, jax.random.key(0))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    return kind, cfg, pcfg, r_params, params


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
@pytest.mark.parametrize("make", ["make_config", "make_smoke_config"])
def test_configs_match_reference(arch, make):
    spec, port = r_get_arch(arch), get_arch(arch)
    assert port.family == spec.family == "gnn"
    want, got = getattr(spec, make)(), getattr(port, make)()
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", sorted(ARCHS.values()))
@pytest.mark.parametrize("shape", sorted(R_GNN_SHAPES))
def test_config_for_shape_matches_reference(arch, shape):
    assert (dataclasses.asdict(get_arch(arch).config_for_shape(shape))
            == dataclasses.asdict(r_get_arch(arch).config_for_shape(shape)))


def test_gnn_shapes_match_reference():
    assert GNN_SHAPES == R_GNN_SHAPES


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", MODELS)
def test_init_has_the_reference_tree(kind):
    cfg, pcfg = _config(kind, "smoke")
    r_shapes = jax.tree.map(lambda a: a.shape,
                            RG.GNN_MODELS[kind][1](cfg, jax.random.key(0)))
    p = G.GNN_MODELS[kind][1](pcfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: tuple(t.shape), p) == r_shapes
    assert S.gnn_init(pcfg, torch.Generator().manual_seed(0)).keys() \
        == p.keys()


def test_params_from_reference_carries_every_leaf(model):
    _, _, _, r_params, params = model
    want = jax.tree_util.tree_leaves_with_path(r_params)
    got = jax.tree_util.tree_leaves_with_path(params)
    assert [jax.tree_util.keystr(p) for p, _ in got] \
        == [jax.tree_util.keystr(p) for p, _ in want]
    for (_, t), (_, a) in zip(got, want):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("tree", [
    {"w": np.zeros(3)},
    {"encoder": {}, "layers": [{"mlp": {}}], "head": {}},
    {"encoder": {}, "layers": {}, "head": {}},
    {"embed": {}, "layers": [{"radial": {}}], "energy_head": {}}])
def test_params_from_reference_refuses_another_tree(tree):
    with pytest.raises(ValueError, match="not a GNN parameter tree"):
        G.params_from_reference(tree)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

OUTPUTS = {"gin": ("node_logits", "graph_logits", "node_repr"),
           "gatedgcn": ("node_logits", "graph_logits", "node_repr"),
           "egnn": ("node_logits", "graph_logits", "node_repr", "coords"),
           "nequip": ("atom_energy", "energy", "h0", "h1")}


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(model, seed):
    kind, cfg, pcfg, r_params, params = model
    batch, n_graphs = _batch_for(kind, cfg, seed)
    r_apply, apply = RG.GNN_MODELS[kind][2], G.GNN_MODELS[kind][2]
    want = jax.jit(lambda p, b: r_apply(cfg, p, b, n_graphs=n_graphs))(
        r_params, _jnp(batch))
    got = apply(pcfg, params, _torch(batch), n_graphs=n_graphs)
    for key in OUTPUTS[kind]:
        _close(got[key].numpy(), np.asarray(want[key]))


def test_forward_takes_a_prepared_batch(model):
    """``prep=`` reuses one host preparation; the output is the same."""
    kind, cfg, pcfg, _, params = model
    batch, n_graphs = _batch_for(kind, cfg, 3)
    tb = _torch(batch)
    apply = G.GNN_MODELS[kind][2]
    gp = G.graph_prep(tb, n_graphs)
    a = apply(pcfg, params, tb, n_graphs=n_graphs, prep=gp)
    b = apply(pcfg, params, tb, n_graphs=n_graphs)
    for key in OUTPUTS[kind]:
        assert torch.equal(a[key], b[key])


@pytest.mark.parametrize("kind", ["gin", "gatedgcn", "egnn"])
def test_full_width_on_a_larger_graph(kind):
    """The published widths on a 300-node graph with a 1,500-edge hub (cut
    into chunks by the port's segment sum): every output within 1e-4 of
    its largest magnitude.  The hub's float32 sum is taken in another order
    than the reference's, and the batch norms of the deep stacks amplify
    that difference (gin-tu's graph logits differ by 2.7e-5 of their
    largest)."""
    cfg, pcfg = _config(kind, "full")
    r_params = RG.GNN_MODELS[kind][1](cfg, jax.random.key(1))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    batch, n_graphs = _graph_batch(4, N=300, E=4000, d_in=cfg.d_in,
                                   n_graphs=2)
    batch["edges"][:1500, 1] = 7                  # a hub above SPLIT_EDGES
    want = RG.GNN_MODELS[kind][2](cfg, r_params, _jnp(batch),
                                  n_graphs=n_graphs)
    got = G.GNN_MODELS[kind][2](pcfg, params, _torch(batch),
                                n_graphs=n_graphs)
    for key in OUTPUTS[kind]:
        _close(got[key].numpy(), np.asarray(want[key]), rtol=1e-4)


def test_gatedgcn_edge_attr_matches_reference():
    cfg = dataclasses.replace(r_get_arch("gatedgcn").make_smoke_config(),
                              d_edge_in=5)
    pcfg = G.GatedGCNConfig(**dataclasses.asdict(cfg))
    r_params = RG.gatedgcn_init(cfg, jax.random.key(2))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    batch, n_graphs = _graph_batch(5, d_in=cfg.d_in)
    batch["edge_attr"] = np.random.default_rng(5).normal(
        size=(len(batch["edges"]), 5)).astype(np.float32)
    want = RG.gatedgcn_apply(cfg, r_params, _jnp(batch), n_graphs=n_graphs)
    got = G.gatedgcn_apply(pcfg, params, _torch(batch), n_graphs=n_graphs)
    _close(got["node_logits"].numpy(), np.asarray(want["node_logits"]))


def test_nequip_one_hot_species_matches_reference():
    cfg, pcfg = _config("nequip", "smoke")
    r_params = RG.nequip_init(cfg, jax.random.key(3))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    batch, B = molecule_batch(3, n_nodes=8, n_edges=16,
                              n_species=cfg.n_species, seed=2,
                              one_hot_species=True)
    want = RG.nequip_apply(cfg, r_params, _jnp(batch), n_graphs=B)
    got = G.nequip_apply(pcfg, params, _torch(batch), n_graphs=B)
    _close(got["energy"].numpy(), np.asarray(want["energy"]))


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(0,), (1,), (3,), (8, 3), (4, 3, 3),
                                   (70,)])
@pytest.mark.parametrize("E", [0, 1, 300])
@pytest.mark.parametrize("drop", [False, True])
def test_segment_sum_matches_jax(shape, E, drop):
    """Any trailing shape, no edges, and (``drop``) ids outside [0, N),
    which JAX's segment sum drops."""
    rng = np.random.default_rng(E + len(shape))
    N = 25
    data = rng.normal(size=(E,) + shape[1:] if shape != (0,)
                      else (E,)).astype(np.float32)
    ids = rng.integers(-5 if drop else 0, N + 5 if drop else N, E)
    want = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids),
                               num_segments=N)
    got = G.segment_sum(torch.from_numpy(data),
                        G.segments(ids, N, "cpu"), N)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want), rtol=1e-6)


def test_neighbour_sum_takes_the_bound_route():
    batch, _ = _graph_batch(6)
    tb = _torch(batch)
    gp = G.graph_prep(tb)
    h = torch.randn(40, 16, generator=torch.Generator().manual_seed(0))
    assert spmm_ops.route(h, gp.src, gp.edge_mask, gp.edges) == "bound"
    src, dst = batch["edges"][:, 0], batch["edges"][:, 1]
    want = jax.ops.segment_sum(
        jnp.asarray(h.numpy())[src] * batch["edge_mask"][:, None], dst,
        num_segments=40)
    _close(G.neighbour_sum(h, gp).numpy(), np.asarray(want), rtol=1e-6)


def test_gather_follows_jax_index_rule():
    """Negative endpoints wrap once, then every index clamps (JAX's
    gather); the port's models see the same rows."""
    cfg, pcfg = _config("egnn", "smoke")
    r_params = RG.egnn_init(cfg, jax.random.key(4))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    batch, n_graphs = _graph_batch(7, d_in=cfg.d_in)
    batch["edges"][::5, 0] = -3
    batch["edges"][1::5, 0] = 55
    want = RG.egnn_apply(cfg, r_params, _jnp(batch), n_graphs=n_graphs)
    got = G.egnn_apply(pcfg, params, _torch(batch), n_graphs=n_graphs)
    _close(got["node_logits"].numpy(), np.asarray(want["node_logits"]))


@pytest.mark.parametrize("kind", ["masked_batchnorm", "bessel_rbf",
                                  "tp_messages", "mix"])
def test_pieces_match_reference(kind):
    rng = np.random.default_rng(8)
    if kind == "masked_batchnorm":
        x = rng.normal(size=(30, 7)).astype(np.float32)
        m = (rng.random(30) > 0.3).astype(np.float32)
        _close(G._masked_batchnorm(torch.from_numpy(x),
                                   torch.from_numpy(m)).numpy(),
               np.asarray(RG._masked_batchnorm(x, m)))
    elif kind == "bessel_rbf":
        r = np.abs(rng.normal(size=50) * 4).astype(np.float32)
        r[0] = 0.0
        _close(G._bessel_rbf(torch.from_numpy(r), 8, 5.0).numpy(),
               np.asarray(RG._bessel_rbf(jnp.asarray(r), 8, 5.0)))
    elif kind == "tp_messages":
        N, E, C = 12, 40, 4
        h0 = rng.normal(size=(N, C)).astype(np.float32)
        h1 = rng.normal(size=(N, C, 3)).astype(np.float32)
        h2 = rng.normal(size=(N, C, 3, 3)).astype(np.float32)
        Y1 = rng.normal(size=(E, 3)).astype(np.float32)
        Y2 = rng.normal(size=(E, 3, 3)).astype(np.float32)
        w = rng.normal(size=(E, 10, C)).astype(np.float32)
        src = rng.integers(0, N, E)
        want = RG._tp_messages(*map(jnp.asarray, (h0, h1, h2, Y1, Y2)),
                               jnp.asarray(src), jnp.asarray(w))
        got = G._tp_messages(*map(torch.from_numpy,
                                  (h0, h1, h2, Y1, Y2, src, w)))
        for g, wt in zip(got, want):
            _close(g.numpy(), np.asarray(wt))
    else:
        p = {"w": rng.normal(size=(8, 4)).astype(np.float32)}
        tp = {"w": torch.from_numpy(p["w"])}
        h1, a1 = (rng.normal(size=(5, 4, 3)).astype(np.float32)
                  for _ in range(2))
        h2, a2 = (rng.normal(size=(5, 4, 3, 3)).astype(np.float32)
                  for _ in range(2))
        _close(G._mix_vec(tp, torch.from_numpy(h1),
                          torch.from_numpy(a1)).numpy(),
               np.asarray(RG._mix_vec(p, h1, a1)))
        _close(G._mix_mat(tp, torch.from_numpy(h2),
                          torch.from_numpy(a2)).numpy(),
               np.asarray(RG._mix_mat(p, h2, a2)))


def test_egnn_layer_terms_match_reference():
    cfg, _ = _config("egnn", "smoke")
    r_params = RG.egnn_init(cfg, jax.random.key(5))
    lp = jax.tree.map(np.asarray, r_params["layers"][0])
    tlp = G.params_from_reference(
        jax.tree.map(np.asarray, r_params))["layers"][0]
    rng = np.random.default_rng(9)
    h = rng.normal(size=(20, cfg.d_hidden)).astype(np.float32)
    x = rng.normal(size=(20, 3)).astype(np.float32)
    src, dst = rng.integers(0, 20, 60), rng.integers(0, 20, 60)
    em = (rng.random(60) > 0.2).astype(np.float32)[:, None]
    want = RG.egnn_layer_terms(lp, h, x, src, dst, em)
    got = G.egnn_layer_terms(tlp, *map(torch.from_numpy,
                                       (h, x, src, dst, em)))
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gin", "gatedgcn", "egnn"])
def test_gnn_node_loss_matches_reference(kind):
    cfg, pcfg = _config(kind, "smoke")
    r_params = RG.GNN_MODELS[kind][1](cfg, jax.random.key(6))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    batch, n_graphs = _graph_batch(10, d_in=cfg.d_in)
    batch["labels"] %= cfg.n_classes
    r_apply, apply = RG.GNN_MODELS[kind][2], G.GNN_MODELS[kind][2]
    want = RG.gnn_node_loss(lambda p, b: r_apply(cfg, p, b), r_params,
                            _jnp(batch), cfg.n_classes)
    got = G.gnn_node_loss(lambda p, b: apply(pcfg, p, b), params,
                          _torch(batch), pcfg.n_classes)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_nequip_energy_loss_matches_reference():
    cfg, pcfg = _config("nequip", "smoke")
    r_params = RG.nequip_init(cfg, jax.random.key(7))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    batch, B = molecule_batch(4, n_nodes=10, n_edges=24,
                              n_species=cfg.n_species, seed=1)
    want = RG.nequip_energy_loss(
        lambda p, b, n_graphs: RG.nequip_apply(cfg, p, b, n_graphs=n_graphs),
        r_params, _jnp(batch), B)
    got = G.nequip_energy_loss(
        lambda p, b, n_graphs: G.nequip_apply(pcfg, p, b, n_graphs=n_graphs),
        params, _torch(batch), B)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("kind", MODELS)
@pytest.mark.parametrize("cell", ["full", "sampled", "molecule"])
def test_gnn_loss_fn_matches_reference(kind, cell):
    """``steps.gnn_loss_fn`` for every model and shape kind: the node
    loss (with a ``loss_mask`` on sampled cells), NequIP's energy loss on
    molecules and its per-node regression elsewhere."""
    cfg, pcfg = _config(kind, "smoke")
    r_params = RG.GNN_MODELS[kind][1](cfg, jax.random.key(8))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    if kind == "nequip" or cell == "molecule":
        batch, n_graphs = molecule_batch(
            3, n_nodes=10, n_edges=20,
            n_species=getattr(cfg, "n_species", 4), seed=4,
            one_hot_species=kind != "nequip")
        if kind != "nequip":
            rng = np.random.default_rng(4)
            batch["nodes"] = rng.normal(size=(30, cfg.d_in)).astype(
                np.float32)
            batch["labels"] = rng.integers(0, cfg.n_classes, 30).astype(
                np.int32)
    else:
        batch, n_graphs = _graph_batch(11, d_in=cfg.d_in)
        batch["labels"] %= cfg.n_classes
    if cell == "sampled":
        batch["loss_mask"] = (np.arange(len(batch["node_mask"])) % 3
                              == 0).astype(np.float32)
    want = RS.gnn_loss_fn(cfg, cell, n_graphs)(r_params, _jnp(batch))
    got = S.gnn_loss_fn(pcfg, cell, n_graphs)(params, _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_train_step_is_not_ported_yet():
    """The GNN train step is ported now (this slice's training): its first
    step's loss is the reference's loss on the same weights and batch
    (``tests/test_torch_training.py`` holds the gradients and steps)."""
    cfg, pcfg = _config("gin", "smoke")
    r_params = RG.GNN_MODELS["gin"][1](cfg, jax.random.key(0))
    batch, n_graphs = _graph_batch(4, d_in=cfg.d_in)
    want = RS.gnn_loss_fn(cfg, "full", n_graphs)(r_params, _jnp(batch))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    state = {"params": params, "opt": S.adamw_init(params)}
    _, metrics = S.make_gnn_train_step(pcfg, "full", n_graphs=n_graphs)(
        state, _torch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(want),
                               rtol=RTOL)
