"""The port's DIEN serving and retrieval against the reference's.

``torch.Generator`` cannot reproduce ``jax.random``, so every parity case
carries the reference's ``dien_init`` weights into the port with
``params_from_reference`` and feeds both the same numpy batch.  Tolerances:
logit atol 1e-5 and aux loss rtol 1e-5 (float32 products and
transcendentals round differently in the two frameworks; measured
differences are ~1e-8), CTR atol 1e-6, retrieval values atol 1e-5 with
equal top-k index sets wherever the scores are distinct.  Cases run on the
smoke config and on the published widths with ``n_items`` cut to 10,000.
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as r_serve
from repro.configs import get_arch as r_get_arch
from repro.configs.base import RECSYS_SHAPES as R_RECSYS_SHAPES
from repro.data.recsys_data import InteractionStream as RStream
from repro.launch import steps as RS
from repro.models import recsys as RR
import repro_torch.launch.serve as serve
from repro_torch.configs import get_arch
from repro_torch.configs.base import RECSYS_SHAPES
from repro_torch.data import InteractionStream
from repro_torch.kernels.augru import launches
from repro_torch.launch import steps as S
from repro_torch.models import recsys as R

TOP_K = 20


def _configs(name):
    """(reference config, port config) for ``name``."""
    spec = r_get_arch("dien")
    if name == "smoke":
        cfg = spec.make_smoke_config()
    else:                                  # the published widths, 10k items
        cfg = dataclasses.replace(spec.make_config(), n_items=10_000)
    return cfg, R.DIENConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=["smoke", "full_10k"])
def model(request):
    """(ref cfg, port cfg, ref params, port params, numpy batch)."""
    cfg, pcfg = _configs(request.param)
    r_params = RR.dien_init(cfg, jax.random.key(0))
    params = R.params_from_reference(jax.tree.map(np.asarray, r_params))
    batch = RStream(cfg.n_items, 48, cfg.seq_len, seed=3).next_batch()
    return cfg, pcfg, r_params, params, batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_params_from_reference_carries_every_leaf(model):
    _, _, r_params, params, _ = model
    r_leaves = jax.tree_util.tree_leaves_with_path(r_params)
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in r_leaves}
    got = {}
    for key, node in params.items():
        if isinstance(node, list):
            for i, layer in enumerate(node):
                for k, v in layer.items():
                    got[f"['{key}'][{i}]['{k}']"] = v
        elif isinstance(node, dict):
            for k, v in node.items():
                got[f"['{key}']['{k}']"] = v
        else:
            got[f"['{key}']"] = node
    assert set(got) == set(flat)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), flat[k])


def test_params_from_reference_refuses_another_tree():
    with pytest.raises(ValueError, match="not a DIEN parameter tree"):
        R.params_from_reference({"w": np.zeros(3)})


def test_dien_init_has_the_reference_tree():
    cfg, pcfg = _configs("smoke")
    r_shapes = jax.tree.map(lambda a: a.shape,
                            RR.dien_init(cfg, jax.random.key(0)))
    p = R.dien_init(pcfg, torch.Generator().manual_seed(0))
    p_shapes = jax.tree.map(lambda t: tuple(t.shape), p)
    assert p_shapes == r_shapes


def test_dien_forward_matches_reference(model):
    cfg, pcfg, r_params, params, batch = model
    r_logit, r_aux = jax.jit(lambda p, b: RR.dien_forward(cfg, p, b))(
        r_params, _jnp(batch))
    logit, aux = R.dien_forward(pcfg, params, _torch(batch))
    assert logit.shape == (len(batch["target"]),)
    np.testing.assert_allclose(logit.numpy(), np.asarray(r_logit), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-5)


def test_serve_step_matches_reference(model):
    cfg, pcfg, r_params, params, batch = model
    want = jax.jit(RS.make_recsys_serve_step(cfg))(r_params, _jnp(batch))
    launches.reset()
    got = S.make_recsys_serve_step(pcfg)(params, _torch(batch))
    assert launches.count == 0                 # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _check_top_k(values, indices, r_values, r_indices, scores):
    """Values within 1e-5; index sets equal except among scores that tie
    (within 1e-5) with the k-th."""
    np.testing.assert_allclose(values, r_values, rtol=0, atol=1e-5)
    kth = r_values[-1]
    sure = {int(i) for i in np.flatnonzero(scores > kth + 1e-5)}
    assert sure <= set(indices.tolist()) and sure <= set(r_indices.tolist())
    for idx in (indices, r_indices):
        assert (scores[idx] >= kth - 1e-5).all()


def test_retrieval_step_matches_reference(model):
    cfg, pcfg, r_params, params, batch = model
    rng = np.random.default_rng(5)
    rb = {"hist": batch["hist"][:1], "hist_mask": batch["hist_mask"][:1],
          "candidates": rng.permutation(cfg.n_items)[:400].astype(np.int32)}
    r_values, r_indices = jax.jit(RS.make_recsys_retrieval_step(
        cfg, top_k=TOP_K))(r_params, _jnp(rb))
    values, indices = S.make_recsys_retrieval_step(pcfg, top_k=TOP_K)(
        params, _torch(rb))
    assert values.shape == indices.shape == (TOP_K,)
    assert (values[:-1] >= values[1:]).all()           # sorted
    scores = np.asarray(jax.jit(lambda p, b: RR.dien_retrieval_score(
        cfg, p, b))(r_params, _jnp(rb)))
    _check_top_k(values.numpy(), indices.numpy(), np.asarray(r_values),
                 np.asarray(r_indices), scores)


@pytest.mark.parametrize("seed", [0, 7])
def test_interaction_stream_matches_reference(seed):
    a = RStream(1000, 16, 12, seed=seed)
    b = InteractionStream(1000, 16, 12, seed=seed)
    np.testing.assert_array_equal(a.item_cluster, b.item_cluster)
    for _ in range(3):
        ra, rb = a.next_batch(), b.next_batch()
        assert set(ra) == set(rb)
        for k in ra:
            assert ra[k].dtype == rb[k].dtype
            np.testing.assert_array_equal(ra[k], rb[k])


def test_configs_match_reference():
    spec = r_get_arch("dien")
    port = get_arch("dien")
    assert port.family == spec.family == "recsys"
    for make in ("make_config", "make_smoke_config"):
        assert (dataclasses.asdict(getattr(port, make)())
                == dataclasses.asdict(getattr(spec, make)()))
    assert RECSYS_SHAPES == R_RECSYS_SHAPES


def _report(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_serve_main_matches_reference(monkeypatch):
    """The port's CLI with the reference's weights (seed 0, the seed the
    reference's ``main`` serves) reports the reference's keys and its
    mean CTR; both are rounded to 6 decimals, so they may differ by one
    unit of the last place."""
    cfg, _ = _configs("smoke")
    tree = jax.tree.map(np.asarray, RR.dien_init(cfg, jax.random.key(0)))
    monkeypatch.setattr(serve.R, "dien_init", lambda cfg, gen:
                        R.params_from_reference(tree, gen.device))
    argv = ["--arch", "dien", "--requests", "32", "--json"]
    want = _report(r_serve.main, argv)
    got = _report(serve.main, argv + ["--device", "cpu", "--seed", "0"])
    assert set(got) == set(want)
    assert {k: got[k] for k in ("arch", "mode", "requests")} == {
        k: want[k] for k in ("arch", "mode", "requests")}
    assert abs(got["mean_ctr"] - want["mean_ctr"]) <= 1e-6 + 1e-12


def test_serve_main_full_width_on_cpu(monkeypatch):
    """``--full`` serves the published widths (the table cut to 10,000
    rows here to keep the test small)."""
    real = R.DIENConfig
    seen = []

    def small_table(**kw):
        cfg = real(**{**kw, "n_items": min(kw["n_items"], 10_000)})
        seen.append(cfg)
        return cfg

    monkeypatch.setattr("repro_torch.configs.dien.DIENConfig", small_table)
    report = _report(serve.main, ["--arch", "dien", "--full", "--requests",
                                  "8", "--device", "cpu", "--json"])
    assert seen[-1].gru_dim == 108 and seen[-1].seq_len == 100
    assert report["requests"] == 8 and 0.0 < report["mean_ctr"] < 1.0


@pytest.mark.parametrize("argv", [["--arch", "qwen2-moe-a2.7b"],
                                  ["--arch", "egnn"],
                                  ["--gnn-artifact", "parts/"]])
def test_unported_serving_raises(argv, tmp_path):
    """The serving CLI beyond DIEN and the dense LMs: an MoE LM serves
    (it raised before its port) and prints the reference's report; a GNN
    ``--arch`` without an artifact raises ``ValueError``;
    ``--gnn-artifact`` serves (here a small artifact in place of
    ``parts/``) and prints the reference's report."""
    if argv[0] == "--gnn-artifact":
        from repro_torch.core import (InMemoryEdgeStream, PartitionArtifact,
                                      run_spec, spec_for)
        from repro_torch.sample import build_local_graphs
        edges = np.random.default_rng(0).integers(0, 60, (300, 2))
        res = run_spec(spec_for("2psl", chunk_size=128),
                       InMemoryEdgeStream(edges, num_vertices=60), 2,
                       device="cpu")
        art = PartitionArtifact.save(str(tmp_path / "parts"), res,
                                     num_vertices=60, num_edges=300,
                                     edges=edges)
        build_local_graphs(art, edges=edges)
        report = _report(serve.main, ["--gnn-artifact", art.path,
                                      "--requests", "3", "--device", "cpu",
                                      "--json"])
        assert report["mode"] == "gnn" and report["requests"] == 3
        assert report["fetch_failures"] == 0
        return
    if argv[1] == "qwen2-moe-a2.7b":
        report = _report(serve.main, argv + ["--requests", "2", "--max-new",
                                             "3", "--device", "cpu",
                                             "--json"])
        assert report["arch"] == argv[1] and report["mode"] == "lm"
        assert report["generated_tokens"] == 6
        return
    with pytest.raises(ValueError, match="needs --gnn-artifact"):
        serve.main(argv + ["--device", "cpu"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "olmoe-1b-7b", "egnn",
                                  "nequip", "gin-tu", "gatedgcn"])
def test_unported_arch_raises(arch):
    """The MoE LMs (which raised before their port) and the GNNs resolve
    to the reference's configs, dataclass for dataclass (the LM configs
    but the reference's ``unroll_layers``)."""
    spec, ref = get_arch(arch), r_get_arch(arch)
    family = "lm" if arch in ("qwen2-moe-a2.7b", "olmoe-1b-7b") else "gnn"
    assert spec.family == ref.family == family
    for make in ("make_config", "make_smoke_config"):
        want = dataclasses.asdict(getattr(ref, make)())
        if family == "lm":
            del want["unroll_layers"]
        assert dataclasses.asdict(getattr(spec, make)()) == want


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this case checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "dien", "--requests", "2"])


@pytest.mark.gpu
def test_serve_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg, pcfg = _configs("full_10k")
    params = R.dien_init(pcfg, torch.Generator().manual_seed(1))
    batch = RStream(cfg.n_items, 64, cfg.seq_len, seed=4).next_batch()
    step = S.make_recsys_serve_step(pcfg)
    cpu = step(params, _torch(batch))
    launches.reset()
    card = step(R.params_to(params, "cuda"),
                {k: v.cuda() for k, v in _torch(batch).items()})
    torch.cuda.synchronize()
    assert launches.count == 2
    assert float((card.cpu() - cpu).abs().max()) <= 1e-5
