"""The port's losses on out-of-range labels, against the reference.

The reference's ``cross_entropy_loss`` picks the label's logit by a one-hot
masked sum, so a label outside [0, V) contributes a logit of 0; its GNN node
losses read ``jnp.take_along_axis``, which wraps a label in [-C, 0) once and
gives NaN outside [-C, C) (NaN also where the node is masked out: NaN * 0).
The port must give the same values without raising, and its in-range
results must stay what a plain ``torch.gather`` gives.  Inputs come from
numpy with a seed and go through both packages.  Tolerance: 1e-6 relative
(the same float32 arithmetic in another summation order).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as RS
import repro.models.gnn as RG
import repro.models.layers as RL
from repro.configs import get_arch as r_get_arch
from repro_torch.launch import steps as S
from repro_torch.models import gnn as G
from repro_torch.models import layers as L

RTOL = 1e-6
V, C = 11, 4

#: label sets: in range, -1, V (one past the end), -V - 1 and far outside
CE_LABELS = {
    "in_range": lambda rng: rng.integers(0, V, (2, 5)),
    "minus_one": lambda rng: np.where(rng.random((2, 5)) < 0.4, -1,
                                      rng.integers(0, V, (2, 5))),
    "past_end": lambda rng: np.where(rng.random((2, 5)) < 0.4, V,
                                     rng.integers(0, V, (2, 5))),
    "mixed": lambda rng: rng.choice([-V - 1, -1, 0, 3, V - 1, V, 40],
                                    (2, 5)),
}


@pytest.mark.parametrize("labels", sorted(CE_LABELS))
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches_reference(labels, z_loss, dtype):
    rng = np.random.default_rng(len(labels) + int(z_loss * 1e4))
    logits = rng.standard_normal((2, 5, V)).astype(np.float32) * 3
    lab = CE_LABELS[labels](rng).astype(np.int32)
    want = RL.cross_entropy_loss(jnp.asarray(logits).astype(dtype),
                                 jnp.asarray(lab), z_loss=z_loss)
    got = L.cross_entropy_loss(torch.from_numpy(logits).to(
        getattr(torch, dtype)), torch.from_numpy(lab), z_loss=z_loss)
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_in_range_is_a_plain_gather(z_loss):
    """In range the label's logit is the gathered one, bit for bit, and
    its gradient reaches the same logits."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((3, 7, V))
                              .astype(np.float32)).requires_grad_()
    lab = torch.from_numpy(rng.integers(0, V, (3, 7)))
    got = L.cross_entropy_loss(logits, lab, z_loss=z_loss)
    (g_got,) = torch.autograd.grad(got, logits)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = (torch.log(torch.sum(torch.exp((logits - m).float()), dim=-1))
           + m[..., 0])
    ll = torch.gather(logits, -1, lab[..., None])[..., 0]
    want = (lse - ll).mean()
    if z_loss:
        want = want + z_loss * torch.square(lse).mean()
    (g_want,) = torch.autograd.grad(want, logits)
    assert torch.equal(got, want)
    assert torch.equal(g_got, g_want)


#: node 0's label, by name, for C classes: in range, wrapped (-1, -C), one
#: past the end (C), below -C
NODE_LABELS = {"in_range": lambda n: 2, "minus_one": lambda n: -1,
               "minus_c": lambda n: -n, "c": lambda n: n,
               "below_minus_c": lambda n: -n - 1}


def _node_case(label: int, mask_bad: bool, seed: int):
    """(logits (N, C), labels, node_mask): ``label`` at node 0, masked out
    when ``mask_bad``, and two padded nodes."""
    rng = np.random.default_rng(seed)
    N = 9
    logits = rng.standard_normal((N, C)).astype(np.float32) * 2
    lab = rng.integers(0, C, N).astype(np.int32)
    lab[0] = label
    mask = np.ones(N, np.float32)
    mask[-2:] = 0.0
    if mask_bad:
        mask[0] = 0.0
    return logits, lab, mask


@pytest.mark.parametrize("label", sorted(NODE_LABELS))
@pytest.mark.parametrize("mask_bad", [False, True])
def test_gnn_node_loss_matches_take_along_axis(label, mask_bad):
    lab0 = NODE_LABELS[label](C)
    logits, lab, mask = _node_case(lab0, mask_bad, seed=len(label))
    want = RG.gnn_node_loss(
        lambda p, b: {"node_logits": jnp.asarray(logits)}, None,
        {"labels": jnp.asarray(lab), "node_mask": jnp.asarray(mask)}, C)
    got = G.gnn_node_loss(
        lambda p, b: {"node_logits": torch.from_numpy(logits)}, None,
        {"labels": torch.from_numpy(lab), "node_mask": torch.from_numpy(mask)},
        C)
    assert np.isnan(float(got)) == (not -C <= lab0 < C)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL,
                               equal_nan=True)


def test_label_log_prob_in_range_is_a_plain_gather():
    rng = np.random.default_rng(5)
    logp = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((13, C)).astype(np.float32)), dim=-1)
    lab = torch.from_numpy(rng.integers(0, C, 13).astype(np.int32))
    assert torch.equal(G.label_log_prob(logp, lab),
                       torch.gather(logp, -1, lab.long()[:, None])[:, 0])


@pytest.fixture(scope="module")
def gin():
    cfg = r_get_arch("gin-tu").make_smoke_config()
    pcfg = G.GINConfig(**dataclasses.asdict(cfg))
    r_params = RG.gin_init(cfg, jax.random.key(2))
    params = G.params_from_reference(jax.tree.map(np.asarray, r_params))
    return cfg, pcfg, r_params, params


@pytest.mark.parametrize("label", sorted(NODE_LABELS))
@pytest.mark.parametrize("mask_bad", [False, True])
def test_steps_gnn_loss_matches_reference(gin, label, mask_bad):
    """``launch.steps.gnn_loss_fn``'s node loss (gin-tu at smoke size) on a
    batch whose node 0 has the label, left out by ``loss_mask`` when
    ``mask_bad``."""
    cfg, pcfg, r_params, params = gin
    rng = np.random.default_rng(11)
    N, E = 24, 60
    lab = rng.integers(0, cfg.n_classes, N).astype(np.int32)
    lab[0] = NODE_LABELS[label](cfg.n_classes)
    loss_mask = np.ones(N, np.float32)
    if mask_bad:
        loss_mask[0] = 0.0
    batch = {
        "nodes": rng.standard_normal((N, cfg.d_in)).astype(np.float32),
        "edges": rng.integers(0, N, (E, 2)).astype(np.int32),
        "node_mask": np.ones(N, np.float32),
        "edge_mask": np.ones(E, np.float32),
        "graph_ids": np.zeros(N, np.int32),
        "labels": lab, "loss_mask": loss_mask,
    }
    want = RS.gnn_loss_fn(cfg, "full", 1)(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = S.gnn_loss_fn(pcfg, "full", 1)(
        params, {k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    assert np.isnan(float(got)) == np.isnan(float(want))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               equal_nan=True)
