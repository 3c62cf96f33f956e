"""The port's train steps against the reference's, on the CPU.

``make_train_step`` on a toy loss (``microbatches`` 1 and 2) against the
reference's, then each family's train step at its smoke size (the three
dense LMs, the four GNNs, DIEN) from the same state: the reference's
weights carried over with ``launch.steps.state_from_reference`` and the
same numpy batch.  Tolerances:

* the loss within 1e-5 of the reference's, relative;
* every gradient leaf within 1e-4 of its largest magnitude against
  ``jax.grad`` of the reference's loss (float32 products, sums and
  transcendentals round differently in the two frameworks), that
  magnitude floored at 1e-2 of the tree's largest gradient (a leaf whose
  gradient vanishes analytically, a bias just before a batch norm, holds
  float32 noise alone);
* the 3-step update ``p3 - p0`` elementwise against the reference's:
  within 1e-2 of the reference's update wherever the reference's first
  gradient is at least 1e-2 of its leaf's scale above (100 times the
  gradients' tolerance: there their agreement fixes the sign and size of
  AdamW's normalised step; a bias just before a batch norm is all noise),
  within ``4 * sum_t lr_t`` elsewhere (AdamW moves an element by about
  one learning rate a step, and an element whose gradient is near zero
  may take either sign), both plus 3 units in the last place of ``p``
  (one float32 rounding of ``p - lr * delta`` a step on each side); a
  no-op step, a sign-flipped step and the wrong weight decay each fail
  that check (``test_three_step_check_catches_a_wrong_update``), and at
  least one element in 20 is held to the relative bound;
* the first moments after 3 steps as the gradients, the second within
  1e-3 (squares of gradients that agree to 1e-4);
* ``remat`` none, full and dots give the same gradients within 1e-6 of
  their largest magnitude (the same arithmetic, recomputed).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.steps as RS
import repro.models.gnn as RG
import repro.models.recsys as RR
import repro.models.transformer as RT
from repro.configs import get_arch as r_get_arch
from repro.data.gnn_batches import full_graph_batch, molecule_batch
from repro.data.lm_data import TokenStream
from repro.data.recsys_data import InteractionStream
from repro.optim import adamw_init as r_adamw_init
from repro.optim.schedules import constant_lr as r_constant_lr
from repro.training import make_train_step as r_make_train_step
from repro_torch.launch import steps as S
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim import constant_lr
from repro_torch.optim.schedules import linear_warmup_cosine
from repro_torch.optim.adamw import tree_leaves
from repro_torch.training import make_train_step

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _leaves_close(got, want, tol, what=""):
    """Each leaf within ``tol`` of its largest magnitude, floored at 1e-2
    of the tree's largest: a leaf whose gradient vanishes analytically (a
    bias just before a batch norm) holds float32 noise alone."""
    g_leaves = tree_leaves(got)
    w_leaves = [np.asarray(w, np.float32) for w in jax.tree.leaves(want)]
    assert len(g_leaves) == len(w_leaves), what
    top = max(float(np.abs(w).max()) if w.size else 0.0 for w in w_leaves)
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, f"{what} leaf {i}"
        scale = max(float(np.abs(w).max()), 1e-2 * top, 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what} leaf {i}: {err} > {tol} * {scale}"


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in batch.items() if v is not None}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items() if v is not None}


# ---------------------------------------------------------------------------
# the step builder on a toy loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 2])
def test_make_train_step_matches_reference(microbatches):
    rng = np.random.default_rng(microbatches)
    w0 = rng.standard_normal((3, 2)).astype(np.float32)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    y = rng.standard_normal((4, 2)).astype(np.float32)

    def r_loss(p, b):
        return jnp.mean(jnp.square(b["x"] @ p["w"] - b["y"]))

    def loss(p, b):
        return torch.mean(torch.square(b["x"] @ p["w"] - b["y"]))

    r_step = r_make_train_step(r_loss, r_constant_lr(0.01),
                               microbatches=microbatches)
    step = make_train_step(loss, constant_lr(0.01),
                           microbatches=microbatches)
    r_params = {"w": jnp.asarray(w0)}
    r_state = {"params": r_params, "opt": r_adamw_init(r_params)}
    state = {"params": {"w": torch.tensor(w0)},
             "opt": {"m": {"w": torch.zeros(3, 2)},
                     "v": {"w": torch.zeros(3, 2)},
                     "step": torch.zeros((), dtype=torch.int32)}}
    for _ in range(3):
        r_state, r_m = r_step(r_state, {"x": jnp.asarray(x),
                                        "y": jnp.asarray(y)})
        state, m = step(state, {"x": torch.tensor(x), "y": torch.tensor(y)})
        for k in ("loss", "lr", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(r_m[k]),
                                       rtol=1e-6)
    np.testing.assert_allclose(state["params"]["w"].numpy(),
                               np.asarray(r_state["params"]["w"]),
                               rtol=1e-6, atol=1e-7)
    assert int(state["opt"]["step"]) == 3


# ---------------------------------------------------------------------------
# each family's train step at its smoke size
# ---------------------------------------------------------------------------

LM = ["starcoder2-3b", "minitron-8b", "qwen1.5-110b"]
GNN = ["gin-tu", "gatedgcn", "egnn", "nequip"]


def _lm_case(arch):
    cfg = r_get_arch(arch).make_smoke_config()
    fields = dataclasses.asdict(cfg)
    del fields["unroll_layers"]
    pcfg = T.TransformerConfig(**fields)
    params = RT.init_params(cfg, jax.random.key(0))
    batch = TokenStream(cfg.vocab, 4, 16, seed=1).next_batch()
    return ("lm", lambda p, b: RT.lm_loss(cfg, p, b),
            lambda p, b: T.lm_loss(pcfg, p, b), params, batch,
            RS.make_lm_train_step(cfg), S.make_lm_train_step(pcfg))


def _gnn_case(arch):
    spec = r_get_arch(arch)
    cfg = spec.make_smoke_config()
    kind_name = cfg.__class__.__name__
    pcfg = getattr(G, kind_name)(**dataclasses.asdict(cfg))
    params = RS.gnn_init(cfg, jax.random.key(0))
    if kind_name == "NequIPConfig":
        batch, n_graphs = molecule_batch(4, n_nodes=10, n_edges=24,
                                         n_species=cfg.n_species, seed=2)
        kind = "molecule"
    else:
        batch = full_graph_batch(64, 256, cfg.d_in, n_classes=cfg.n_classes,
                                 seed=2, with_coords=True)
        n_graphs, kind = 1, "full"
    r_loss = RS.gnn_loss_fn(cfg, kind, n_graphs)
    loss = S.gnn_loss_fn(pcfg, kind, n_graphs)
    return ("gnn", r_loss, loss, params, batch,
            RS.make_gnn_train_step(cfg, kind, n_graphs=n_graphs),
            S.make_gnn_train_step(pcfg, kind, n_graphs=n_graphs))


def _dien_case(_):
    cfg = r_get_arch("dien").make_smoke_config()
    pcfg = R.DIENConfig(**dataclasses.asdict(cfg))
    params = RR.dien_init(cfg, jax.random.key(0))
    batch = InteractionStream(cfg.n_items, 8, cfg.seq_len,
                              seed=3).next_batch()
    return ("recsys", lambda p, b: RR.dien_loss(cfg, p, b),
            lambda p, b: R.dien_loss(pcfg, p, b), params, batch,
            RS.make_recsys_train_step(cfg), S.make_recsys_train_step(pcfg))


CASES = ([("lm", a) for a in LM] + [("gnn", a) for a in GNN]
         + [("recsys", "dien")])
BUILD = {"lm": _lm_case, "gnn": _gnn_case, "recsys": _dien_case}


@pytest.mark.parametrize("family,arch", CASES)
def test_loss_and_gradients_match_reference(family, arch):
    fam, r_loss, loss, r_params, batch, _, _ = BUILD[family](arch)
    r_val, r_grads = jax.jit(jax.value_and_grad(r_loss))(r_params,
                                                         _jnp(batch))
    params = S.state_from_reference(fam, {
        "params": jax.tree.map(np.asarray, r_params),
        "opt": {"m": jax.tree.map(np.asarray, r_params),
                "v": jax.tree.map(np.asarray, r_params),
                "step": np.int32(0)}})["params"]
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    val = loss(params, _torch(batch))
    grads = torch.autograd.grad(val, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    np.testing.assert_allclose(float(val), float(r_val), rtol=LOSS_RTOL)
    _leaves_close(grads, r_grads, GRAD_TOL, f"{arch} gradients")


#: each family's schedule (peak, warm-up, total steps) and weight decay,
#: as its train step builds them
SCHEDULE = {"lm": (3e-4, 100, 10_000, 0.1), "gnn": (1e-3, 20, 2_000, 0.0),
            "recsys": (1e-3, 50, 5_000, 0.0)}
#: adamw_update's first-moment decay (m after one step from zero is
#: (1 - B1) g)
B1 = 0.9
#: the relative bound, the gradient share that earns it, and the least
#: share of elements it must hold (the check is not vacuous)
UPDATE_RTOL, LIVE_SHARE, MIN_LIVE = 1e-2, 1e-2, 0.05


@functools.lru_cache(maxsize=None)
def _reference_three_steps(family, arch):
    """The reference's 3 steps from its initial state, with what the port's
    runs are held to: the numpy start, the end state, the first step's
    gradient (from its first moment), losses and rates."""
    fam, _, loss, r_params, batch, r_step, step = BUILD[family](arch)
    r_state = {"params": r_params, "opt": r_adamw_init(r_params)}
    start = jax.tree.map(np.asarray, r_state)
    r_step, jb = jax.jit(r_step), _jnp(batch)
    losses, lrs = [], []
    for i in range(3):
        r_state, r_m = r_step(r_state, jb)
        if i == 0:
            grad0 = [np.asarray(m, np.float64) / (1 - B1)
                     for m in jax.tree.leaves(r_state["opt"]["m"])]
        losses.append(float(r_m["loss"]))
        lrs.append(float(r_m["lr"]))
    return {"fam": fam, "loss": loss, "batch": batch, "step": step,
            "start": start, "end": jax.tree.map(np.asarray, r_state),
            "grad0": grad0, "losses": losses, "lrs": lrs}


def _port_three_steps(ref, step):
    state = S.state_from_reference(ref["fam"],
                                   jax.tree.map(np.copy, ref["start"]))
    tb, metrics = _torch(ref["batch"]), []
    for _ in range(3):
        state, m = step(state, tb)
        metrics.append((float(m["loss"]), float(m["lr"])))
    return state, metrics


def _update_excess(ref, params):
    """(the largest ratio, over every element, of the port's 3-step update's
    distance from the reference's to its bound (the module docstring; at
    most 1 passes), the share of elements held to the relative bound)."""
    lr_sum = sum(ref["lrs"])
    tree_top = max(float(np.abs(g).max()) for g in ref["grad0"] if g.size)
    worst, live_n, total = 0.0, 0, 0
    for p0, got, want, g0 in zip(jax.tree.leaves(ref["start"]["params"]),
                                 tree_leaves(params),
                                 jax.tree.leaves(ref["end"]["params"]),
                                 ref["grad0"]):
        p0, want = np.asarray(p0, np.float64), np.asarray(want, np.float64)
        d_ref = want - p0
        d = got.detach().double().numpy() - p0
        ulps = 3 * np.spacing(np.maximum(np.abs(p0), np.abs(want))
                              .astype(np.float32)).astype(np.float64)
        # the gradients' tolerance scale (_leaves_close)
        scale = max(float(np.abs(g0).max()) if g0.size else 0.0,
                    1e-2 * tree_top)
        live = np.abs(g0) >= LIVE_SHARE * scale
        bound = np.where(live, UPDATE_RTOL * np.abs(d_ref), 4 * lr_sum) + ulps
        if d.size:
            worst = max(worst, float((np.abs(d - d_ref) / bound).max()))
        live_n, total = live_n + int(live.sum()), total + d.size
    return worst, live_n / total


@pytest.mark.parametrize("family,arch", CASES)
def test_three_steps_match_reference(family, arch):
    ref = _reference_three_steps(family, arch)
    state, metrics = _port_three_steps(ref, ref["step"])
    for (loss, lr), r_loss, r_lr in zip(metrics, ref["losses"], ref["lrs"]):
        np.testing.assert_allclose(loss, r_loss, rtol=LOSS_RTOL)
        np.testing.assert_allclose(lr, r_lr, rtol=1e-6)
    excess, live = _update_excess(ref, state["params"])
    assert excess <= 1, f"{arch}: 3-step update {excess} of its bound"
    assert live >= MIN_LIVE, f"{arch}: {live} of elements held"
    assert int(state["opt"]["step"]) == int(ref["end"]["opt"]["step"]) == 3
    _leaves_close(state["opt"]["m"], ref["end"]["opt"]["m"], GRAD_TOL,
                  f"{arch} first moments")
    _leaves_close(state["opt"]["v"], ref["end"]["opt"]["v"], 1e-3,
                  f"{arch} second moments")


#: a step that leaves the parameters unchanged, one that moves them the
#: other way, and one with the other family's weight decay: (learning-rate
#: factor, weight decay swapped)
MUTANTS = {"no-op": (0.0, False), "sign-flipped": (-1.0, False),
           "wrong weight decay": (1.0, True)}


@pytest.mark.parametrize("mutant", list(MUTANTS))
@pytest.mark.parametrize("family,arch", [("lm", "starcoder2-3b"),
                                         ("gnn", "gin-tu"),
                                         ("recsys", "dien")])
def test_three_step_check_catches_a_wrong_update(family, arch, mutant):
    ref = _reference_three_steps(family, arch)
    peak, warm, total, wd = SCHEDULE[family]
    factor, swap = MUTANTS[mutant]
    lr_fn = linear_warmup_cosine(peak, warm, total)
    step = make_train_step(ref["loss"], lambda s: factor * lr_fn(s),
                           weight_decay=(0.1 - wd) if swap else wd)
    state, _ = _port_three_steps(ref, step)
    excess, _ = _update_excess(ref, state["params"])
    assert excess > 1, f"{arch} {mutant}: {excess} of the bound passes"


@pytest.mark.parametrize("arch", LM)
def test_remat_policies_give_the_same_gradients(arch):
    cfg = r_get_arch(arch).make_smoke_config()
    fields = dataclasses.asdict(cfg)
    del fields["unroll_layers"]
    params = T.params_from_reference(jax.tree.map(
        np.asarray, RT.init_params(cfg, jax.random.key(1))))
    batch = _torch(TokenStream(cfg.vocab, 2, 12, seed=4).next_batch())
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    out = {}
    for remat in ("none", "full", "dots"):
        pcfg = T.TransformerConfig(**{**fields, "remat": remat})
        out[remat] = torch.autograd.grad(T.lm_loss(pcfg, params, batch),
                                         leaves)
    for remat in ("full", "dots"):
        _leaves_close(out[remat], [g.numpy() for g in out["none"]], 1e-6,
                      f"remat {remat}")


def test_gnn_step_prepares_a_batch_once():
    _, _, _, r_params, batch, _, step = _gnn_case("gin-tu")
    state = S.state_from_reference("gnn", jax.tree.map(
        np.asarray, {"params": r_params, "opt": r_adamw_init(r_params)}))
    tb = _torch(batch)
    for _ in range(3):
        step(state, tb)
    assert len(step.prep_cache.prepare_s) == 1
    assert step.prep_cache.get(tb).edges.reverse is not None
    step(state, _torch(batch))           # other tensors: prepared again
    assert len(step.prep_cache.prepare_s) == 2


def test_state_round_trips_through_numpy():
    _, _, _, r_params, _, _, _ = _lm_case("starcoder2-3b")
    r_state = jax.tree.map(np.asarray, {"params": r_params,
                                        "opt": r_adamw_init(r_params)})
    back = S.state_to_numpy(S.state_from_reference("lm", r_state))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(r_state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8))


def test_init_state_has_the_reference_tree():
    for arch in ("starcoder2-3b", "gin-tu", "dien"):
        spec = r_get_arch(arch)
        cfg = spec.make_smoke_config()
        r_state = RS.init_state_abstract(spec.family, cfg, "train")
        from repro_torch.configs import get_arch
        pspec = get_arch(arch)
        state = S.init_state(pspec.family, pspec.make_smoke_config(),
                             torch.Generator().manual_seed(0))
        got = [tuple(t.shape) for t in tree_leaves(state)]
        want = [tuple(s.shape) for s in jax.tree.leaves(r_state)]
        assert got == want
