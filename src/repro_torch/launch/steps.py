"""Step factories of the port, the counterparts of ``repro.launch.steps``:
the train steps of the three families (LM, GNN, recsys), LM prefill and
decode, recsys (DIEN) serving and retrieval, and the state helpers of the
train launcher.  The reference jits these; the port runs them eagerly, the
serving steps without autograd, the train steps through ``torch.autograd``
(each kernel's backward on the card)."""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..dist import sharding as SH
from ..kernels.spmm.ops import tensor_mark, unchanged
from ..models import gnn as G
from ..models import recsys as R
from ..models import transformer as T
from ..optim import adamw_init
from ..optim.schedules import linear_warmup_cosine
from ..training import make_train_step


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def lm_loss_fn(cfg):
    return functools.partial(T.lm_loss, cfg)


def make_lm_train_step(cfg, *, lr=3e-4, microbatches: int = 1):
    lr_fn = linear_warmup_cosine(lr, 100, 10_000)
    return make_train_step(lm_loss_fn(cfg), lr_fn, microbatches=microbatches)


def make_lm_prefill_step(cfg):
    """``prefill(params, {"tokens": (B, S)}) -> (B, vocab)``: the forward's
    last-position logits (the next-token distribution)."""
    @torch.no_grad()
    def prefill(params, batch):
        logits, _ = T.forward(cfg, params, batch["tokens"])
        return logits[:, -1, :]
    return prefill


def make_lm_decode_step(cfg):
    """``decode(params, {"cache", "tokens" (B, 1), "pos"}) -> (logits
    (B, vocab), cache)``; the cache is updated in place.  On a mesh the
    parameters, cache and tokens are DTensors (``lm_param_specs``,
    ``lm_cache_specs``, ``lm_batch_specs``; ``pos`` a Python int) and so
    are the logits."""
    @torch.no_grad()
    def decode(params, batch):
        return T.decode_step(cfg, params, batch["cache"], batch["tokens"],
                             batch["pos"])
    return decode


def make_recsys_serve_step(cfg):
    """``serve(params, batch) -> CTR (B,)``: the sigmoid of the logit
    (without the auxiliary loss, which serving does not use).  On a mesh
    (DTensor parameters and batch) each rank serves its rows, and the CTR
    is a DTensor laid out as the batch's rows."""
    @torch.no_grad()
    def serve(params, batch):
        logit, _ = R.dien_forward(cfg, params, batch, aux=False)
        target = batch["target"]
        if SH.is_dtensor(target):
            return SH.from_local(torch.sigmoid(logit), target.device_mesh,
                                 target.placements)
        return torch.sigmoid(logit)
    return serve


def ordered_top_k(scores, k: int):
    """``jax.lax.top_k(scores, k)``: the k largest, high to low, equal
    scores in index order (``torch.topk`` promises no order among
    them)."""
    values, indices = torch.sort(scores, descending=True, stable=True)
    return values[:k], indices[:k]


def make_recsys_retrieval_step(cfg, top_k: int = 100):
    """``retrieve(params, batch) -> (values, indices)``: the ``top_k``
    highest candidate scores, sorted high to low (equal scores in
    candidate order, as the reference's ``lax.top_k``), and their
    positions.  On a mesh with the candidates split over ranks, each rank
    scores its own and takes its top ``top_k``; the ranks' lists, in rank
    order, merge into the one-device result, the same on every rank."""
    @torch.no_grad()
    def retrieve(params, batch):
        scores = R.dien_retrieval_score(cfg, params, batch)
        values, indices = ordered_top_k(scores, top_k)
        cand = batch["candidates"]
        dims = SH.split_dims(cand)
        if not dims:
            return values, indices
        mesh = cand.device_mesh
        indices = indices + SH.shard_index(mesh, dims) * scores.shape[0]
        values = SH.gather_rows(values, mesh, dims)
        indices = SH.gather_rows(indices, mesh, dims)
        order = torch.sort(values, descending=True,
                           stable=True).indices[:top_k]
        return values[order], indices[order]
    return retrieve


def gnn_loss_fn(spec_family_cfg, kind: str, n_graphs: int = 1):
    """Builds ``loss(params, batch, prep=None)`` for any of the four GNN
    archs, the reference's loss; ``prep`` is the batch's ``GraphPrep``
    (made from the batch when None).  On a mesh (DTensor parameters and
    batch) each rank's node rows add their terms and the sums run over
    every rank's (``models.gnn.MeshRows``): the loss is the same plain
    scalar on every rank."""
    cfg = spec_family_cfg
    is_nequip = cfg.__class__.__name__ == "NequIPConfig"

    def loss(params, batch, prep=None):
        total = (G.mesh_rows(batch) if prep is None else prep.rows).node_total
        rows = {k: SH.local_value(v) for k, v in batch.items()}
        m = rows["node_mask"]
        if "loss_mask" in rows:
            m = m * rows["loss_mask"]
        if is_nequip:
            out = G.nequip_apply(cfg, params, batch, n_graphs=n_graphs,
                                 prep=prep)
            if kind == "molecule":
                return torch.mean(torch.square(
                    out["energy"] - SH.replicated_value(
                        batch["energy_target"])))
            # non-molecular cells: per-node energy regression on the labels
            tgt = rows["labels"].float()
            err = torch.square(out["atom_energy"] - tgt) * m
            return total(err.sum()) / torch.clamp_min(total(m.sum()), 1.0)

        _, _, apply = G.GNN_MODELS[_gnn_kind(cfg)]
        out = apply(cfg, params, batch, n_graphs=n_graphs, prep=prep)
        logp = torch.log_softmax(out["node_logits"].float(), dim=-1)
        ll = G.label_log_prob(logp, rows["labels"])
        return -total((ll * m).sum()) / torch.clamp_min(total(m.sum()), 1.0)

    return loss


def _gnn_kind(cfg):
    return {"GINConfig": "gin", "GatedGCNConfig": "gatedgcn",
            "EGNNConfig": "egnn", "NequIPConfig": "nequip"}[
                cfg.__class__.__name__]


def gnn_init(cfg, generator: torch.Generator) -> dict:
    _, init, _ = G.GNN_MODELS[_gnn_kind(cfg)]
    return init(cfg, generator)


class PrepCache:
    """The ``GraphPrep`` of the last batch a GNN train step saw, made once
    and reused while the batch is the same (the very ``edges``,
    ``edge_mask``, ``node_mask`` and ``graph_ids`` tensors, unchanged
    since: ``spmm``'s rule for bound edges): a batch's host preparation
    (``prepare_tiles``, seconds at ogb_products' scale) runs once per
    graph, not once per step.  For GIN it carries the reverse of the bound
    edges (``spmm``'s backward).  ``prepare_s`` holds the host seconds of
    each preparation made.  On a mesh the marks are taken of each DTensor
    leaf's local rows, and the prep is this rank's (``graph_prep``)."""

    KEYS = ("edges", "edge_mask", "node_mask", "graph_ids")

    def __init__(self, n_graphs: int, reverse: bool):
        self.n_graphs, self.reverse = n_graphs, reverse
        self._marks, self._prep = None, None
        self.prepare_s: list[float] = []

    def get(self, batch) -> G.GraphPrep:
        local = [SH.local_value(batch[k]) for k in self.KEYS]
        if self._marks is not None and all(
                unchanged(t, m) for t, m in zip(local, self._marks)):
            return self._prep
        marks = tuple(tensor_mark(t) for t in local)
        t0 = time.perf_counter()
        self._prep = G.graph_prep(batch, self.n_graphs, reverse=self.reverse)
        self.prepare_s.append(time.perf_counter() - t0)
        self._marks = marks
        return self._prep


def make_gnn_train_step(cfg, kind: str, *, n_graphs: int = 1, lr=1e-3,
                        prep: G.GraphPrep | None = None):
    """The reference's GNN train step (AdamW, no weight decay) on
    ``gnn_loss_fn``, each batch prepared once (``PrepCache``, as
    ``step.prep_cache``).  A ``prep`` given here is used for every batch
    instead (the caller's promise that it is theirs: the dry run's
    shape-only ``graph_prep(..., abstract=True)``); ``step.prep_cache`` is
    then None."""
    lr_fn = linear_warmup_cosine(lr, 20, 2_000)
    loss = gnn_loss_fn(cfg, kind, n_graphs)
    cache = None
    if prep is None:
        cache = PrepCache(n_graphs, reverse=_gnn_kind(cfg) == "gin")
    step = make_train_step(
        lambda params, batch: loss(
            params, batch, prep=prep if cache is None else cache.get(batch)),
        lr_fn, weight_decay=0.0)
    step.prep_cache = cache
    return step


# ---------------------------------------------------------------------------
# recsys (DIEN)
# ---------------------------------------------------------------------------

def make_recsys_train_step(cfg, *, lr=1e-3):
    lr_fn = linear_warmup_cosine(lr, 50, 5_000)
    return make_train_step(functools.partial(R.dien_loss, cfg), lr_fn,
                           weight_decay=0.0)


# ---------------------------------------------------------------------------
# the train launcher's state: initial, from the reference, to numpy
# ---------------------------------------------------------------------------

_FROM_REFERENCE = {"lm": T.params_from_reference,
                   "gnn": G.params_from_reference,
                   "recsys": R.params_from_reference}


def init_params(family: str, cfg, generator: torch.Generator):
    """Random parameters of ``family``'s model on the generator's device."""
    if family == "lm":
        return T.init_params(cfg, generator)
    if family == "gnn":
        return gnn_init(cfg, generator)
    return R.dien_init(cfg, generator)


def init_state(family: str, cfg, generator: torch.Generator) -> dict:
    """``{"params", "opt"}`` of a fresh train state (the concrete twin of
    the reference's ``init_state_abstract`` train branch)."""
    params = init_params(family, cfg, generator)
    return {"params": params, "opt": adamw_init(params)}


#: the shape kinds whose abstract state carries the optimizer's (the
#: reference's ``init_state_abstract``)
TRAIN_KINDS = ("train", "full", "sampled", "molecule", "train_batch")


def init_state_abstract(family: str, cfg, kind: str):
    """Shape-only train or serve state (meta tensors, nothing allocated),
    the counterpart of the reference's ``init_state_abstract``: ``{"params",
    "opt"}`` for a train kind, the parameters alone otherwise."""
    from ..models.layers import abstract_tree
    if family == "lm":
        params = T.init_params_abstract(cfg)
    else:
        params = abstract_tree(init_params, family, cfg, torch.Generator())
    if kind in TRAIN_KINDS:
        return {"params": params, "opt": adamw_init(params)}
    return params


def state_from_reference(family: str, tree, device="cpu") -> dict:
    """The reference's train state as a tree of numpy arrays
    (``jax.tree.map(np.asarray, state)``) as the port's tensors on
    ``device``: parameters, moments and step, bit for bit."""
    convert = _FROM_REFERENCE[family]
    opt = tree["opt"]
    return {"params": convert(tree["params"], device),
            "opt": {"m": convert(opt["m"], device),
                    "v": convert(opt["v"], device),
                    "step": torch.tensor(np.asarray(opt["step"]),
                                         dtype=torch.int32, device=device)}}


def _to_numpy(t):
    if isinstance(t, dict):
        return {k: _to_numpy(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_to_numpy(v) for v in t]
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # the reference's bf16 numpy dtype (CPU tests)
        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def state_to_numpy(state) -> dict:
    """A train state (or any tree of tensors) as a tree of numpy arrays
    with the reference's dtypes (bf16 as ``ml_dtypes.bfloat16``), copied:
    the port updates its tensors in place."""
    return _to_numpy(state)
