"""Step factories of the port, the counterparts of ``repro.launch.steps``:
LM prefill and decode, recsys (DIEN) serving and retrieval, and the GNN
losses (forward only).  The reference jits these; the port runs them
eagerly, without autograd."""
from __future__ import annotations

import torch

from ..models import gnn as G
from ..models import recsys as R
from ..models import transformer as T


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
    (B, vocab), cache)``; the cache is updated in place."""
    @torch.no_grad()
    def decode(params, batch):
        return T.decode_step(cfg, params, batch["cache"], batch["tokens"],
                             batch["pos"])
    return decode


def make_recsys_serve_step(cfg):
    """``serve(params, batch) -> CTR (B,)``: the sigmoid of the logit
    (without the auxiliary loss, which serving does not use)."""
    @torch.no_grad()
    def serve(params, batch):
        logit, _ = R.dien_forward(cfg, params, batch, aux=False)
        return torch.sigmoid(logit)
    return serve


def make_recsys_retrieval_step(cfg, top_k: int = 100):
    """``retrieve(params, batch) -> (values, indices)``: the ``top_k``
    highest candidate scores, sorted high to low, and their positions."""
    @torch.no_grad()
    def retrieve(params, batch):
        scores = R.dien_retrieval_score(cfg, params, batch)
        values, indices = torch.topk(scores, top_k, sorted=True)
        return values, indices
    return retrieve


def gnn_loss_fn(spec_family_cfg, kind: str, n_graphs: int = 1):
    """Builds ``loss(params, batch)`` for any of the four GNN archs: the
    reference's loss, forward only (``make_gnn_train_step`` is not ported
    yet)."""
    cfg = spec_family_cfg
    is_nequip = cfg.__class__.__name__ == "NequIPConfig"

    @torch.no_grad()
    def loss(params, batch):
        m = batch["node_mask"]
        if "loss_mask" in batch:
            m = m * batch["loss_mask"]
        if is_nequip:
            out = G.nequip_apply(cfg, params, batch, n_graphs=n_graphs)
            if kind == "molecule":
                return torch.mean(torch.square(
                    out["energy"] - batch["energy_target"]))
            # non-molecular cells: per-node energy regression on the labels
            tgt = batch["labels"].float()
            err = torch.square(out["atom_energy"] - tgt) * m
            return err.sum() / torch.clamp_min(m.sum(), 1.0)

        _, _, apply = G.GNN_MODELS[_gnn_kind(cfg)]
        out = apply(cfg, params, batch, n_graphs=n_graphs)
        logp = torch.log_softmax(out["node_logits"].float(), dim=-1)
        ll = torch.gather(logp, -1, batch["labels"].long()[:, None])[:, 0]
        return -(ll * m).sum() / torch.clamp_min(m.sum(), 1.0)

    return loss


def _gnn_kind(cfg):
    return {"GINConfig": "gin", "GatedGCNConfig": "gatedgcn",
            "EGNNConfig": "egnn", "NequIPConfig": "nequip"}[
                cfg.__class__.__name__]


def gnn_init(cfg, generator: torch.Generator) -> dict:
    _, init, _ = G.GNN_MODELS[_gnn_kind(cfg)]
    return init(cfg, generator)


def make_gnn_train_step(cfg, kind: str, *, n_graphs: int = 1, lr=1e-3):
    """Not ported yet: a GNN train step needs the optimizer and training
    loop of ROADMAP.md Queue 1 item 12, and a backward of the ``spmm``
    segment sums."""
    raise NotImplementedError(
        "GNN training (make_gnn_train_step) is not ported to repro_torch "
        "yet: see ROADMAP.md Queue 1 item 12 (optim/ and training/)")
