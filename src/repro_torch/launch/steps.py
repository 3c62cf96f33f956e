"""Step factories of the port, the counterparts of ``repro.launch.steps``:
LM prefill and decode, recsys (DIEN) serving and retrieval.  The reference
jits these; the port runs them eagerly, without autograd."""
from __future__ import annotations

import torch

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
