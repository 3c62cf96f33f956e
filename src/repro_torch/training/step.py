"""Train-step builder: loss -> gradients -> AdamW, with optional
microbatch gradient accumulation; the counterpart of
``repro.training.step``.

Gradients come from ``torch.autograd`` (the kernels' backward on the
card).  The step updates the state's tensors in place (``adamw_update``)
and returns the same dict with its metrics (``loss``, ``lr``,
``grad_norm``, float32 tensors on the state's device: nothing is read back
to the host).

On a mesh the state's leaves are DTensors (placed by
``dist.sharding.lm_param_specs``/``opt_state_specs``, e.g. through
``runtime.reshard_tree``) and so are the batch's (``lm_batch_specs``):
each gradient comes back from autograd in whatever placements its
products left (a weight sharded on its contraction dim gets a partial
sum) and is redistributed to its parameter's placements before the update;
each microbatch is cut from the whole batch and placed again by the batch
rule."""
from __future__ import annotations

from typing import Callable

import torch

from ..optim.adamw import adamw_update, tree_leaves, tree_map


class TrainState(dict):
    """{'params': tree, 'opt': adamw state}, a plain dict."""

    @staticmethod
    def create(params, opt_state):
        return {"params": params, "opt": opt_state}


class _Pieces(list):
    """A DTensor batch leaf's microbatches."""


def _split(x, microbatches: int):
    from ..dist import sharding as SH
    if SH.is_dtensor(x):
        whole = x.full_tensor()
        n = x.shape[0] // microbatches
        return _Pieces(SH.distribute(whole[i * n:(i + 1) * n], x.device_mesh,
                                     SH.lm_batch_specs(x.device_mesh,
                                                       whole[:n]))
                       for i in range(microbatches))
    if isinstance(x, torch.Tensor):
        return x.reshape((microbatches, x.shape[0] // microbatches)
                         + tuple(x.shape[1:]))
    return x


def _like_param(g, p):
    """A DTensor gradient in its parameter's placements."""
    from ..dist import sharding as SH
    if SH.is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)`` through
    ``torch.autograd``, as ``jax.value_and_grad``: the parameters are
    untouched, and a leaf the loss does not reach gets a zero gradient."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else _like_param(g, p)
               for p, g in zip(live, grads)])
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(loss_fn: Callable, lr_fn: Callable, *,
                    weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                    microbatches: int = 1,
                    reduce_grads: Callable | None = None):
    """loss_fn(params, batch) -> scalar.  Returns step(state, batch) ->
    (state, metrics).  With microbatches > 1, the leading batch axis of
    every tensor in ``batch`` is split, gradients are accumulated in
    float32, then loss and gradients are divided by the count.
    ``reduce_grads(grads) -> grads`` runs before the update (a partitioned
    step's sum of every rank's gradients)."""

    from ..dist import sharding as SH

    def step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            split = {k: _split(v, microbatches) for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
            grads = None
            for i in range(microbatches):
                mb = {k: v[i] if isinstance(v, (torch.Tensor, _Pieces)) else v
                      for k, v in split.items()}
                loss_i, g_i = value_and_grad(loss_fn, params, mb)
                loss = loss + loss_i
                if grads is None:
                    grads = tree_map(lambda g: g.float(), g_i)
                else:
                    tree_map(lambda a, g: a.add_(g.float()), grads, g_i)
                del g_i
            loss = loss / microbatches
            tree_map(lambda g: g.div_(microbatches), grads)
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        # schedule indexed by the step being TAKEN (warmup(0) would be lr=0)
        lr = lr_fn(SH.local_value(state["opt"]["step"]) + 1)
        _, _, om = adamw_update(grads, state["opt"], params, lr=lr,
                                weight_decay=weight_decay,
                                max_grad_norm=max_grad_norm)
        return state, {"loss": loss, "lr": lr, **om}

    return step
