"""Functional AdamW with decoupled weight decay and global-norm clipping,
the counterpart of ``repro.optim.adamw``.

The state layout is the reference's, ``{"m", "v", "step"}`` with the
moments mirroring the parameter tree (checkpoints depend on it), and the
arithmetic is what the reference's jitted update computes: the moments are
float32 whatever the parameter's dtype, the clip scale is cast to the
gradient's dtype before the multiply, ``t`` is float32, and the update is
cast to the parameter's dtype before it is subtracted (a bf16 parameter is
updated in bf16).  ``torch.optim.AdamW`` orders its weight decay
differently and has no global-norm clip, so it is not the counterpart.

Unlike the reference, ``adamw_update`` updates the parameters and the
moments in place (a 3B-parameter model's state is ~36 GB; a second copy
would not fit beside it) and returns the same tensors.

On a mesh the leaves are DTensors, each gradient and moment in its
parameter's placements (``training.step`` redistributes the gradients):
``global_norm`` sums each leaf's squares over its shards, so a replicated
leaf counts once, and the update runs on each rank's local shards, in
place, chunked as on one device.
"""
from __future__ import annotations

import torch


def tree_leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in the reference's
    order (dict keys sorted, as ``jax.tree`` flattens them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure, in
    ``tree_leaves``' order."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def adamw_init(params) -> dict:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": zeros, "v": tree_map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(grads) -> torch.Tensor:
    """sqrt(sum of every gradient's float32 sum of squares), summed leaf
    by leaf in the reference's order; a DTensor leaf's sum is its whole
    value's (a plain tensor on every rank)."""
    from ..dist import sharding as SH
    total = None
    for g in tree_leaves(grads):
        sq = SH.replicated_value(torch.sum(torch.square(g.float())))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)), norm): new
    tensors, the scale cast to each gradient's dtype."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


#: a leaf above this many elements is updated in flat chunks of this many
#: (the update is elementwise), so that its float32 temporaries stay a
#: chunk's size
SLICE_ELEMENTS = 1 << 26


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, max_grad_norm=1.0):
    """Returns (params, state, metrics), the parameters and moments updated
    in place; ``lr`` a float or a float32 tensor."""
    from ..dist import sharding as SH
    gn = global_norm(grads)
    scale = torch.clamp(max_grad_norm / (gn + 1e-9), max=1.0)
    step = SH.local_value(state["step"]) + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(g, m, v, p):
        g32 = (g * scale.to(g.dtype)).float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
            + weight_decay * p.float()
        p.sub_((lr * delta).to(p.dtype))

    def leaf(g, m, v, p):
        if SH.is_dtensor(p):
            if not tuple(g.placements) == tuple(m.placements) \
                    == tuple(v.placements) == tuple(p.placements):
                raise ValueError(
                    f"adamw_update: gradient {g.placements}, moments "
                    f"{m.placements}/{v.placements} and parameter "
                    f"{p.placements} placed apart")
            g, m, v, p = (t.to_local() for t in (g, m, v, p))
        n = p.numel()
        if n <= SLICE_ELEMENTS:
            upd(g, m, v, p)
            return
        g = g.reshape(-1)
        m, v, p = m.view(-1), v.view(-1), p.view(-1)   # in place: views
        for i in range(0, n, SLICE_ELEMENTS):
            j = i + SLICE_ELEMENTS
            upd(g[i:j], m[i:j], v[i:j], p[i:j])

    tree_map(leaf, grads, state["m"], state["v"], params)
    SH.local_value(state["step"]).copy_(step)
    return params, state, {"grad_norm": gn}
