"""DIEN (Deep Interest Evolution Network, arXiv:1809.03672) for CTR ranking,
the port's counterpart of ``repro.models.recsys``.

Structure (the published configuration: embed_dim=18, seq_len=100,
gru_dim=108, MLP 200-80, interaction=AUGRU):

  behavior seq -> item embedding -> GRU interest extraction (+ auxiliary
  next-behavior loss) -> target-conditioned attention -> AUGRU interest
  evolution -> MLP(interest, target) -> CTR logit.

Both recurrences run through ``kernels/augru`` (a plain GRU is an AUGRU
with attention == 1), so a forward launches the kernel twice and a
retrieval call once.  Parameters are a plain dict with the reference's
tree (``item_table.table``, ``gru_wx``, ``gru_u``, ``att_w``,
``augru_wx``, ``augru_u``, ``mlp[i]``, ``head``, ``aux_w``); the dense
layers, einsums and MLP stay ``torch.matmul``/``einsum`` in float32, as
the reference leaves them to XLA.  ``torch.Generator`` cannot reproduce
``jax.random``, so ``params_from_reference`` carries the reference's
weights over for parity.  ``dien_loss`` is the training loss; under
autograd both ``augru`` launches have their backward kernel.

On a ``DeviceMesh`` the parameters are DTensors (the item table placed by
``dist.sharding.recsys_param_specs``, rows over ``"model"`` and the embed
dim over the data axes; the rest replicated) and so are the batch's leaves
(``recsys_batch_specs``: rows over the data axes where they divide them).
Each rank gathers the table whole for its lookups (its gradient goes back
to the table's placements) and runs the model, both ``augru`` calls
included, on its own batch rows; every parameter's gradient is summed over
the ranks that split the rows, and the losses' sums run over every rank's
rows, in rank order (``dist.sharding``).  The functions then return this
rank's rows (logits, retrieval scores).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..dist import sharding as SH
from ..kernels.augru import augru
from . import layers as L

#: the top-level keys of the reference's parameter tree
PARAM_KEYS = frozenset(("item_table", "gru_wx", "gru_u", "att_w",
                        "augru_wx", "augru_u", "mlp", "head", "aux_w"))


@dataclass(frozen=True)
class DIENConfig:
    name: str
    n_items: int
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: tuple = (200, 80)
    aux_weight: float = 0.1
    dtype: str = "float32"


def dien_init(cfg: DIENConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from ``generator``, on its device, with the
    reference's distributions (not its numbers: see
    ``params_from_reference``)."""
    dt = getattr(torch, cfg.dtype)
    e, g = cfg.embed_dim, cfg.gru_dim
    dev = generator.device

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=dev) * scale

    def dense(d_in, d_out):
        return L.dense_init(generator, d_in, d_out, bias=True, dtype=dt)

    s = 1.0 / math.sqrt(g)
    params = {"item_table": {"table": normal((cfg.n_items, e), 0.05)},
              "gru_wx": dense(e, 3 * g),
              "gru_u": normal((g, 3 * g), s),
              "att_w": normal((g, e), s),
              "augru_wx": dense(g, 3 * g),
              "augru_u": normal((g, 3 * g), s)}
    mlp, d_prev = [], g + e
    for d in cfg.mlp_dims:
        mlp.append(dense(d_prev, d))
        d_prev = d
    params["mlp"] = mlp
    params["head"] = dense(d_prev, 1)
    params["aux_w"] = normal((g, e), s)
    return params


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree_map(fn, v) for v in node]
    return fn(node)


def params_from_reference(tree, device="cpu") -> dict:
    """The reference's ``dien_init`` parameters, as a tree of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tensors on
    ``device``.  Raises on a tree of another shape."""
    if set(tree) != PARAM_KEYS:
        raise ValueError(f"not a DIEN parameter tree: keys {sorted(tree)}")
    return _tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                     tree)


def params_to(params: dict, device) -> dict:
    """A copy of ``params`` on ``device``."""
    return _tree_map(lambda t: t.to(device), params)


def _on_rows(params, batch, lead: str):
    """(mesh, the mesh dims splitting the rows of batch leaf ``lead``,
    the parameters and the batch as this rank's plain tensors): each
    parameter whole, its gradient summed over those dims; each batch leaf
    its local rows.  Plain tensors pass through, with (None, ())."""
    x = batch[lead]
    if not SH.is_dtensor(x):
        return None, (), params, batch
    mesh, dims = x.device_mesh, SH.split_dims(x)
    params = _tree_map(
        lambda t: SH.sum_grads(SH.whole_local(t), mesh, dims), params)
    return mesh, dims, params, {k: SH.local_value(v) for k, v in batch.items()}


def _roll_rows(x, mesh, dims):
    """``torch.roll(x, 1, dims=0)`` of rows split over mesh ``dims``: a
    rank's first row is the previous rank's last row, and the first
    rank's is the last rank's (the roll wraps around)."""
    if not dims:
        return torch.roll(x, 1, dims=0)
    last = SH.gather_rows(x[-1:], mesh, dims)
    i = SH.shard_index(mesh, dims)
    return torch.cat([last[i - 1:i] if i else last[-1:], x[:-1]])


def _mlp_head(params, x):
    for p in params["mlp"]:
        x = torch.relu(L.dense(p, x))
    return L.dense(params["head"], x)[..., 0]


def _interest_states(cfg, params, hist_emb, hist_mask):
    """GRU interest extraction: (B, T, e) -> (B, T, g)."""
    B, T, _ = hist_emb.shape
    xg = L.dense(params["gru_wx"], hist_emb)             # (B, T, 3g)
    ones = torch.ones((B, T), dtype=hist_emb.dtype, device=hist_emb.device)
    h0 = torch.zeros((B, cfg.gru_dim), dtype=hist_emb.dtype,
                     device=hist_emb.device)
    states = augru(xg, params["gru_u"], ones, h0)        # GRU == AUGRU@att=1
    return states * hist_mask[..., None]


def _aux_loss(cfg, params, states, hist_emb, mask, mesh=None, dims=()):
    """State_t should predict behavior_{t+1} over a shifted negative
    (DIEN's aux net, bilinear form); rows split over mesh ``dims`` sum
    over every rank's."""
    pred = torch.einsum("btg,ge->bte", states[:, :-1], params["aux_w"])
    pos = torch.einsum("bte,bte->bt", pred, hist_emb[:, 1:])
    neg_emb = _roll_rows(hist_emb[:, 1:], mesh, dims)       # cheap negatives
    neg = torch.einsum("bte,bte->bt", pred, neg_emb)
    m = mask[:, 1:] * mask[:, :-1]
    aux = -(torch.log(torch.sigmoid(pos) + 1e-9)
            + torch.log(1.0 - torch.sigmoid(neg) + 1e-9))
    return cfg.aux_weight * SH.sum_over((aux * m).sum(), mesh, dims) \
        / torch.clamp(SH.sum_over(m.sum(), mesh, dims), min=1.0)


def dien_forward(cfg: DIENConfig, params, batch, *, aux: bool = True):
    """batch: hist (B, T) int32, hist_mask (B, T), target (B,) int32.
    Returns (logit (B,), aux_loss scalar).  ``aux=False`` skips the
    auxiliary loss and returns None in its place: the reference's jitted
    serve step never computes it either, since XLA drops the unused
    value.  On a mesh the logits are this rank's rows'."""
    mesh, dims, params, batch = _on_rows(params, batch, "target")
    table = params["item_table"]["table"]
    hist_emb = table[batch["hist"].long()]                   # (B, T, e)
    tgt_emb = table[batch["target"].long()]                  # (B, e)
    mask = batch["hist_mask"].to(hist_emb.dtype)

    states = _interest_states(cfg, params, hist_emb, mask)
    aux_loss = (_aux_loss(cfg, params, states, hist_emb, mask, mesh, dims)
                if aux else None)

    # target-conditioned attention -> AUGRU interest evolution
    att_logits = torch.einsum("btg,ge,be->bt", states, params["att_w"],
                              tgt_emb)
    att_logits = att_logits.masked_fill(mask <= 0, -1e30)
    att = torch.softmax(att_logits, dim=-1) * mask
    xg2 = L.dense(params["augru_wx"], states)
    h0 = torch.zeros((states.shape[0], cfg.gru_dim), dtype=states.dtype,
                     device=states.device)
    evolved = augru(xg2, params["augru_u"], att, h0)
    final = evolved[:, -1]                                   # (B, g)

    logit = _mlp_head(params, torch.cat([final, tgt_emb], dim=-1))
    return logit, aux_loss


def dien_loss(cfg: DIENConfig, params, batch):
    """Binary cross entropy of sigmoid(logit) against ``label`` (with the
    reference's +1e-9 inside each log), plus the auxiliary loss."""
    logit, aux = dien_forward(cfg, params, batch)
    label = batch["label"]
    y = SH.local_value(label).float()
    p = torch.sigmoid(logit.float())
    terms = y * torch.log(p + 1e-9) + (1 - y) * torch.log(1 - p + 1e-9)
    dims = SH.split_dims(label)
    if dims:              # the mean over every rank's rows
        return -SH.sum_over(terms.sum(), label.device_mesh, dims) \
            / label.shape[0] + aux
    return -terms.mean() + aux


def dien_retrieval_score(cfg: DIENConfig, params, batch):
    """Score ONE user's history against M candidates with DIN-style
    attention pooling over precomputed GRU states (no per-candidate
    recurrence).  batch: hist (1, T), hist_mask (1, T), candidates (M,).
    Returns scores (M,) (on a mesh, of this rank's candidates)."""
    _, _, params, batch = _on_rows(params, batch, "candidates")
    table = params["item_table"]["table"]
    hist_emb = table[batch["hist"].long()]
    mask = batch["hist_mask"].to(hist_emb.dtype)
    states = _interest_states(cfg, params, hist_emb, mask)[0]   # (T, g)
    cand_emb = table[batch["candidates"].long()]                # (M, e)

    att = torch.einsum("tg,ge,me->mt", states, params["att_w"], cand_emb)
    att = att.masked_fill(mask[0][None, :] <= 0, -1e30)
    att = torch.softmax(att, dim=-1)                            # (M, T)
    interest = att @ states                                     # (M, g)
    return _mlp_head(params, torch.cat([interest, cand_emb], dim=-1))
