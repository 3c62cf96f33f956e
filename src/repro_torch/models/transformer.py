"""Decoder-only LM transformer (GQA + RoPE attention, dense or MoE FFN), the
port's counterpart of ``repro.models.transformer``.

Covers the reference's five LM architectures through its config surface:
starcoder2-3b (LayerNorm + tanh-GELU, all biases, tied embeddings),
minitron-8b (squared-ReLU, no bias), qwen1.5-110b (QKV bias, SwiGLU), and
the MoE FFN (``cfg.moe``) of qwen2-moe-a2.7b (60 routed top-4 + 4 shared
experts) and olmoe-1b-7b (64 routed top-8, QK-norm).

- Parameters are a plain dict with the reference's tree: ``embed.table``,
  ``layers`` (every leaf stacked on a leading L axis), ``final_norm`` and,
  untied, ``lm_head``.  ``torch.Generator`` cannot reproduce
  ``jax.random``, so ``params_from_reference`` carries the reference's
  weights over for parity.
- The layers run as a Python loop (the reference's ``unroll_layers``
  path; its ``lax.scan`` computes the same).  Under autograd ``remat``
  is the reference's: ``"full"`` recomputes each layer in the backward
  (``torch.utils.checkpoint``, non-reentrant), ``"dots"`` keeps the
  layer's matrix products without batch dimensions (``aten.mm``/``addmm``,
  the counterpart of ``dots_with_no_batch_dims_saveable``) and recomputes
  the rest, ``"none"`` keeps everything.  ``lm_loss`` is the training
  loss.
- The prefill forward's attention is ``kernels/flash_attention``: the
  hand-written CUDA kernel on the card (one launch per layer), the plain
  ``gqa_attention`` on the CPU.  Decode attends over a (L, B, Hkv, S_max,
  Dh) cache through the plain ``gqa_attention`` with a ``kv_valid_len``
  mask, as the reference does; ``decode_step`` writes this step's keys and
  values into the cache in place (the reference returns an updated copy)
  and returns the same dict.
- Dense layers, einsums and the logits stay ``torch.matmul`` in the
  parameters' dtype, as the reference leaves them to XLA.
- The MoE dispatch is the reference's sort-based one with static shapes
  (``_moe_apply``): top-k with ties to the lower expert, a stable sort of
  the (token, choice) pairs by expert, the rank within an expert, a
  capacity drop, an (E, C, d) buffer per group and the weighted combine.
  It is built from permutations and gathers only: no scatter with
  repeated indices and no ``index_add_``, and each token's k
  contributions, gathered in ascending expert order (the order of the
  reference's scatter), are added by one fixed-order sum, so the forward
  and the backward repeat bit for bit on the card.  ``dispatch_groups``
  G > 1 routes within G token groups (when G divides the token count) in
  one batched dispatch.
- Under a mesh (``dist.sharding``) the forward, ``lm_loss`` and the MoE
  layer run on DTensor parameters (placed by ``lm_param_specs``) and batches
  (``lm_batch_specs``), with ``constrain`` where the reference puts it:
  after the embedding, on each layer's residual, on the logits and around
  the MoE dispatch.  Dense layers are DTensor products; the attention runs
  ``flash_attention`` on each rank's local heads (``_attention_sharded``:
  q's heads over ``"model"``, k and v replicated over it, since ``wk``'s
  shard may end mid-head; where the heads do not divide it, each model
  rank's run of (row, head) units); the MoE routing, sort and gathers run on
  each rank's token groups with the experts' products DTensor ``bmm``s
  (expert parallel or the ff dim's tensor parallelism, as the rules place
  the experts); the cross entropy reduces over vocab shards
  (``_cross_entropy_sharded``).  ``decode_step`` runs on a cache placed by
  ``lm_cache_specs`` (batch over the data axes, kv heads over ``"model"``
  where they divide them): the projections are DTensor products, each rank
  writes its step's keys and values into its own cache shard in place and
  attends its local query heads over it
  (``_attention_with_cache_sharded``).  ``init_params_abstract`` and
  ``cache_abstract`` give the trees as meta tensors.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from ..dist import sharding as SH
from ..dist.sharding import constrain
from ..kernels.flash_attention import (BLOCKWISE_KV_THRESHOLD,
                                       flash_attention, gqa_attention)
from . import layers as L

#: the parameter dtypes the configurations name, as torch dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # shared experts, each d_ff_expert wide
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    dispatch_groups: int = 1


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    mlp_bias: bool = False
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "silu"            # silu | gelu | relu2
    gated_mlp: bool = True
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    dtype: str = "float32"       # parameter/compute dtype
    remat: str = "none"          # none | full | dots (under autograd)

    @property
    def head_dim(self):
        return self.d_head or self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    def num_params(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * dh * d
        if self.moe:
            m = self.moe
            per_expert = 3 * d * m.d_ff_expert if self.gated_mlp \
                else 2 * d * m.d_ff_expert
            ffn = (m.num_experts + m.num_shared) * per_expert \
                + d * m.num_experts
        else:
            ffn = (3 if self.gated_mlp else 2) * d * self.d_ff
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn) + embed

    def num_active_params(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts)."""
        if not self.moe:
            return self.num_params()
        d = self.d_model
        m = self.moe
        per_expert = (3 if self.gated_mlp else 2) * d * m.d_ff_expert
        dh = self.head_dim
        attn = d * dh * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * dh * d
        ffn_active = (m.top_k + m.num_shared) * per_expert \
            + d * m.num_experts
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn_active) + embed


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _layer_init(cfg: TransformerConfig, generator: torch.Generator) -> dict:
    """One layer's parameters on the generator's device."""
    dt, dev = cfg.param_dtype, generator.device
    d, dh = cfg.d_model, cfg.head_dim
    p = {
        "ln1": L.norm_init(cfg.norm, d, dt, dev),
        "ln2": L.norm_init(cfg.norm, d, dt, dev),
        "wq": L.dense_init(generator, d, cfg.n_heads * dh,
                           bias=cfg.qkv_bias, dtype=dt),
        "wk": L.dense_init(generator, d, cfg.n_kv_heads * dh,
                           bias=cfg.qkv_bias, dtype=dt),
        "wv": L.dense_init(generator, d, cfg.n_kv_heads * dh,
                           bias=cfg.qkv_bias, dtype=dt),
        "wo": L.dense_init(generator, cfg.n_heads * dh, d,
                           bias=cfg.mlp_bias, dtype=dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(dh, dt, dev)
        p["k_norm"] = L.rmsnorm_init(dh, dt, dev)
    if cfg.moe is None:
        p["mlp"] = L.mlp_init(generator, d, cfg.d_ff, gated=cfg.gated_mlp,
                              bias=cfg.mlp_bias, dtype=dt)
        return p
    m = cfg.moe
    e, f = m.num_experts, m.d_ff_expert

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=dev) * scale

    p["router"] = {"w": normal((d, e), 1.0 / np.sqrt(d))}
    p["experts"] = {"up": normal((e, d, f), 1.0 / np.sqrt(d)),
                    "down": normal((e, f, d), 1.0 / np.sqrt(f))}
    if cfg.gated_mlp:
        p["experts"]["gate"] = normal((e, d, f), 1.0 / np.sqrt(d))
    if m.num_shared:
        p["shared"] = L.mlp_init(generator, d, m.num_shared * f,
                                 gated=cfg.gated_mlp, bias=cfg.mlp_bias,
                                 dtype=dt)
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from ``generator``, on its device, with the
    reference's distributions (not its numbers).  The layers are drawn one
    at a time into tensors stacked on a leading L axis."""
    dt = cfg.param_dtype
    embed = L.embedding_init(generator, cfg.vocab, cfg.d_model, dt)
    first = _layer_init(cfg, generator)
    layers = _tree_map(lambda t: t.new_empty((cfg.n_layers, *t.shape)),
                       first)
    for i in range(cfg.n_layers):
        layer = first if i == 0 else _layer_init(cfg, generator)
        _tree_map(lambda dst, src: dst[i].copy_(src), layers, layer)
    params = {"embed": embed, "layers": layers,
              "final_norm": L.norm_init(cfg.norm, cfg.d_model, dt,
                                        generator.device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab,
                                         dtype=dt)
    return params


def init_params_abstract(cfg: TransformerConfig) -> dict:
    """``init_params``' tree as meta tensors of its shapes and dtypes,
    nothing allocated (the counterpart of the reference's
    ``jax.eval_shape`` of ``init_params``): one layer is built under
    ``FakeTensorMode`` and its leaves stacked to ``n_layers``."""
    import dataclasses
    one = L.abstract_tree(init_params, dataclasses.replace(cfg, n_layers=1),
                          torch.Generator())
    one["layers"] = _tree_map(
        lambda t: torch.empty((cfg.n_layers, *t.shape[1:]), dtype=t.dtype,
                              device="meta"), one["layers"])
    return one


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes.bfloat16: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_reference(tree, device="cpu") -> dict:
    """The reference's ``init_params`` parameters, as a tree of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as the port's tensors on
    ``device``, bit for bit (bf16 included).  Raises on another tree."""
    keys = set(tree)
    if not {"embed", "layers", "final_norm"} <= keys <= {
            "embed", "layers", "final_norm", "lm_head"}:
        raise ValueError(f"not a transformer parameter tree: keys "
                         f"{sorted(keys)}")
    return _tree_map(lambda a: _to_tensor(a, device), tree)


def params_to(params: dict, device) -> dict:
    """A copy of ``params`` on ``device``."""
    return _tree_map(lambda t: t.to(device), params)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    return _tree_map(lambda t: t[i], params["layers"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _project_qkv(cfg: TransformerConfig, p, x, positions):
    """q (B, H, S, Dh), k and v (B, Hkv, S, Dh), RoPE applied."""
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = L.dense(p["wq"], x).reshape(B, S, H, Dh)
    k = L.dense(p["wk"], x).reshape(B, S, Hkv, Dh)
    v = L.dense(p["wv"], x).reshape(B, S, Hkv, Dh)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q)
        k = L.rmsnorm(p["k_norm"], k)
    q = L.apply_rope(q.transpose(1, 2), positions[:, None, :],
                     cfg.rope_theta)                    # (B, H, S, Dh)
    k = L.apply_rope(k.transpose(1, 2), positions[:, None, :],
                     cfg.rope_theta)
    return q, k, v.transpose(1, 2)


def _attention(cfg: TransformerConfig, p, x, positions):
    """x: (B, S, d) -> causal self-attention output (B, S, d) and this
    step's (k, v) (None for a DTensor ``x``: ``_attention_sharded``)."""
    if SH.is_dtensor(x):
        return _attention_sharded(cfg, p, x), None
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = flash_attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return L.dense(p["wo"], o), (k, v)


def _local_kv_heads(k, h0: int, n_q: int, group: int):
    """The kv heads (axis 1 of ``k``, all Hkv of them) that query heads
    [h0, h0 + n_q) read, laid out for a GQA call of ``n_q`` query heads:
    a contiguous run when the local query heads are whole groups or lie in
    one group, else one kv head per query head."""
    if n_q % group == 0:
        return k[:, h0 // group:(h0 + n_q) // group]
    if group % n_q == 0:
        return k[:, h0 // group:h0 // group + 1]
    idx = torch.arange(h0, h0 + n_q, device=k.device) // group
    return k.index_select(1, idx)


def _head_units(mesh, Bl: int, H: int):
    """This rank's share of its data shard's (batch row, head) units where
    the ``H`` heads do not divide ``"model"`` but the ``Bl * H`` units do,
    each model rank taking the next run of them: (b0, nb, h0, nh), rows
    [b0, b0 + nb) at heads [h0, h0 + nh), whole rows or part of one row.
    None where the heads split (or the axis is one rank) and where the
    units do not split so (every model rank then computes them all)."""
    nm = SH.axis_size(mesh, "model")
    if nm == 1 or H % nm == 0 or Bl * H % nm:
        return None
    n = Bl * H // nm
    u0 = SH.coordinate(mesh, "model") * n
    if n % H == 0:
        return u0 // H, n // H, 0, H
    if H % n == 0:
        return u0 // H, 1, u0 % H, n
    return None


def _gather_units(o, mesh, Bl: int, H: int):
    """The attention output ``o`` (nb, nh, S, Dh) of this rank's units
    (``_head_units``) gathered over ``"model"`` into its data shard's
    (Bl, S, H * Dh), whole on every model rank (each keeps its units'
    rows of the gradient)."""
    nb, nh, S, Dh = o.shape
    model = mesh.mesh_dim_names.index("model")
    whole = SH.gather_rows(o.reshape(nb * nh, S, Dh), mesh, (model,),
                           partial_grad=False)
    return whole.reshape(Bl, H, S, Dh).transpose(1, 2).reshape(
        Bl, S, H * Dh)


def _attention_sharded(cfg: TransformerConfig, p, x):
    """The attention of a DTensor x (B, S, d) on its mesh: the projections
    are DTensor products; q is laid out batch over the data axes and heads
    over ``"model"`` (where the heads divide it), k and v replicated over
    ``"model"`` (a kv shard of ``wk``'s flat ``Hkv * Dh`` columns may end
    mid-head), and each rank runs ``flash_attention`` on its local heads
    (the kernel on the card) with the kv heads they read.  Where the heads
    do not divide ``"model"``, q is replicated over it too and each model
    rank computes its run of the data shard's (row, head) units
    (``_head_units``), their outputs gathered back over ``"model"``.  A
    weight or activation used whole by a rank that computes only its own
    heads gets a partial-sum gradient over ``"model"``."""
    mesh = x.device_mesh
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    batch = SH.fsdp_entry(mesh, B)
    Bl = B // int(np.prod([SH.axis_size(mesh, a) for a in batch or ()]))
    split = SH.axis_size(mesh, "model") > 1 \
        and H % SH.axis_size(mesh, "model") == 0
    units = None if split else _head_units(mesh, Bl, H)
    kv_pl = SH.placements(mesh, SH.P(batch, None, None))
    q_pl = SH.placements(mesh, SH.P(batch, None, "model")) if split \
        else kv_pl
    work_pl = SH.placements(mesh, SH.P(
        batch, None, "model" if split or units else None))
    grad_pl = SH.partial_where_sharded(work_pl)
    kv_grad_pl = SH.partial_where_sharded(work_pl, kv_pl)
    q = L.dense(p["wq"], x).redistribute(mesh, q_pl).to_local(
        grad_placements=None if split else kv_grad_pl)
    k = L.dense(p["wk"], x).redistribute(mesh, kv_pl).to_local(
        grad_placements=kv_grad_pl)
    v = L.dense(p["wv"], x).redistribute(mesh, kv_pl).to_local(
        grad_placements=kv_grad_pl)
    q = q.reshape(Bl, S, -1, Dh)
    k = k.reshape(Bl, S, Hkv, Dh)
    v = v.reshape(Bl, S, Hkv, Dh)
    Hl = q.shape[2]
    b0, nb, h0, nh = units or (
        0, Bl, SH.coordinate(mesh, "model") * Hl if split else 0, Hl)
    if units:
        q = q[b0:b0 + nb, :, h0:h0 + nh]
        k, v = k[b0:b0 + nb], v[b0:b0 + nb]
    if cfg.qk_norm:
        q = L.rmsnorm({"scale": SH.local_replica(p["q_norm"]["scale"],
                                                  grad_pl)}, q)
        k = L.rmsnorm({"scale": SH.local_replica(p["k_norm"]["scale"],
                                                  grad_pl)}, k)
    positions = torch.arange(S, device=q.device).expand(nb, S)
    q = L.apply_rope(q.transpose(1, 2), positions[:, None, :],
                     cfg.rope_theta)                    # (nb, nh, S, Dh)
    k = L.apply_rope(k.transpose(1, 2), positions[:, None, :],
                     cfg.rope_theta)
    v = v.transpose(1, 2)
    if split or units:
        k = _local_kv_heads(k, h0, nh, H // Hkv)
        v = _local_kv_heads(v, h0, nh, H // Hkv)
    o = flash_attention(q, k, v, causal=True)
    if units:
        return L.dense(p["wo"], SH.from_local(
            _gather_units(o, mesh, Bl, H), mesh, kv_pl))
    o = o.transpose(1, 2).reshape(Bl, S, Hl * Dh)
    return L.dense(p["wo"], SH.from_local(o, mesh, q_pl))


def _masked_attention(q, k, v, kv_valid_len):
    """Decode attention over a cache with ``kv_valid_len`` live entries
    (reshape-GQA, blockwise over long caches — no repeated-KV tensor)."""
    Sk = k.shape[2]
    block_kv = 2048 if Sk > BLOCKWISE_KV_THRESHOLD else None
    return gqa_attention(q, k, v, causal=False, kv_valid_len=kv_valid_len,
                         block_kv=block_kv)


# ---------------------------------------------------------------------------
# MoE layer (sort-based dispatch, static shapes)
# ---------------------------------------------------------------------------

def _moe_groups(m: MoEConfig, n_tokens: int) -> int:
    """The reference's dispatch groups: ``dispatch_groups`` when it is
    above 1 and divides the token count, else one group."""
    G = m.dispatch_groups
    return G if G > 1 and n_tokens % G == 0 else 1


def moe_capacity(m: MoEConfig, n: int) -> int:
    """Rows each expert keeps in a group of ``n`` tokens: the reference's
    own expression, evaluated in its order."""
    return int(np.ceil(n * m.top_k / m.num_experts * m.capacity_factor))


def moe_route(cfg: TransformerConfig, p, x):
    """x: (..., d) -> the router's float32 probabilities (..., E), the
    top-k renormalised weights (..., k) and experts (..., k).  The logits
    are computed in x's dtype, then cast to float32.  Ties go to the lower
    expert, as ``jax.lax.top_k`` breaks them (``torch.topk`` does not
    promise an order): a stable descending sort, its first k."""
    k = cfg.moe.top_k
    probs = torch.softmax((x @ p["router"]["w"]).float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _moe_apply(cfg: TransformerConfig, p, x):
    """x: (N, d) -> (N, d), plus the load-balancing aux loss (float32).
    With G dispatch groups (``_moe_groups``) the tokens are routed within
    G groups of N // G, each with its own capacity, and the aux is the
    groups' mean.  The shared experts run on the whole x."""
    m = cfg.moe
    N, d = x.shape
    G = _moe_groups(m, N)
    if SH.is_dtensor(x):
        out, aux = _moe_dispatch_sharded(cfg, p, x.reshape(G, N // G, d))
    else:
        out, aux = _moe_dispatch(cfg, p, x.reshape(G, N // G, d))
    out = out.reshape(N, d)
    if m.num_shared:
        out = out + L.mlp(p["shared"], x, act=cfg.act)
    return out, aux.mean()


def _moe_dispatch(cfg: TransformerConfig, p, x):
    """Sort-based dispatch of G token groups at once: x (G, n, d) -> (G, n,
    d) and each group's aux loss (G,).

    The (token, choice) pairs of a group are sorted stably by expert (one
    sort on ``group * E + expert``), so ranks within an expert follow token
    order; a pair of rank >= C is dropped.  The buffer holds E x (G, C)
    rows, the rows of one expert contiguous for one batched product, and
    is gathered from x expanded k-fold at each filled slot's pair: a
    dropped pair is never written.  Each kept pair reads its expert's row
    back through the same slot, a dropped pair's weight is 0, and each
    token's k weighted contributions, in ascending expert order, are
    added by one sum over k (in x's dtype; a bf16 sum accumulates in
    float32 and rounds once)."""
    buf, combine, aux = _moe_buffer(cfg, p, x)
    up = torch.bmm(buf, p["experts"]["up"])
    if cfg.gated_mlp:
        h = L.activation(cfg.act, torch.bmm(buf, p["experts"]["gate"])) * up
    else:
        h = L.activation(cfg.act, up)
    del buf, up
    y = torch.bmm(h, p["experts"]["down"])
    del h
    return combine(y), aux


def _moe_buffer(cfg: TransformerConfig, p, x):
    """The dispatch of ``_moe_dispatch`` up to the experts: x (G, n, d) ->
    the (E, G * C, d) buffer, ``combine`` (the experts' (E, G * C, d)
    output -> (G, n, d)) and each group's aux loss (G,)."""
    m = cfg.moe
    G, n, d = x.shape
    E, k = m.num_experts, m.top_k
    M = n * k                                           # pairs a group
    dev = x.device
    probs, top_p, top_e = moe_route(cfg, p, x)          # (G, n, E|k|k)

    # ---- sort the pairs by (group, expert); rank within an expert ----
    group = torch.arange(G, device=dev)
    key = (top_e + E * group[:, None, None]).reshape(G * M)
    order = torch.sort(key, stable=True).indices
    key_s = key[order]
    start = torch.searchsorted(key_s, torch.arange(G * E, device=dev))
    count = torch.diff(start, append=start.new_full((1,), G * M))
    rank_s = torch.arange(G * M, device=dev) - start[key_s]
    rank = torch.empty_like(rank_s).scatter_(0, order, rank_s)

    # Switch-style aux: fraction of pairs x router prob mass per expert
    me = probs.mean(dim=1)                              # (G, E)
    ce = count.view(G, E).float() * (1.0 / M)
    aux = m.aux_loss_weight * E * (me * ce).sum(-1)

    # ---- dispatch: slot (e, g, r) takes the r-th pair of (g, e) ----
    C = moe_capacity(m, n)
    r = torch.arange(C, device=dev)
    first = start.view(G, E).t()[..., None]             # (E, G, 1)
    filled = (r < count.view(G, E).t()[..., None]).reshape(-1, 1)
    pair = order[(first + r).clamp(max=G * M - 1).reshape(-1)]
    # x expanded k-fold (a view) read at each slot's (token, choice) pair:
    # a permutation, so the backward adds no two rows into one
    xk = x.reshape(G * n, 1, d).expand(G * n, k, d)
    buf = xk[pair // k, pair % k].masked_fill_(~filled, 0).view(E, G * C, d)

    # ---- combine: each token's k choices in ascending expert order, a
    # dropped pair weighted 0 ----
    top_e, by_expert = torch.sort(top_e, dim=-1)
    rank = rank.view(G, n, k).gather(-1, by_expert)
    w = top_p.gather(-1, by_expert).masked_fill(rank >= C, 0).to(x.dtype)
    slot = ((top_e * G + group[:, None, None]) * C + rank).clamp(
        max=E * G * C - 1)

    def combine(y):
        return (y.reshape(E * G * C, d)[slot] * w[..., None]).sum(-2)
    return buf, combine, aux


def _moe_dispatch_sharded(cfg: TransformerConfig, p, x):
    """``_moe_dispatch`` of a DTensor x (G, n, d) on its mesh.  The groups
    lie over the data axes where they divide them (each rank routes its
    own groups, as G dispatch groups aligned with the data shards mean),
    else every rank routes all tokens; the routing, sort and gathers run
    on each rank's tokens as in ``_moe_dispatch``, with the router
    replicated.  The (E, G * C, d) buffer is a DTensor over the same
    groups, its experts' products DTensor ``bmm``s against the experts'
    placements (expert parallel when ``lm_param_specs`` put the experts
    over ``"model"``, the ff dim's tensor parallelism otherwise); their
    output is gathered back to the groups' layout for the combine."""
    m = cfg.moe
    mesh = x.device_mesh
    G = x.shape[0]
    if G > 1:
        x = constrain(x, (0, "fsdp"))
    groups = SH.fsdp_entry(mesh, G) if G > 1 else None
    tok_pl = SH.placements(mesh, SH.P(groups, None, None))
    buf_pl = SH.placements(mesh, SH.P(None, groups, None))
    grad_pl = SH.partial_where_sharded(tok_pl)
    xl = x.redistribute(mesh, tok_pl).to_local()
    router = {"w": SH.local_replica(p["router"]["w"], grad_pl)}
    buf, combine, aux = _moe_buffer(cfg, {"router": router}, xl)
    buf = SH.from_local(buf, mesh, buf_pl)
    if G == 1:
        buf = constrain(buf, (0, "model"), (1, "fsdp"))
    up = torch.bmm(buf, p["experts"]["up"])
    if cfg.gated_mlp:
        h = L.activation(cfg.act, torch.bmm(buf, p["experts"]["gate"])) * up
    else:
        h = L.activation(cfg.act, up)
    del buf, up
    y = torch.bmm(h, p["experts"]["down"]).redistribute(mesh, buf_pl)
    del h
    out = SH.from_local(combine(y.to_local()), mesh, tok_pl)
    if G > 1:
        out = constrain(out, (0, "fsdp"))
    return out, SH.from_local(aux, mesh, tok_pl)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _block(cfg: TransformerConfig, p, h, positions):
    """One layer: (h, the MoE FFN's aux loss, or None for a dense FFN)."""
    a, _ = _attention(cfg, p, _norm(cfg, p["ln1"], h), positions)
    h = h + a
    x = _norm(cfg, p["ln2"], h)
    if cfg.moe is None:
        return h + L.mlp(p["mlp"], x, act=cfg.act), None
    B, S, d = x.shape
    y, aux = _moe_apply(cfg, p, x.reshape(B * S, d))
    return h + y.reshape(B, S, d), aux


def _norm(cfg: TransformerConfig, p, x):
    """``cfg.norm`` over x's last dim; a DTensor x is first made whole
    along it (the per-layer residual is sharded over ``"model"`` there)
    and any partial sum is reduced (over mesh dims of more than one rank:
    on a one-rank dim the norm reads x itself, so that its gradient adds
    up in the unsharded model's order)."""
    if SH.is_dtensor(x):
        x = SH.redistribute(x, SH.whole_along(x.placements, x.ndim - 1))
    return L.norm_apply(cfg.norm, p, x)


def _logits(cfg: TransformerConfig, params, h):
    h = _norm(cfg, params["final_norm"], h)
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].T
    return L.dense(params["lm_head"], h)


#: the matrix products "dots" keeps (no batch dimensions): a dense layer's
#: ``x @ w`` (+ b) reaches these aten ops
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _run_block(cfg: TransformerConfig, p, h, positions):
    """One layer under ``cfg.remat`` (only where autograd records)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return _block(cfg, p, h, positions)
    if cfg.remat == "full":
        return _ckpt.checkpoint(_block, cfg, p, h, positions,
                                use_reentrant=False)
    if cfg.remat == "dots":
        return _ckpt.checkpoint(
            _block, cfg, p, h, positions, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"remat {cfg.remat!r}: none, full or dots")


def forward(cfg: TransformerConfig, params, tokens):
    """tokens: (B, S) -> logits (B, S, vocab), aux loss (float32: the MoE
    layers' load-balancing losses summed in layer order, zero for a dense
    FFN)."""
    B, S = tokens.shape
    h = _embed(params["embed"]["table"], tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    # the stacked leaves cut into their layers once: under autograd each
    # leaf's gradient is then one stack of the layers' (a slice per layer
    # would add a zero-filled leaf-sized gradient per layer)
    layers = _tree_map(SH.unbind, params["layers"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    h = constrain(h, (0, "fsdp"))
    for i in range(cfg.n_layers):
        h, a = _run_block(cfg, _tree_map(lambda t: t[i], layers), h,
                          positions)
        # the residual kept for the backward, sharded over both mesh axes
        h = constrain(h, (0, "fsdp"), (2, "model"))
        if a is not None:
            aux = aux + SH.replicated_value(a)
    # vocab-sharded logits: kept split over the model axis through the loss
    return constrain(_logits(cfg, params, h), (0, "fsdp"), (2, "model")), aux


def _embed(table, tokens):
    """``table[tokens]``; a DTensor table is gathered whole and each rank
    looks up its own tokens (the result laid out as the tokens)."""
    if not SH.is_dtensor(table):
        return table[tokens]
    mesh = tokens.device_mesh
    rows = SH.local_replica(table, SH.partial_where_sharded(tokens.placements))
    return SH.from_local(rows[tokens.to_local()], mesh, tokens.placements)


def lm_loss(cfg: TransformerConfig, params, batch):
    """batch: {tokens (B, S), targets (B, S)} -> scalar loss: the cross
    entropy of the (B, S, V) logits against the targets, plus the aux
    loss."""
    logits, aux = forward(cfg, params, batch["tokens"])
    if SH.is_dtensor(logits):
        return _cross_entropy_sharded(logits, batch["targets"]) + aux
    return L.cross_entropy_loss(logits, batch["targets"]) + aux


def _cross_entropy_sharded(logits, labels):
    """``L.cross_entropy_loss`` of DTensor logits (B, S, V), the vocab
    possibly sharded: each rank takes its shard's row max (reduced to the
    global max, no gradient), its float32 sum of exp and its label logit
    (0 where the label lies in another shard, or outside [0, V)); the two
    sums are reduced over the vocab shards, and the mean of lse - label
    logit over every row.  Returns a plain scalar, the same on every
    rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = logits.device_mesh
    logits = logits.redistribute(mesh, SH.no_partial(logits.placements))
    pl = logits.placements
    vocab = [i for i, q in enumerate(pl) if q == Shard(2)]
    rows = tuple(Replicate() if i in vocab else q for i, q in enumerate(pl))
    part = tuple(Partial() if i in vocab else q for i, q in enumerate(pl))
    loc = logits.to_local()
    split = [i for i, q in enumerate(rows) if isinstance(q, Shard)]
    if not vocab:
        # each rank's rows whole: ``L.cross_entropy_loss`` of its rows, the
        # mean of the equal shards' means
        ce = L.cross_entropy_loss(
            loc, labels.redistribute(mesh, rows).to_local())
        if not split:
            return ce
        total = SH.from_local(ce[None], mesh, tuple(
            Partial() if i in split else Replicate()
            for i in range(mesh.ndim)))
        return total.full_tensor()[0] / int(np.prod(
            [mesh.size(i) for i in split]))
    Vl = loc.shape[-1]
    v0 = SH.shard_index(mesh, vocab) * Vl
    m = torch.amax(loc, dim=-1, keepdim=True).detach()
    for i in vocab:
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    sumexp = torch.sum(torch.exp((loc - m).float()), dim=-1)
    sumexp = SH.from_local(sumexp, mesh, part).redistribute(
        mesh, rows).to_local()
    lse = torch.log(sumexp) + m[..., 0].float()
    lab = labels.redistribute(mesh, rows).to_local().long() - v0
    picked = torch.gather(loc, -1, lab.clamp(0, Vl - 1)[..., None])
    ll = torch.where((lab >= 0) & (lab < Vl), picked[..., 0].float(), 0.0)
    ll = SH.from_local(ll, mesh, part).redistribute(mesh, rows).to_local()
    total = SH.from_local((lse - ll).sum()[None], mesh, tuple(
        Partial() if i in split else Replicate() for i in range(mesh.ndim)))
    return total.full_tensor()[0] / (labels.shape[0] * labels.shape[1])


# ---------------------------------------------------------------------------
# decode (serving) path
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device="cpu") -> dict:
    dt = dtype or cfg.param_dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def cache_abstract(cfg: TransformerConfig, batch: int, max_len: int,
                   dtype=None) -> dict:
    """``init_cache``'s tree as meta tensors (nothing allocated)."""
    return init_cache(cfg, batch, max_len, dtype, device="meta")


def decode_step(cfg: TransformerConfig, params, cache, tokens, pos: int):
    """One decode step.  tokens: (B, 1); pos: the current length.  Writes
    this step's keys and values into ``cache`` at ``pos`` (in place) and
    returns (logits (B, vocab), cache).  An MoE FFN routes the step's
    N = B tokens as the reference does (in groups when the dispatch groups
    divide B; the aux loss is dropped).  On a mesh the parameters, cache
    and tokens are DTensors (``pos`` stays an int) and so are the
    logits; each rank writes into its local cache shard."""
    B = tokens.shape[0]
    h = _embed(params["embed"]["table"], tokens)    # (B, 1, d)
    positions = torch.full((B, 1), int(pos), device=tokens.device)
    layers = _tree_map(SH.unbind, params["layers"])
    k_all, v_all = SH.local_value(cache["k"]), SH.local_value(cache["v"])
    for i in range(cfg.n_layers):
        p = _tree_map(lambda t: t[i], layers)
        x = _norm(cfg, p["ln1"], h)
        a = _attention_with_cache(cfg, p, x, positions, k_all[i], v_all[i],
                                  int(pos))
        h = h + a
        x2 = _norm(cfg, p["ln2"], h)
        if cfg.moe is None:
            h = h + L.mlp(p["mlp"], x2, act=cfg.act)
        else:
            y, _ = _moe_apply(cfg, p, x2.reshape(B, -1))
            h = h + y.reshape(B, 1, -1)
        h = constrain(h, (0, "fsdp"))
    return _logits(cfg, params, h[:, 0]), cache


def _attention_with_cache(cfg, p, x, positions, k_cache, v_cache, pos):
    """x: (B, S, d); ``k_cache``/``v_cache``: one layer's (B, Hkv, S_max,
    Dh) cache (on a mesh, this rank's shard of it)."""
    S = x.shape[1]
    if not 0 <= pos <= k_cache.shape[2] - S:
        raise ValueError(f"decode position {pos} outside a cache of "
                         f"{k_cache.shape[2]}")
    if SH.is_dtensor(x):
        return _attention_with_cache_sharded(cfg, p, x, k_cache, v_cache,
                                             pos)
    B = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x, positions)
    k_cache[:, :, pos:pos + S] = k.to(k_cache.dtype)
    v_cache[:, :, pos:pos + S] = v.to(v_cache.dtype)
    o = _masked_attention(q, k_cache, v_cache, pos + 1)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return L.dense(p["wo"], o)


def _attention_with_cache_sharded(cfg, p, x, k_cache, v_cache, pos):
    """``_attention_with_cache`` of a DTensor x (B, S, d) over this rank's
    cache shard, the cache laid out by ``lm_cache_specs`` (batch over the
    data axes and kv heads over ``"model"`` where they divide them): the
    projections are DTensor products, q laid out batch over the data
    axes and heads over ``"model"`` (where the heads divide it), k and v
    as the cache; each rank writes its k and v into its shard at ``pos``
    and attends its local query heads over the kv heads they read (its
    whole shard when the kv heads are split, else those
    ``_local_kv_heads`` picks, as ``_attention_sharded`` does).  Where
    the heads do not divide ``"model"``, each model rank attends its run
    of the (row, head) units (``_head_units``) over its rows of the
    cache, as ``_attention_sharded`` does."""
    mesh = x.device_mesh
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    nm = SH.axis_size(mesh, "model")
    batch = SH.fsdp_entry(mesh, B)
    split = nm > 1 and H % nm == 0
    kv_split = nm > 1 and Hkv % nm == 0
    q_pl = SH.placements(mesh, SH.P(batch, None, "model" if split else None))
    kv_pl = SH.placements(mesh, SH.P(batch, None,
                                     "model" if kv_split else None))
    q = L.dense(p["wq"], x).redistribute(mesh, q_pl).to_local()
    k = L.dense(p["wk"], x).redistribute(mesh, kv_pl).to_local()
    v = L.dense(p["wv"], x).redistribute(mesh, kv_pl).to_local()
    Bl = q.shape[0]
    Hl, Hkl = q.shape[2] // Dh, k.shape[2] // Dh
    units = None if split else _head_units(mesh, Bl, H)
    b0, nb, h0, nh = units or (
        0, Bl, SH.coordinate(mesh, "model") * Hl if split else 0, Hl)
    q = q.reshape(Bl, S, Hl, Dh)
    if units:
        q = q[b0:b0 + nb, :, h0:h0 + nh]
    k = k.reshape(Bl, S, Hkl, Dh)
    v = v.reshape(Bl, S, Hkl, Dh)
    if cfg.qk_norm:
        q = L.rmsnorm({"scale": SH.replicated_value(
            p["q_norm"]["scale"])}, q)
        k = L.rmsnorm({"scale": SH.replicated_value(
            p["k_norm"]["scale"])}, k)
    positions = torch.full((Bl, S), int(pos), device=q.device)
    q = L.apply_rope(q.transpose(1, 2), positions[:nb, None, :],
                     cfg.rope_theta)                    # (nb, nh, S, Dh)
    k = L.apply_rope(k.transpose(1, 2), positions[:, None, :],
                     cfg.rope_theta)
    k_cache[:, :, pos:pos + S] = k.to(k_cache.dtype)
    v_cache[:, :, pos:pos + S] = v.transpose(1, 2).to(v_cache.dtype)
    if units:
        k_cache, v_cache = k_cache[b0:b0 + nb], v_cache[b0:b0 + nb]
    if (split or units) and not kv_split:
        k_cache = _local_kv_heads(k_cache, h0, nh, H // Hkv)
        v_cache = _local_kv_heads(v_cache, h0, nh, H // Hkv)
    o = _masked_attention(q, k_cache, v_cache, pos + 1)
    if units:
        return L.dense(p["wo"], SH.from_local(
            _gather_units(o, mesh, Bl, H), mesh, q_pl))
    o = o.transpose(1, 2).reshape(Bl, S, Hl * Dh)
    return L.dense(p["wo"], SH.from_local(o, mesh, q_pl))
