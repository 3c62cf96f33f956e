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
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

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
    step's (k, v)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions)
    o = flash_attention(q, k, v, causal=True)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return L.dense(p["wo"], o), (k, v)


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

    up = torch.bmm(buf, p["experts"]["up"])
    if cfg.gated_mlp:
        h = L.activation(cfg.act, torch.bmm(buf, p["experts"]["gate"])) * up
    else:
        h = L.activation(cfg.act, up)
    del buf, up
    y = torch.bmm(h, p["experts"]["down"]).view(E * G * C, d)
    del h

    # ---- combine: each token's k choices in ascending expert order, a
    # dropped pair weighted 0 ----
    top_e, by_expert = torch.sort(top_e, dim=-1)
    rank = rank.view(G, n, k).gather(-1, by_expert)
    w = top_p.gather(-1, by_expert).masked_fill(rank >= C, 0).to(x.dtype)
    slot = ((top_e * G + group[:, None, None]) * C + rank).clamp(
        max=E * G * C - 1)
    return (y[slot] * w[..., None]).sum(-2), aux


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _block(cfg: TransformerConfig, p, h, positions):
    """One layer: (h, the MoE FFN's aux loss, or None for a dense FFN)."""
    a, _ = _attention(cfg, p, L.norm_apply(cfg.norm, p["ln1"], h), positions)
    h = h + a
    x = L.norm_apply(cfg.norm, p["ln2"], h)
    if cfg.moe is None:
        return h + L.mlp(p["mlp"], x, act=cfg.act), None
    B, S, d = x.shape
    y, aux = _moe_apply(cfg, p, x.reshape(B * S, d))
    return h + y.reshape(B, S, d), aux


def _logits(cfg: TransformerConfig, params, h):
    h = L.norm_apply(cfg.norm, params["final_norm"], h)
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
    h = params["embed"]["table"][tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    # the stacked leaves cut into their layers once: under autograd each
    # leaf's gradient is then one stack of the layers' (a slice per layer
    # would add a zero-filled leaf-sized gradient per layer)
    layers = _tree_map(lambda t: t.unbind(0), params["layers"])
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.n_layers):
        h, a = _run_block(cfg, _tree_map(lambda t: t[i], layers), h,
                          positions)
        if a is not None:
            aux = aux + a
    return _logits(cfg, params, h), aux


def lm_loss(cfg: TransformerConfig, params, batch):
    """batch: {tokens (B, S), targets (B, S)} -> scalar loss: the cross
    entropy of the (B, S, V) logits against the targets, plus the aux
    loss."""
    logits, aux = forward(cfg, params, batch["tokens"])
    return L.cross_entropy_loss(logits, batch["targets"]) + aux


# ---------------------------------------------------------------------------
# decode (serving) path
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device="cpu") -> dict:
    dt = dtype or cfg.param_dtype
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_step(cfg: TransformerConfig, params, cache, tokens, pos: int):
    """One decode step.  tokens: (B, 1); pos: the current length.  Writes
    this step's keys and values into ``cache`` at ``pos`` (in place) and
    returns (logits (B, vocab), cache).  An MoE FFN routes the step's
    N = B tokens as the reference does (in groups when the dispatch groups
    divide B; the aux loss is dropped)."""
    B = tokens.shape[0]
    h = params["embed"]["table"][tokens]            # (B, 1, d)
    positions = torch.full((B, 1), int(pos), device=tokens.device)
    for i in range(cfg.n_layers):
        p = layer_params(params, i)
        x = L.norm_apply(cfg.norm, p["ln1"], h)
        a = _attention_with_cache(cfg, p, x, positions, cache["k"][i],
                                  cache["v"][i], int(pos))
        h = h + a
        x2 = L.norm_apply(cfg.norm, p["ln2"], h)
        if cfg.moe is None:
            h = h + L.mlp(p["mlp"], x2, act=cfg.act)
        else:
            y, _ = _moe_apply(cfg, p, x2.reshape(B, -1))
            h = h + y.reshape(B, 1, -1)
    return _logits(cfg, params, h[:, 0]), cache


def _attention_with_cache(cfg, p, x, positions, k_cache, v_cache, pos):
    B, S, _ = x.shape
    if not 0 <= pos <= k_cache.shape[2] - S:
        raise ValueError(f"decode position {pos} outside a cache of "
                         f"{k_cache.shape[2]}")
    q, k, v = _project_qkv(cfg, p, x, positions)
    k_cache[:, :, pos:pos + S] = k.to(k_cache.dtype)
    v_cache[:, :, pos:pos + S] = v.to(v_cache.dtype)
    o = _masked_attention(q, k_cache, v_cache, pos + 1)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return L.dense(p["wo"], o)
