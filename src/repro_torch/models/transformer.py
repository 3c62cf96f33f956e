"""Decoder-only LM transformer (GQA + RoPE attention, dense FFN), the port's
counterpart of ``repro.models.transformer``.

Covers the reference's three dense architectures through its config
surface: starcoder2-3b (LayerNorm + tanh-GELU, all biases, tied
embeddings), minitron-8b (squared-ReLU, no bias) and qwen1.5-110b (QKV bias,
SwiGLU).  The MoE FFN (``cfg.moe``; qwen2-moe-a2.7b, olmoe-1b-7b) is not
ported: ``init_params`` and ``forward`` raise ``NotImplementedError``.

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

_MOE = ("the MoE FFN is not ported to repro_torch yet: see ROADMAP.md "
        "Queue 1 item 12 (MoE dispatch)")


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
    p["mlp"] = L.mlp_init(generator, d, cfg.d_ff, gated=cfg.gated_mlp,
                          bias=cfg.mlp_bias, dtype=dt)
    return p


def init_params(cfg: TransformerConfig, generator: torch.Generator) -> dict:
    """Random parameters drawn from ``generator``, on its device, with the
    reference's distributions (not its numbers).  The layers are drawn one
    at a time into tensors stacked on a leading L axis."""
    if cfg.moe:
        raise NotImplementedError(_MOE)
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
# forward passes
# ---------------------------------------------------------------------------

def _block(cfg: TransformerConfig, p, h, positions):
    a, _ = _attention(cfg, p, L.norm_apply(cfg.norm, p["ln1"], h), positions)
    h = h + a
    x = L.norm_apply(cfg.norm, p["ln2"], h)
    return h + L.mlp(p["mlp"], x, act=cfg.act)


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
    """tokens: (B, S) -> logits (B, S, vocab), aux loss (a float32 zero:
    only the MoE FFN has one)."""
    if cfg.moe:
        raise NotImplementedError(_MOE)
    B, S = tokens.shape
    h = params["embed"]["table"][tokens]
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    # the stacked leaves cut into their layers once: under autograd each
    # leaf's gradient is then one stack of the layers' (a slice per layer
    # would add a zero-filled leaf-sized gradient per layer)
    layers = _tree_map(lambda t: t.unbind(0), params["layers"])
    for i in range(cfg.n_layers):
        h = _run_block(cfg, _tree_map(lambda t: t[i], layers), h, positions)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
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
    returns (logits (B, vocab), cache)."""
    if cfg.moe:
        raise NotImplementedError(_MOE)
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
        h = h + L.mlp(p["mlp"], x2, act=cfg.act)
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
