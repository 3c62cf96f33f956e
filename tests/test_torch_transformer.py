"""The port's dense LM (layers, forward, decode, serving) against the
reference's.

``torch.Generator`` cannot reproduce ``jax.random``, so every parity case
carries the reference's ``init_params`` weights into the port with
``params_from_reference`` and feeds both the same numpy tokens.  Tolerances:
atol 1e-5 on float32 logits and layer outputs (the two frameworks' matmuls,
transcendentals and RoPE angles round differently; measured differences
are ~1e-6); the generated tokens and carried bf16 weights must be equal.
Cases run on the three dense smoke configurations, plus starcoder2-3b's
with ``qk_norm=True``.  The CPU runs no kernel: the prefill forward's
attention is the plain ``gqa_attention`` here (``gpu`` cases and
``chip_smoke.py`` hold the CUDA kernel to it on the card).
"""
import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as r_serve
import repro.models.layers as RL
from repro.configs import get_arch as r_get_arch
from repro.configs.base import LM_SHAPES as R_LM_SHAPES
from repro.launch import steps as RS
from repro.models import transformer as RT
import repro_torch.launch.serve as serve
from repro_torch.configs import get_arch
from repro_torch.configs.base import LM_SHAPES
from repro_torch.kernels.flash_attention import launches
from repro_torch.launch import steps as S
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ATOL = 1e-5
DENSE = ["starcoder2-3b", "minitron-8b", "qwen1.5-110b"]
VARIANTS = DENSE + ["starcoder2-3b+qk_norm"]


def _ref_fields(r_cfg) -> dict:
    """The reference config's fields that the port's config has: all but
    ``unroll_layers`` (the port always loops over the layers)."""
    fields = dataclasses.asdict(r_cfg)
    del fields["unroll_layers"]
    return fields


def _port_cfg(cfg):
    return T.TransformerConfig(**_ref_fields(cfg))


def _configs(name):
    arch, _, variant = name.partition("+")
    cfg = r_get_arch(arch).make_smoke_config()
    if variant == "qk_norm":
        cfg = dataclasses.replace(cfg, qk_norm=True)
    return cfg, _port_cfg(cfg)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=VARIANTS)
def model(request):
    """(ref cfg, port cfg, ref params, port params, numpy tokens (3, 11))."""
    cfg, pcfg = _configs(request.param)
    r_params = RT.init_params(cfg, jax.random.key(0))
    params = T.params_from_reference(_np_tree(r_params))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (3, 11))
    return cfg, pcfg, r_params, params, tokens.astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    x = _x((3, 5, 24), seed=1, scale=3.0) + 0.5
    scale = _x((24,), seed=2) + 1.0
    r_p = {"scale": jnp.asarray(scale)}
    p = {"scale": torch.from_numpy(scale)}
    if kind == "layernorm":
        bias = _x((24,), seed=3)
        r_p["bias"], p["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    _close(L.norm_apply(kind, p, torch.from_numpy(x)),
           RL.norm_apply(kind, r_p, jnp.asarray(x)))
    init = L.norm_init(kind, 24)
    r_init = RL.norm_init(kind, 24)
    assert set(init) == set(r_init)
    for k in init:
        _close(init[k], r_init[k], atol=0)


def test_norms_keep_bf16_and_compute_in_float32():
    x = _x((4, 64), seed=4, scale=5.0)
    xb = torch.from_numpy(x).bfloat16()
    for kind in ("rmsnorm", "layernorm"):
        p = {k: v.bfloat16() for k, v in L.norm_init(kind, 64).items()}
        got = L.norm_apply(kind, p, xb)
        assert got.dtype == torch.bfloat16
        r_p = {k: jnp.asarray(v, jnp.bfloat16)
               for k, v in RL.norm_init(kind, 64).items()}
        want = RL.norm_apply(kind, r_p, jnp.asarray(x, jnp.bfloat16))
        _close(got, want, atol=2e-2)


@pytest.mark.parametrize("kind", ["gelu", "silu", "relu", "relu2"])
def test_activations_match_reference(kind):
    x = _x((7, 33), seed=6, scale=3.0)
    _close(L.activation(kind, torch.from_numpy(x)),
           RL.activation(kind, jnp.asarray(x)))


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    exact = torch.nn.functional.gelu(x)
    assert float((L.activation("gelu", x) - exact).abs().max()) > 1e-4
    _close(L.activation("gelu", x), jax.nn.gelu(jnp.asarray(x.numpy()),
                                                approximate=True))


@pytest.mark.parametrize("theta", [1e4, 1e5, 1e6])
def test_rope_matches_reference(theta):
    x = _x((2, 4, 9, 16), seed=7)
    pos = np.broadcast_to(np.arange(3, 12), (2, 9)).astype(np.int32)
    got = L.apply_rope(torch.from_numpy(x),
                       torch.from_numpy(pos.copy())[:, None, :], theta)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos)[:, None, :], theta)
    _close(got, want)
    _close(L.rope_frequencies(16, theta), RL.rope_frequencies(16, theta))


@pytest.mark.parametrize("gated,act,bias", [(True, "silu", False),
                                            (False, "gelu", True),
                                            (False, "relu2", False)])
def test_mlp_matches_reference(gated, act, bias):
    r_p = RL.mlp_init(jax.random.key(3), 24, 40, gated=gated, bias=bias)
    if bias:      # the reference initialises biases at zero: make them count
        r_p = jax.tree.map(lambda a: a + 0.1 if a.ndim == 1 else a, r_p)
    p = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a).copy()), r_p)
    x = _x((2, 5, 24), seed=8)
    _close(L.mlp(p, torch.from_numpy(x), act=act),
           RL.mlp(r_p, jnp.asarray(x), act=act))
    mine = L.mlp_init(torch.Generator().manual_seed(0), 24, 40, gated=gated,
                      bias=bias)
    assert jax.tree.map(lambda t: tuple(t.shape), mine) == jax.tree.map(
        lambda a: a.shape, r_p)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_configs_are_the_references(arch):
    spec, r_spec = get_arch(arch), r_get_arch(arch)
    assert spec.family == r_spec.family == "lm"
    assert spec.shapes == r_spec.shapes
    for make in ("make_config", "make_smoke_config"):
        cfg, r_cfg = getattr(spec, make)(), getattr(r_spec, make)()
        assert dataclasses.asdict(cfg) == _ref_fields(r_cfg)
        assert cfg.head_dim == r_cfg.head_dim
        assert cfg.num_params() == r_cfg.num_params()
        assert cfg.num_active_params() == r_cfg.num_active_params()
        assert cfg.param_dtype == getattr(torch, cfg.dtype)
    assert LM_SHAPES == R_LM_SHAPES


def test_starcoder2_3b_size():
    cfg = get_arch("starcoder2-3b").make_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (30, 3072, 24, 2, 128,
                                                    12288, 49152)
    assert 3.0e9 < cfg.num_params() < 3.1e9
    assert cfg.param_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "olmoe-1b-7b"])
def test_moe_archs_raise(arch):
    """The MoE architectures resolve (they raised before their port) to
    the reference's configs, dataclass for dataclass, with its shapes
    (train_4k in 8 microbatches)."""
    spec, r_spec = get_arch(arch), r_get_arch(arch)
    assert spec.family == r_spec.family == "lm"
    assert spec.shapes == r_spec.shapes
    assert spec.shapes["train_4k"]["microbatches"] == 8
    for make in ("make_config", "make_smoke_config"):
        cfg, r_cfg = getattr(spec, make)(), getattr(r_spec, make)()
        assert isinstance(cfg.moe, T.MoEConfig)
        assert dataclasses.asdict(cfg) == _ref_fields(r_cfg)
        assert cfg.num_params() == r_cfg.num_params()
        assert cfg.num_active_params() == r_cfg.num_active_params()


def test_moe_config_raises_in_init_and_forward():
    """An MoE config (olmoe's smoke one, rebuilt from the reference's
    fields) initialises and runs forward (both raised before the MoE FFN
    was ported): finite logits and a positive aux loss."""
    r_cfg = r_get_arch("olmoe-1b-7b").make_smoke_config()
    cfg = T.TransformerConfig(**{**_ref_fields(r_cfg),
                                 "moe": T.MoEConfig(**dataclasses.asdict(
                                     r_cfg.moe))})
    assert cfg.num_params() == r_cfg.num_params()
    assert cfg.num_active_params() == r_cfg.num_active_params()
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    logits, aux = T.forward(cfg, params, torch.zeros((1, 2),
                                                     dtype=torch.long))
    assert logits.shape == (1, 2, cfg.vocab)
    assert bool(torch.isfinite(logits).all()) and float(aux) > 0


@pytest.mark.parametrize("name", VARIANTS)
def test_init_params_has_the_reference_tree(name):
    cfg, pcfg = _configs(name)
    r_shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            RT.init_params(cfg, jax.random.key(0)))
    p = T.init_params(pcfg, torch.Generator().manual_seed(0))
    p_shapes = jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), p)
    assert p_shapes == r_shapes


def test_init_params_draws_each_layer():
    """The stacked layers differ from each other (one draw per layer) and
    follow the reference's scales."""
    cfg = _port_cfg(r_get_arch("starcoder2-3b").make_smoke_config())
    p = T.init_params(cfg, torch.Generator().manual_seed(1))
    wq = p["layers"]["wq"]["w"]
    assert not torch.equal(wq[0], wq[1])
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.03
    assert abs(float(p["embed"]["table"].std()) - 0.02) < 0.002
    assert torch.equal(p["layers"]["wq"]["b"], torch.zeros_like(
        p["layers"]["wq"]["b"]))


def test_params_from_reference_carries_every_leaf(model):
    _, _, r_params, params, _ = model
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(r_params)}
    got = {jax.tree_util.keystr(k): v for k, v in
           jax.tree_util.tree_leaves_with_path(params)}
    assert set(got) == set(flat)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), flat[k])


def test_bf16_carry_over_round_trips():
    """A bf16 tree (``ml_dtypes.bfloat16`` numpy arrays) carries over bit
    for bit, and back."""
    cfg = dataclasses.replace(r_get_arch("starcoder2-3b").make_smoke_config(),
                              dtype="bfloat16")
    r_params = _np_tree(RT.init_params(cfg, jax.random.key(2)))
    params = T.params_from_reference(r_params)
    for (path, a), t in zip(jax.tree_util.tree_leaves_with_path(r_params),
                            jax.tree_util.tree_leaves(params)):
        assert t.dtype == torch.bfloat16, path
        back = t.view(torch.int16).numpy().view(a.dtype)
        assert back.tobytes() == a.tobytes(), path


def test_params_from_reference_refuses_another_tree():
    with pytest.raises(ValueError, match="not a transformer parameter tree"):
        T.params_from_reference({"w": np.zeros(3)})


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

def test_forward_matches_reference(model):
    cfg, pcfg, r_params, params, tokens = model
    r_logits, r_aux = jax.jit(lambda p, t: RT.forward(cfg, p, t))(
        r_params, jnp.asarray(tokens))
    launches.reset()
    logits, aux = T.forward(pcfg, params, torch.from_numpy(tokens))
    assert launches.count == 0                 # the CPU runs no kernel
    assert logits.shape == (3, 11, cfg.vocab)
    _close(logits, r_logits)
    assert float(aux) == float(r_aux) == 0.0


def test_prefill_step_matches_reference(model):
    cfg, pcfg, r_params, params, tokens = model
    want = jax.jit(RS.make_lm_prefill_step(cfg))(
        r_params, {"tokens": jnp.asarray(tokens)})
    got = S.make_lm_prefill_step(pcfg)(params,
                                       {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (3, cfg.vocab) and not got.requires_grad
    _close(got, want)


def test_decode_steps_match_reference(model):
    """Four decode steps from a fresh cache: logits and the whole updated
    cache after each."""
    cfg, pcfg, r_params, params, tokens = model
    r_step = jax.jit(RS.make_lm_decode_step(cfg))
    step = S.make_lm_decode_step(pcfg)
    r_cache = RT.init_cache(cfg, 3, 6)
    cache = T.init_cache(pcfg, 3, 6)
    for pos in range(4):
        tok = tokens[:, pos:pos + 1]
        r_logits, r_cache = r_step(r_params, {"cache": r_cache,
                                              "tokens": jnp.asarray(tok),
                                              "pos": jnp.int32(pos)})
        logits, cache = step(params, {"cache": cache,
                                      "tokens": torch.from_numpy(tok),
                                      "pos": pos})
        assert logits.shape == (3, cfg.vocab)
        _close(logits, r_logits)
        for k in ("k", "v"):
            _close(cache[k], r_cache[k])


def test_decode_matches_forward():
    """Decoding a prompt token by token gives the forward's logits at
    every position (the cache path and the causal path agree)."""
    cfg, pcfg = _configs("qwen1.5-110b")
    params = T.init_params(pcfg, torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 7)))
    full, _ = T.forward(pcfg, params, tokens)
    cache = T.init_cache(pcfg, 2, 7)
    for pos in range(7):
        logits, cache = T.decode_step(pcfg, params, cache,
                                      tokens[:, pos:pos + 1], pos)
        _close(logits, full[:, pos].numpy())


def test_decode_refuses_a_position_past_the_cache():
    cfg, pcfg = _configs("minitron-8b")
    params = T.init_params(pcfg, torch.Generator().manual_seed(0))
    cache = T.init_cache(pcfg, 1, 3)
    with pytest.raises(ValueError, match="outside a cache"):
        T.decode_step(pcfg, params, cache, torch.zeros((1, 1),
                                                       dtype=torch.long), 3)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _report(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _carry_reference_weights(monkeypatch):
    """The port's ``init_params`` returns the reference's weights for the
    same seed (``serve_lm`` seeds its generator with ``seed``)."""
    def carried(cfg, generator):
        r_cfg = r_get_arch(_ARCH_BY_NAME[cfg.name]).make_smoke_config()
        seed = generator.initial_seed()
        return T.params_from_reference(
            _np_tree(RT.init_params(r_cfg, jax.random.key(seed))),
            generator.device)
    monkeypatch.setattr(T, "init_params", carried)


_ARCH_BY_NAME = {r_get_arch(a).make_smoke_config().name: a for a in DENSE}


@pytest.mark.parametrize("arch", DENSE)
def test_serve_lm_generates_the_references_tokens(arch, monkeypatch):
    _carry_reference_weights(monkeypatch)
    want, r_report = r_serve.serve_lm(arch, n_requests=3, max_new=6, seed=4)
    got, report = serve.serve_lm(arch, n_requests=3, max_new=6, seed=4,
                                 device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert set(report) == set(r_report)
    assert {k: report[k] for k in ("arch", "mode", "requests",
                                   "generated_tokens")} == {
        k: r_report[k] for k in ("arch", "mode", "requests",
                                 "generated_tokens")}


def test_serve_main_report_keys_match_reference(monkeypatch):
    _carry_reference_weights(monkeypatch)
    argv = ["--arch", "starcoder2-3b", "--requests", "2", "--max-new", "5",
            "--json"]
    want = _report(r_serve.main, argv)
    launches.reset()
    got = _report(serve.main, argv + ["--device", "cpu"])
    assert launches.count == 0
    assert set(got) == set(want) == {"arch", "mode", "requests",
                                     "generated_tokens", "decode_s",
                                     "tokens_per_s"}
    assert got["generated_tokens"] == want["generated_tokens"] == 10
    assert got["mode"] == "lm" and got["tokens_per_s"] > 0


def test_serve_cli_defaults_to_starcoder2_3b():
    report = _report(serve.main, ["--requests", "2", "--max-new", "3",
                                  "--device", "cpu", "--json"])
    assert report["arch"] == "starcoder2-3b"
    assert report["generated_tokens"] == 6


def test_serve_lm_sampling_is_seeded():
    a, _ = serve.serve_lm("minitron-8b", n_requests=2, max_new=5, seed=1,
                          greedy=False, device="cpu")
    b, _ = serve.serve_lm("minitron-8b", n_requests=2, max_new=5, seed=1,
                          greedy=False, device="cpu")
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 5) and a.min() >= 0 and a.max() < 256


def test_serve_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this case checks the behaviour without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "starcoder2-3b", "--requests", "2"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", VARIANTS)
def test_forward_card_matches_cpu(name):
    """The forward on the card (one kernel launch per layer) against the
    same weights on the CPU, float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg, pcfg = _configs(name)
    params = T.init_params(pcfg, torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, cfg.vocab, (2, 70)))
    cpu, _ = T.forward(pcfg, params, tokens)
    launches.reset()
    card, _ = T.forward(pcfg, T.params_to(params, "cuda"), tokens.cuda())
    torch.cuda.synchronize()
    assert launches.count == cfg.n_layers
    _close(card.cpu(), cpu.numpy(), atol=1e-4)
