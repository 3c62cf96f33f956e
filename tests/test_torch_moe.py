"""The port's MoE FFN (olmoe-1b-7b, qwen2-moe-a2.7b) against the reference's,
on the CPU.

The reference's weights are carried over with ``params_from_reference``
and both packages get the same numpy inputs.  Tolerances: the MoE layer's
output and the whole model's float32 logits within 1e-5, the aux loss
within 1e-6, the loss within 1e-5 relative, every gradient leaf within 1e-4
of its largest magnitude (floored at 1e-2 of the tree's largest, as
``tests/test_torch_training.py`` holds the dense LMs); the chosen experts,
the dropped rows, the generated tokens and carried bf16 weights equal.
The layer runs on both smoke configs with dispatch groups 1 and 4 (a
token count divisible by 4 and one that is not), capacity factors 0.05
(most pairs dropped), 1.25 and 8 (none dropped), and a zero router (every
probability tied).
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
from repro.configs import get_arch as r_get_arch
from repro.data.lm_data import TokenStream
from repro.launch import steps as RS
from repro.models import transformer as RT
import repro_torch.launch.serve as serve
import repro_torch.launch.train as train
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import launches
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import tree_leaves

MOE = ["olmoe-1b-7b", "qwen2-moe-a2.7b"]
ATOL, AUX_ATOL, LOSS_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-5, 1e-4


def _configs(arch, **moe):
    """(reference config, port config) of ``arch``'s smoke size, with the
    MoE fields in ``moe`` replaced in both."""
    r_cfg = r_get_arch(arch).make_smoke_config()
    cfg = get_arch(arch).make_smoke_config()
    return (dataclasses.replace(r_cfg, moe=dataclasses.replace(r_cfg.moe,
                                                                **moe)),
            dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                              **moe)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _layer(r_params, zero_router=False):
    """Layer 0 of the reference's parameters, and the port's copy."""
    lp = jax.tree.map(lambda a: a[0], r_params["layers"])
    if zero_router:
        lp["router"]["w"] = jnp.zeros_like(lp["router"]["w"])
    return lp, T.params_from_reference({"embed": {}, "layers": _np_tree(lp),
                                        "final_norm": {}})["layers"]


def _x(n, d, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _leaves_close(got, want, tol, what=""):
    g_leaves = tree_leaves(got)
    w_leaves = [np.asarray(w, np.float32) for w in jax.tree.leaves(want)]
    assert len(g_leaves) == len(w_leaves), what
    top = max(float(np.abs(w).max()) for w in w_leaves)
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        g = g.detach().float().numpy()
        assert g.shape == w.shape, f"{what} leaf {i}"
        scale = max(float(np.abs(w).max()), 1e-2 * top)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{what} leaf {i}: {err} > {tol} * {scale}"


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_full_size_params_match_reference(arch):
    cfg, r_cfg = get_arch(arch).make_config(), r_get_arch(arch).make_config()
    assert cfg.num_params() == r_cfg.num_params()
    assert cfg.num_active_params() == r_cfg.num_active_params()
    assert cfg.param_dtype == torch.bfloat16


def test_full_size_param_counts():
    """The sizes the serving card holds (bf16, two bytes a parameter)."""
    assert get_arch("olmoe-1b-7b").make_config().num_params() \
        == 6_919_028_736
    assert get_arch("qwen2-moe-a2.7b").make_config().num_params() \
        == 14_315_487_232


@pytest.mark.parametrize("arch", MOE)
def test_init_params_has_the_reference_tree(arch):
    r_cfg, cfg = _configs(arch)
    r_shapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            RT.init_params(r_cfg, jax.random.key(0)))
    p = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).replace("torch.", "")),
                        p) == r_shapes


@pytest.mark.parametrize("arch", MOE)
def test_init_params_follow_the_reference_scales(arch):
    """The router and the experts drawn with the reference's scales: each
    leaf's standard deviation within 10% of 1/sqrt(fan-in)."""
    _, cfg = _configs(arch)
    lp = T.init_params(cfg, torch.Generator().manual_seed(1))["layers"]
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    for leaf, fan_in in ((lp["router"]["w"], d), (lp["experts"]["up"], d),
                         (lp["experts"]["gate"], d),
                         (lp["experts"]["down"], f)):
        assert abs(float(leaf.std()) * np.sqrt(fan_in) - 1) < 0.1
    assert not torch.equal(lp["experts"]["up"][0], lp["experts"]["up"][1])
    assert ("shared" in lp) == bool(cfg.moe.num_shared)


@pytest.mark.parametrize("arch", MOE)
def test_bf16_moe_leaves_carry_over_bit_for_bit(arch):
    r_cfg, cfg = _configs(arch)
    r_cfg = dataclasses.replace(r_cfg, dtype="bfloat16")
    r_params = _np_tree(RT.init_params(r_cfg, jax.random.key(2)))
    params = T.params_from_reference(r_params)
    assert {"router", "experts"} <= set(params["layers"])
    for (path, a), t in zip(jax.tree_util.tree_leaves_with_path(r_params),
                            jax.tree_util.tree_leaves(params)):
        assert t.dtype == torch.bfloat16, path
        back = t.view(torch.int16).numpy().view(a.dtype)
        assert back.tobytes() == a.tobytes(), path


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_router", [False, True],
                         ids=["router", "zero-router"])
@pytest.mark.parametrize("capacity_factor", [0.05, 1.25, 8.0])
@pytest.mark.parametrize("groups,n", [(1, 24), (4, 24), (4, 22)])
@pytest.mark.parametrize("arch", MOE)
def test_moe_apply_matches_reference(arch, groups, n, capacity_factor,
                                     zero_router):
    r_cfg, cfg = _configs(arch, dispatch_groups=groups,
                          capacity_factor=capacity_factor)
    r_lp, lp = _layer(RT.init_params(r_cfg, jax.random.key(0)), zero_router)
    x = _x(n, cfg.d_model)
    r_out, r_aux = jax.jit(lambda p, x: RT._moe_apply(r_cfg, p, x))(
        r_lp, jnp.asarray(x))
    out, aux = T._moe_apply(cfg, lp, torch.from_numpy(x))
    assert out.shape == (n, cfg.d_model) and out.dtype == torch.float32
    assert aux.dtype == torch.float32
    _close(out, r_out)
    assert abs(float(aux) - float(r_aux)) <= AUX_ATOL


@pytest.mark.parametrize("arch", MOE)
def test_zero_router_picks_the_lowest_experts_and_drops_alike(arch):
    """Every probability tied: experts 0..k-1 for every token, as
    ``jax.lax.top_k`` picks; 6 tokens at C = 2 leave the same 4 rows
    without a routed output."""
    r_cfg, cfg = _configs(arch)
    r_lp, lp = _layer(RT.init_params(r_cfg, jax.random.key(0)),
                      zero_router=True)
    x = _x(6, cfg.d_model, seed=3)
    _, top_p, top_e = T.moe_route(cfg, lp, torch.from_numpy(x))
    k = cfg.moe.top_k
    assert torch.equal(top_e, torch.arange(k).expand(6, k))
    np.testing.assert_array_equal(top_p.numpy(), np.full((6, k), 1 / k,
                                                         np.float32))
    assert T.moe_capacity(cfg.moe, 6) == 2
    r_out, _ = RT._moe_dispatch(r_cfg, r_lp, jnp.asarray(x))
    out, _ = T._moe_dispatch(cfg, lp, torch.from_numpy(x)[None])
    empty = (out[0] == 0).all(-1).numpy()
    np.testing.assert_array_equal(empty,
                                  (np.asarray(r_out) == 0).all(-1))
    assert empty.tolist() == [False, False, True, True, True, True]
    _close(out[0], r_out)


@pytest.mark.parametrize("arch", MOE)
def test_top_k_ties_go_to_the_lower_expert(arch):
    """Router columns repeated so that pairs of experts tie exactly: the
    port picks the experts ``jax.lax.top_k`` picks."""
    r_cfg, cfg = _configs(arch)
    r_lp, lp = _layer(RT.init_params(r_cfg, jax.random.key(4)))
    w = np.asarray(r_lp["router"]["w"]).copy()
    w[:, 1::2] = w[:, 0::2]                 # experts 2i and 2i+1 tie
    x = _x(32, cfg.d_model, seed=5)
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), axis=-1)
    _, r_top_e = jax.lax.top_k(probs, cfg.moe.top_k)
    lp["router"]["w"] = torch.from_numpy(w)
    _, _, top_e = T.moe_route(cfg, lp, torch.from_numpy(x))
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(r_top_e))
    assert (top_e[:, 0] % 2 == 0).all()     # the lower of each tied pair


@pytest.mark.parametrize("arch,tokens,groups,capacity", [
    ("olmoe-1b-7b", 4, 1, 1), ("olmoe-1b-7b", 128, 32, 1),
    ("olmoe-1b-7b", 500, 1, 79), ("olmoe-1b-7b", 512, 32, 3),
    ("olmoe-1b-7b", 1024, 32, 5), ("olmoe-1b-7b", 32768, 32, 160),
    ("qwen2-moe-a2.7b", 4, 1, 1), ("qwen2-moe-a2.7b", 1024, 32, 3),
    ("qwen2-moe-a2.7b", 32768, 32, 86)])
def test_groups_and_capacity_at_full_size(arch, tokens, groups, capacity):
    """The reference's rule: G groups only when G divides the token count;
    C = ceil(n k / E cf) for a group of n tokens, in that order."""
    m = get_arch(arch).make_config().moe
    G = T._moe_groups(m, tokens)
    assert G == groups
    n = tokens // G
    assert T.moe_capacity(m, n) == capacity == int(
        np.ceil(n * m.top_k / m.num_experts * m.capacity_factor))


@pytest.mark.parametrize("arch", MOE)
def test_grouped_dispatch_is_independent_groups(arch):
    """G groups routed at once equal G separate global dispatches, the aux
    their mean."""
    _, cfg = _configs(arch, dispatch_groups=4)
    lp = T.layer_params(
        T.init_params(cfg, torch.Generator().manual_seed(6)), 0)
    x = torch.from_numpy(_x(4 * 9, cfg.d_model, seed=7))
    out, aux = T._moe_dispatch(cfg, lp, x.view(4, 9, -1))
    for g in range(4):
        o, a = T._moe_dispatch(cfg, lp, x.view(4, 9, -1)[g:g + 1])
        torch.testing.assert_close(out[g], o[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(aux[g], a[0], rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, g) for a in MOE for g in (1, 4)],
                ids=lambda p: f"{p[0]}-G{p[1]}")
def model(request):
    """(ref cfg, port cfg, ref params, port params, numpy tokens (3, 8)):
    24 tokens, so G = 4 takes the grouped route in the forward."""
    arch, groups = request.param
    r_cfg, cfg = _configs(arch, dispatch_groups=groups)
    r_params = RT.init_params(r_cfg, jax.random.key(0))
    params = T.params_from_reference(_np_tree(r_params))
    tokens = np.random.default_rng(5).integers(0, r_cfg.vocab, (3, 8))
    return r_cfg, cfg, r_params, params, tokens.astype(np.int32)


def test_forward_matches_reference(model):
    r_cfg, cfg, r_params, params, tokens = model
    r_logits, r_aux = jax.jit(lambda p, t: RT.forward(r_cfg, p, t))(
        r_params, jnp.asarray(tokens))
    launches.reset()
    logits, aux = T.forward(cfg, params, torch.from_numpy(tokens))
    assert launches.count == 0                 # the CPU runs no kernel
    assert logits.shape == (3, 8, r_cfg.vocab)
    _close(logits, r_logits)
    assert float(aux) > 0
    assert abs(float(aux) - float(r_aux)) <= AUX_ATOL


def test_prefill_step_matches_reference(model):
    r_cfg, cfg, r_params, params, tokens = model
    want = jax.jit(RS.make_lm_prefill_step(r_cfg))(
        r_params, {"tokens": jnp.asarray(tokens)})
    got = S.make_lm_prefill_step(cfg)(params,
                                      {"tokens": torch.from_numpy(tokens)})
    _close(got, want)


def test_loss_and_gradients_match_reference(model):
    """``lm_loss`` (cross entropy plus the summed aux) and its gradients
    against ``jax.value_and_grad`` of the reference's."""
    r_cfg, cfg, r_params, params, tokens = model
    batch = {"tokens": tokens,
             "targets": np.roll(tokens, -1, axis=1).astype(np.int32)}
    r_val, r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: RT.lm_loss(r_cfg, p, b)))(
        r_params, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    val = T.lm_loss(cfg, params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(val, leaves)
    np.testing.assert_allclose(float(val.detach()), float(r_val),
                               rtol=LOSS_RTOL)
    _leaves_close(grads, r_grads, GRAD_TOL, f"{cfg.name} gradients")
    for p in leaves:
        p.requires_grad_(False)


def test_decode_steps_match_reference(model):
    """Three decode steps from a fresh cache (N = 3 tokens a step: the
    global route at C = 1): logits and the updated cache after each."""
    r_cfg, cfg, r_params, params, tokens = model
    r_step = jax.jit(RS.make_lm_decode_step(r_cfg))
    step = S.make_lm_decode_step(cfg)
    r_cache, cache = RT.init_cache(r_cfg, 3, 5), T.init_cache(cfg, 3, 5)
    for pos in range(3):
        tok = tokens[:, pos:pos + 1]
        r_logits, r_cache = r_step(r_params, {"cache": r_cache,
                                              "tokens": jnp.asarray(tok),
                                              "pos": jnp.int32(pos)})
        logits, cache = step(params, {"cache": cache,
                                      "tokens": torch.from_numpy(tok),
                                      "pos": pos})
        _close(logits, r_logits)
        for k in ("k", "v"):
            _close(cache[k], r_cache[k])


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward(arch, groups):
    """With capacity_factor 8 nothing drops, so decode (N = B) and the
    forward (N = B S, grouped at G = 4) route alike: decoding token by
    token gives the forward's logits at every position."""
    _, cfg = _configs(arch, dispatch_groups=groups, capacity_factor=8.0)
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (2, 10)))
    full, _ = T.forward(cfg, params, tokens)
    cache = T.init_cache(cfg, 2, 10)
    for pos in range(10):
        logits, cache = T.decode_step(cfg, params, cache,
                                      tokens[:, pos:pos + 1], pos)
        _close(logits, full[:, pos].numpy())


@pytest.mark.parametrize("arch", MOE)
def test_train_step_loss_includes_the_aux(arch):
    """One AdamW step of ``make_lm_train_step`` reports the reference's
    loss (cross entropy plus the aux) from the same state and batch."""
    r_cfg, cfg = _configs(arch)
    r_params = RT.init_params(r_cfg, jax.random.key(0))
    batch = TokenStream(r_cfg.vocab, 4, 16, seed=1).next_batch()
    r_state = {"params": r_params,
               "opt": {"m": jax.tree.map(jnp.zeros_like, r_params),
                       "v": jax.tree.map(jnp.zeros_like, r_params),
                       "step": jnp.int32(0)}}
    _, r_m = jax.jit(RS.make_lm_train_step(r_cfg))(
        r_state, {k: jnp.asarray(v) for k, v in batch.items()})
    state = S.state_from_reference("lm", _np_tree(r_state))
    tb = {k: torch.from_numpy(np.asarray(v).copy())
          for k, v in batch.items()}
    _, aux = T.forward(cfg, state["params"], tb["tokens"])
    state, m = S.make_lm_train_step(cfg)(state, tb)
    np.testing.assert_allclose(float(m["loss"]), float(r_m["loss"]),
                               rtol=LOSS_RTOL)
    assert float(aux) > 1e-3                  # the aux is a visible term


# ---------------------------------------------------------------------------
# serving and training through the launchers
# ---------------------------------------------------------------------------

def _report(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


_ARCH_BY_NAME = {r_get_arch(a).make_smoke_config().name: a for a in MOE}


def _carry_reference_weights(monkeypatch):
    """The port's ``init_params`` returns the reference's weights for the
    same seed (``serve_lm`` seeds its generator with ``seed``)."""
    def carried(cfg, generator):
        r_cfg = r_get_arch(_ARCH_BY_NAME[cfg.name]).make_smoke_config()
        return T.params_from_reference(
            _np_tree(RT.init_params(r_cfg,
                                    jax.random.key(generator.initial_seed()))),
            generator.device)
    monkeypatch.setattr(T, "init_params", carried)


@pytest.mark.parametrize("arch", MOE)
def test_serve_lm_generates_the_references_tokens(arch, monkeypatch):
    _carry_reference_weights(monkeypatch)
    want, r_report = r_serve.serve_lm(arch, n_requests=3, max_new=6, seed=4)
    got, report = serve.serve_lm(arch, n_requests=3, max_new=6, seed=4,
                                 device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert set(report) == set(r_report)
    assert report["arch"] == arch and report["generated_tokens"] == 18


@pytest.mark.parametrize("arch", MOE)
def test_serve_main_report_keys_match_reference(arch, monkeypatch):
    _carry_reference_weights(monkeypatch)
    argv = ["--arch", arch, "--requests", "4", "--max-new", "3", "--json"]
    want = _report(r_serve.main, argv)
    launches.reset()
    got = _report(serve.main, argv + ["--device", "cpu"])
    assert launches.count == 0
    assert set(got) == set(want) == {"arch", "mode", "requests",
                                     "generated_tokens", "decode_s",
                                     "tokens_per_s"}
    assert got["generated_tokens"] == want["generated_tokens"] == 12


def test_train_cli_trains_olmoe(tmp_path):
    """``python -m repro_torch.launch.train --arch olmoe-1b-7b`` (smoke
    size, CPU) takes its steps and its loss falls."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--arch", "olmoe-1b-7b", "--steps", "30",
                    "--ckpt-dir", str(tmp_path / "ckpt"),
                    "--ckpt-interval", "100", "--metrics-out",
                    str(tmp_path / "m.json"), "--device", "cpu"])
    assert "arch=olmoe-1b-7b steps=30" in out.getvalue()
    losses = [m["loss"] for m in json.load(open(tmp_path / "m.json"))]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
