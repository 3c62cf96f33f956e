"""The port's optimizer substrate (``repro_torch.optim``) against the
reference's ``repro.optim`` on the CPU, on the same seeded numpy inputs.

Tolerances: the schedules and ``clip_by_global_norm`` within 1e-6
relative (float32 pow, cos and sums in another order); ``adamw_update``
over 5 steps: float32 parameters, ``m`` and ``v`` within 1e-6 of each
leaf's largest magnitude and ``step`` equal; bf16 parameters equal or one
bf16 unit in the last place apart (the float32 update ``lr * delta`` is
rounded to bf16 before it is subtracted, and a float32 difference below
1e-6 can cross a rounding boundary); the int8 functions equal.  Then the
reference's own substrate checks (``tests/test_substrates.py``) as cases
of the port.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import optim as R
from repro_torch import optim as O
from repro_torch.launch.steps import state_to_numpy


def _step(v):
    return torch.tensor(v, dtype=torch.int32)


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 101, 500, 1000,
                                  1500])
def test_schedules_match_reference(step):
    f, rf = (O.linear_warmup_cosine(1e-3, 100, 1000),
             R.linear_warmup_cosine(1e-3, 100, 1000))
    got = f(_step(step))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(rf(jnp.int32(step))),
                               rtol=1e-6)
    assert float(O.constant_lr(3e-4)(_step(step))) == float(
        R.constant_lr(3e-4)(jnp.int32(step)))


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((4, 3)).astype(dtype),
                  "b": rng.standard_normal(3).astype(dtype)},
            "c": [(rng.standard_normal((2, 5)) * 10).astype(dtype)]}


def _t(tree, dtype=torch.float32):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32))
                        .to(dtype), tree)


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(1)
    clipped, gn = O.clip_by_global_norm(_t(g), max_norm)
    r_clipped, r_gn = R.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                            max_norm)
    np.testing.assert_allclose(float(gn), float(r_gn), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(state_to_numpy(clipped)),
                    jax.tree.leaves(r_clipped)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


def _ulps_bf16(a, b):
    ai = np.asarray(a).view(np.int16).astype(np.int32)
    bi = np.asarray(b).view(np.int16).astype(np.int32)
    return np.abs(ai - bi)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_five_steps_match_reference(dtype):
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    p0 = _tree(2, np_dt)
    r_params = jax.tree.map(jnp.asarray, p0)
    r_state = R.adamw_init(r_params)
    params = jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(
            torch.bfloat16) if dtype == "bfloat16" else torch.tensor(a), p0)
    state = O.adamw_init(params)
    for i in range(5):
        g = _tree(10 + i)
        r_params, r_state, r_m = R.adamw_update(
            jax.tree.map(lambda a: jnp.asarray(a, r_params["c"][0].dtype), g),
            r_state, r_params, lr=jnp.float32(1e-2), weight_decay=0.1,
            max_grad_norm=5.0)
        params, state, m = O.adamw_update(
            _t(g, getattr(torch, dtype)), state, params,
            lr=torch.tensor(1e-2), weight_decay=0.1, max_grad_norm=5.0)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(r_m["grad_norm"]), rtol=1e-6)
    assert int(state["step"]) == int(r_state["step"]) == 5
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(state_to_numpy(state[name])),
                        jax.tree.leaves(r_state[name])):
            b = np.asarray(b)
            assert a.dtype == np.float32
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
    for a, b in zip(jax.tree.leaves(state_to_numpy(params)),
                    jax.tree.leaves(r_params)):
        b = np.asarray(b)
        assert a.dtype == b.dtype
        if dtype == "float32":
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
        else:
            assert _ulps_bf16(a, b).max() <= 1


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=20, deadline=None)
def test_int8_functions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(100) * rng.uniform(0.01, 10)).astype(np.float32)
    q, scale = O.compress_int8(torch.tensor(g))
    rq, rscale = R.compress_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)
    np.testing.assert_array_equal(O.decompress_int8(q, scale).numpy(),
                                  np.asarray(R.decompress_int8(rq, rscale)))
    res = rng.standard_normal(100).astype(np.float32) * 0.01
    deq, new = O.error_feedback_update(torch.tensor(g), torch.tensor(res))
    rdeq, rnew = R.error_feedback_update(jnp.asarray(g), jnp.asarray(res))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(rdeq))
    np.testing.assert_array_equal(new.numpy(), np.asarray(rnew))


@pytest.mark.parametrize("residual", [False, True])
def test_compressed_psum_waits_for_the_mesh(residual):
    """``compressed_psum`` reduces over an axis of the ambient mesh: it
    raises outside one, and on a one-rank gloo group its mean is the
    error-feedback gradient compressed again and dequantized, its residual
    ``error_feedback_update``'s, bit for bit."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    rng = np.random.default_rng(3)
    g = torch.tensor((rng.standard_normal(257) * 3).astype(np.float32))
    r = torch.tensor((rng.standard_normal(257) * 0.01).astype(np.float32)) \
        if residual else None
    with pytest.raises(RuntimeError, match="ambient mesh"):
        O.compressed_psum(g, "data", r)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_device_mesh((1, 1), ("data", "model"), device="cpu")
        with mesh:
            mean, new = O.compressed_psum(g, "data", r)
            again, _ = O.compressed_psum(g, "model", r)
    finally:
        dist.destroy_process_group()
    deq, want_new = O.error_feedback_update(g, r)
    q, scale = O.compress_int8(deq)
    np.testing.assert_array_equal(mean.numpy(),
                                  O.decompress_int8(q, scale).numpy())
    np.testing.assert_array_equal(new.numpy(), want_new.numpy())
    np.testing.assert_array_equal(again.numpy(), mean.numpy())
    assert mean.dtype == g.dtype


# ---------------------------------------------------------------------------
# the reference's own substrate checks, on the port
# ---------------------------------------------------------------------------

def _quadratic():
    params = {"x": torch.tensor([5.0, -3.0])}
    state = O.adamw_init(params)
    for _ in range(200):
        g = {"x": 2 * params["x"]}
        params, state, _ = O.adamw_update(g, state, params, lr=0.1,
                                          weight_decay=0.0)
    assert float(torch.sum(torch.square(params["x"]))) < 1e-2


def _clip():
    clipped, gn = O.clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert abs(float(gn) - np.sqrt(1000)) < 1e-3
    assert abs(float(torch.sqrt(torch.sum(clipped["a"] ** 2))) - 1.0) < 1e-4


def _schedule():
    f = O.linear_warmup_cosine(1e-3, 100, 1000)
    assert float(f(_step(1))) == pytest.approx(1e-5, rel=1e-3)
    assert float(f(_step(100))) == pytest.approx(1e-3, rel=1e-3)
    assert float(f(_step(1000))) == pytest.approx(1e-4, rel=1e-2)


def _int8_bounded():
    rng = np.random.default_rng(0)
    for _ in range(20):
        g = torch.tensor(rng.standard_normal(100) * rng.uniform(0.01, 10),
                         dtype=torch.float32)
        q, scale = O.compress_int8(g)
        err = float((O.decompress_int8(q, scale) - g).abs().max())
        assert err <= float(scale) / 2 + 1e-6


def _error_feedback():
    rng = np.random.default_rng(0)
    true_sum = np.zeros(50, np.float32)
    comp_sum = np.zeros(50, np.float32)
    residual = None
    for _ in range(100):
        g = torch.tensor(rng.standard_normal(50) * 0.01, dtype=torch.float32)
        true_sum += g.numpy()
        deq, residual = O.error_feedback_update(g, residual)
        comp_sum += deq.numpy()
    assert np.abs(comp_sum + residual.numpy() - true_sum).max() < 1e-4


@pytest.mark.parametrize("check", [_quadratic, _clip, _schedule,
                                   _int8_bounded, _error_feedback],
                         ids=lambda f: f.__name__.strip("_"))
def test_reference_substrate_checks(check):
    check()
