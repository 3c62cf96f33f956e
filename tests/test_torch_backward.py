"""The backward of the port's three training kernels: ``flash_attention``,
``augru`` and ``spmm`` (with ``segment_sum_tiles``).

On the CPU each op's autograd ``Function`` runs the plain forward and the
plain backward (``gqa_attention_backward``, ``augru_backward_ref``, and
``spmm`` over the reversed edges); each is held to ``torch.autograd`` of
the plain forward and to ``jax.vjp`` of the reference's plain function on
the same seeded numpy inputs.  Tolerances: flash attention's float32
gradients within 1e-4 of each gradient's largest magnitude (the float32
tolerance the kernel is held to), ``augru``'s within 1e-5, ``spmm``'s within
1e-5 (float32 sums in another order).

The ``gpu`` cases hold each backward kernel to its plain backward on the
card, at the same tolerances (bf16 flash gradients elementwise within
``ops.bf16_gradient_bound``), and two launches bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.augru.ref import augru_ref as r_augru_ref
from repro.kernels.flash_attention.ref import gqa_attention as r_gqa
from repro.kernels.spmm import spmm_ref as r_spmm_ref
from repro_torch.kernels import wrap_clamp_index
from repro_torch.kernels import augru as A
from repro_torch.kernels import flash_attention as F
from repro_torch.kernels import spmm as S

FLASH_TOL = 1e-4
AUGRU_TOL = 1e-5
SPMM_TOL = 1e-5


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _grads(fn, inputs, dout):
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    out = fn(*ts)
    return out, torch.autograd.grad(out, ts, torch.tensor(dout))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

#: (B, Hq, Hkv, Sq, Skv, D, causal): GQA 1:1, 2:1 and 12:1, Sq != Skv
#: both ways (causal needs Sq <= Skv), D 16 and 128, ragged S
FLASH_CASES = [
    (1, 2, 2, 16, 16, 16, True), (2, 4, 2, 19, 19, 16, True),
    (1, 12, 1, 33, 33, 16, True), (1, 4, 2, 5, 23, 16, True),
    (1, 4, 2, 21, 13, 16, False), (2, 4, 4, 17, 17, 16, False),
    (1, 4, 2, 37, 37, 128, True), (1, 24, 2, 9, 70, 128, True),
]


def _flash_inputs(B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
                      (B, Hq, Sq, D))]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", FLASH_CASES)
def test_flash_backward_matches_autograd_and_reference(B, Hq, Hkv, Sq, Skv,
                                                       D, causal):
    q, k, v, do = _flash_inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq * D + Hq)
    out, got = _grads(lambda *t: F.flash_attention(*t, causal=causal),
                      (q, k, v), do)
    _, want = _grads(lambda *t: F.gqa_attention(*t, causal=causal),
                     (q, k, v), do)
    plain = F.gqa_attention_backward(
        *map(torch.tensor, (q, k, v)), out.detach(), torch.tensor(do),
        causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: r_gqa(a, b, c, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    for name, g, w, p, r in zip("qkv", got, want, plain, ref):
        _close(g, w, FLASH_TOL, f"d{name} vs autograd")
        _close(p, np.asarray(r), FLASH_TOL, f"d{name} vs jax.vjp")
        _close(g, np.asarray(r), FLASH_TOL, f"Function d{name} vs jax.vjp")


def test_flash_no_grad_keeps_the_forward_alone():
    q, k, v, _ = _flash_inputs(1, 4, 2, 8, 8, 16, seed=1)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    with torch.no_grad():
        out = F.flash_attention(*ts)
    assert out.grad_fn is None
    assert F.flash_attention(*ts).grad_fn is not None


def _emulate_tensor_core_backward(q, k, v, o, do, *, causal, split):
    """The bf16 tensor-core backward's arithmetic in plain torch: float32 S
    and dP from the bf16 operands (exact products), each row's lse in the
    exp2 domain, P and dS in float32, fed to the dV, dK and dQ products as
    the split pair hi = bf16(x), lo = bf16(x - hi) (``split``) or rounded
    once to bf16, per-query-head dK and dV partials summed over the group
    in head order, dK and dQ scaled after the sum, one rounding of each
    gradient."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    scale_log2 = torch.tensor(scale * 1.4426950408889634)
    qf, dof, of = (t.float().reshape(B, Hkv, G, Sq, D) for t in (q, do, o))
    kf, vf = k.float(), v.float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf)
    vis = torch.ones(Sq, Skv, dtype=torch.bool)
    if causal:
        vis = (torch.arange(Skv)[None, :]
               <= torch.arange(Sq)[:, None] + (Skv - Sq))
    s2 = torch.where(vis, s * scale_log2, torch.tensor(-1e30))
    m = s2.amax(-1, keepdim=True)
    lse2 = m + torch.log2(torch.exp2(s2 - m).sum(-1, keepdim=True))
    p = torch.where(vis, torch.exp2(s * scale_log2 - lse2),
                    torch.tensor(0.0))
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = p * (dp - (dof * of).sum(-1, keepdim=True))

    def parts(x):
        hi = x.bfloat16().float()
        return (hi, (x - hi).bfloat16().float()) if split else (hi,)

    dv_h = sum(torch.einsum("bhgqk,bhgqd->bhgkd", t, dof) for t in parts(p))
    dk_h = sum(torch.einsum("bhgqk,bhgqd->bhgkd", t, qf) for t in parts(ds))
    dq = sum(torch.einsum("bhgqk,bhkd->bhgqd", t, kf)
             for t in parts(ds)) * scale
    dk = torch.zeros_like(dk_h[:, :, 0])
    dv = torch.zeros_like(dk)
    for g in range(G):
        dk = dk + dk_h[:, :, g]
        dv = dv + dv_h[:, :, g]
    return (dq.reshape(B, Hq, Sq, D).bfloat16(), (dk * scale).bfloat16(),
            dv.bfloat16())


#: GQA 12:1 and 2:1, Sq != Skv both ways, D 16, 64 and 128, non-causal
EMULATED = [(1, 12, 1, 128, 128, 128, True), (1, 4, 2, 96, 160, 64, True),
            (1, 4, 2, 160, 96, 64, False), (1, 24, 2, 256, 256, 128, True),
            (2, 4, 2, 33, 47, 16, True)]


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", EMULATED)
def test_tensor_core_backward_needs_split_p_and_ds(B, Hq, Hkv, Sq, Skv, D,
                                                   causal, split):
    """On bf16 operands, the tensor-core design's arithmetic with P and dS
    fed as split bf16 pairs keeps every gradient element within
    ``bf16_gradient_bound`` of the plain backward evaluated in float32;
    with P and dS rounded once to bf16, some gradient leaves it (by 5.9-14x
    on these cases).  So the split is what lets the kernel keep the
    bound."""
    rng = np.random.default_rng(B + Hq + Sq + D)
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in (
        rng.standard_normal(s).astype(np.float32)
        for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
                  (B, Hq, Sq, D))))
    o = F.flash_attention(q, k, v, causal=causal)
    want = F.gqa_attention_backward(q.float(), k.float(), v.float(),
                                    o.float(), do.float(), causal=causal)
    got = _emulate_tensor_core_backward(q, k, v, o, do, causal=causal,
                                        split=split)
    ratio = max(float(((g.float() - w).abs()
                       / F.bf16_gradient_bound(w)).max())
                for g, w in zip(got, want))
    if split:
        assert ratio <= 1.0
    else:
        assert ratio > 1.0


def test_backward_route_is_decided_by_dtype_and_head_dim():
    """bf16 at D <= 128 takes the tensor-core kernels, float32 and bf16
    above D = 128 the SIMT ones (the route the card's check exercises at D
    = 256)."""
    from repro_torch.kernels.flash_attention import kernel

    def q(dtype, D):
        return torch.zeros((1, 2, 3, D), dtype=dtype)

    assert kernel.backward_route(q(torch.bfloat16, 1)) == "tensor_core"
    assert kernel.backward_route(q(torch.bfloat16, 128)) == "tensor_core"
    assert kernel.backward_route(q(torch.bfloat16, 129)) == "simt"
    assert kernel.backward_route(q(torch.bfloat16, 256)) == "simt"
    assert kernel.backward_route(q(torch.float32, 64)) == "simt"


# ---------------------------------------------------------------------------
# augru
# ---------------------------------------------------------------------------

AUGRU_CASES = [(3, 1, 24), (2, 100, 24), (4, 7, 37), (2, 5, 112),
               (1, 100, 37)]


def _augru_inputs(B, T, H, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, 3 * H)).astype(np.float32),
            (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32),
            rng.uniform(0, 1, (B, T)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32),
            rng.standard_normal((B, T, H)).astype(np.float32)]


@pytest.mark.parametrize("B,T,H", AUGRU_CASES)
def test_augru_backward_matches_autograd_and_reference(B, T, H):
    xg, u, att, h0, do = _augru_inputs(B, T, H, seed=B * T + H)
    out, got = _grads(A.augru, (xg, u, att, h0), do)
    _, want = _grads(A.augru_ref, (xg, u, att, h0), do)
    _, vjp = jax.vjp(r_augru_ref, *map(jnp.asarray, (xg, u, att, h0)))
    ref = vjp(jnp.asarray(do))
    for name, g, w, r in zip(("x_gates", "u", "att", "h0"), got, want, ref):
        _close(g, w, AUGRU_TOL, f"d{name} vs autograd")
        _close(g, np.asarray(r), AUGRU_TOL, f"d{name} vs jax.vjp")


# ---------------------------------------------------------------------------
# spmm and segment_sum_tiles
# ---------------------------------------------------------------------------

def _graph(N, E, seed, *, wrap):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, max(N - 2, 1), E)    # the last rows isolated
    lo, hi = (-N - 3, N + 3) if wrap else (0, N)
    src = rng.integers(lo, hi, E).astype(np.int32)
    return dst, src, rng.uniform(0, 1, E).astype(np.float32)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("bound", [None, "edges", "reverse"])
@pytest.mark.parametrize("wrap", [True, False])
def test_spmm_backward_matches_autograd_and_reference(weighted, bound, wrap):
    """JAX drops the gradient of a gather index clamped into range (its
    transpose is a scatter that drops out-of-range updates); the port's
    backward does the same.  A negative index that wraps into range keeps
    its gradient."""
    N, E, D = 23, 90, 5
    dst, src, w = _graph(N, E, seed=7 + wrap, wrap=wrap)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, D)).astype(np.float32)
    g = rng.standard_normal((N, D)).astype(np.float32)
    src_t = torch.tensor(src)
    w_t = torch.tensor(w) if weighted else None
    prep = S.prepare_tiles(dst, N)
    if bound:
        prep = prep.with_edges(src_t, w_t, num_rows=N)
    if bound == "reverse":
        prep = prep.with_reverse(src_t)
    xt = torch.tensor(x, requires_grad=True)
    (got,) = torch.autograd.grad(S.spmm(xt, src_t, w_t, prep), xt,
                                 torch.tensor(g))
    xr = torch.tensor(x, requires_grad=True)
    msg = xr[wrap_clamp_index(src_t, N)]
    if weighted:
        msg = msg * w_t[:, None]
    want_y = torch.zeros(N, D).index_add(0, torch.tensor(dst), msg)
    (want,) = torch.autograd.grad(want_y, xr, torch.tensor(g))
    _, vjp = jax.vjp(lambda a: r_spmm_ref(
        a, jnp.asarray(src), jnp.asarray(dst, jnp.int32),
        jnp.asarray(w) if weighted else None, N), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    if not wrap:     # torch's gather sends a clamped row its gradient
        _close(got, want, SPMM_TOL, "dx vs autograd")
    _close(got, np.asarray(ref), SPMM_TOL, "dx vs jax.vjp")


def test_segment_sum_backward_cut_off_ids_get_zero():
    """Ids outside [0, n) go to the cut-off extra segment (``models.gnn
    .segments``); their messages' gradient is zero, as JAX drops them."""
    from repro_torch.models.gnn import segment_sum, segments
    rng = np.random.default_rng(5)
    n, E, D = 6, 30, 4
    ids = rng.integers(-2, n + 2, E)
    msg = rng.standard_normal((E, D)).astype(np.float32)
    g = rng.standard_normal((n, D)).astype(np.float32)
    mt = torch.tensor(msg, requires_grad=True)
    (got,) = torch.autograd.grad(segment_sum(mt, segments(ids, n, "cpu"), n),
                                 mt, torch.tensor(g))
    _, vjp = jax.vjp(lambda m: jax.ops.segment_sum(
        m, jnp.asarray(ids, jnp.int32), num_segments=n), jnp.asarray(msg))
    (ref,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_spmm_weights_requiring_grad_raise():
    dst, src, w = _graph(5, 9, seed=1, wrap=False)
    prep = S.prepare_tiles(dst, 5)
    with pytest.raises(ValueError, match="weights"):
        S.spmm(torch.zeros(5, 2), torch.tensor(src),
               torch.tensor(w, requires_grad=True), prep)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


GPU_FLASH = FLASH_CASES + [(1, 24, 2, 4096, 4096, 128, True),
                           (2, 8, 8, 100, 300, 256, True),
                           (1, 4, 2, 70, 70, 33, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", GPU_FLASH)
def test_cuda_flash_backward_matches_plain(B, Hq, Hkv, Sq, Skv, D, causal,
                                           dtype):
    dev = _cuda()
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.tensor(a).to(dev, dt)
                   for a in _flash_inputs(B, Hq, Hkv, Sq, Skv, D, seed=D))
    with torch.no_grad():
        o = F.flash_attention(q, k, v, causal=causal)
    got = F.flash_attention_backward(q, k, v, o, do, causal=causal)
    again = F.flash_attention_backward(q, k, v, o, do, causal=causal)
    want = F.gqa_attention_backward(q, k, v, o, do, causal=causal)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        if dtype == "float32":
            _close(g.cpu(), w.cpu(), FLASH_TOL)
        else:
            want32 = F.gqa_attention_backward(
                q.float(), k.float(), v.float(), o.float(), do.float(),
                causal=causal)
            for g16, w32 in zip(got, want32):
                bound = F.bf16_gradient_bound(w32)
                assert bool(((g16.float() - w32).abs() <= bound).all())


def _cuda_augru_backward_holds(B, T, H, plan=None):
    dev = _cuda()
    xg, u, att, h0, do = (torch.tensor(a, device=dev)
                          for a in _augru_inputs(B, T, H, seed=H))
    with torch.no_grad():
        out = A.augru(xg, u, att, h0)
    got = A.augru_backward(xg, u, att, h0, out, do, use_plan=plan)
    again = A.augru_backward(xg, u, att, h0, out, do, use_plan=plan)
    want = A.augru_backward_ref(xg, u, att, h0, out, do)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        _close(g.cpu(), w.cpu(), AUGRU_TOL)


#: the planned route: the rows route (the CPU cases, 512 and 3,000 rows,
#: H 160 and 1,000) and the tile route at the train rows, on 132 SMs at
#: the tile route's edge plus 13 and one short of 65,536 (a ragged last
#: tile and row group)
@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H", AUGRU_CASES + [(512, 100, 108),
                                                 (3000, 100, 108),
                                                 (5, 9, 160), (2, 3, 1000),
                                                 (65_536, 3, 108),
                                                 (1_333, 3, 108),
                                                 (65_533, 2, 108)])
def test_cuda_augru_backward_matches_plain(B, T, H):
    _cuda_augru_backward_holds(B, T, H)


@pytest.mark.gpu
@pytest.mark.parametrize("route,B,T,H", [
    ("tile", 7, 20, 37), ("tile", 50, 5, 105), ("tile", 3, 4, 1),
    ("tile", 9, 3, 128), ("tile", 512, 10, 108), ("rows", 5_000, 3, 108)])
def test_cuda_augru_backward_forced_route(route, B, T, H):
    """Either route forced through ``use_plan`` on a shape the plan gives
    the other: the tile route at H % 4 != 0, H = 1, its largest H and a
    small batch; the rows route above the tile route's edge."""
    _cuda()
    limits = A.kernel.device_limits(torch.cuda.current_device())
    plan = (A.kernel.backward_tile_plan(B, H, *limits) if route == "tile"
            else A.kernel.backward_rows_plan(B, H, *limits))
    assert plan.route == route
    _cuda_augru_backward_holds(B, T, H, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 70])
@pytest.mark.parametrize("weighted", [True, False])
def test_cuda_spmm_backward_matches_plain(D, weighted):
    dev = _cuda()
    N, E = 5000, 60000
    dst, src, w = _graph(N, E, seed=D, wrap=True)
    src_t = torch.tensor(src, device=dev)
    w_t = torch.tensor(w, device=dev) if weighted else None
    prep = S.prepare_tiles(dst, N).to(dev).with_edges(
        src_t, w_t, num_rows=N).with_reverse(src_t)
    x = torch.randn(N, D, device=dev, requires_grad=True)
    g = torch.randn(N, D, device=dev)
    S.launches.reset()
    S.backward_launches.reset()
    (got,) = torch.autograd.grad(S.spmm(x, src_t, w_t, prep), x, g)
    assert S.launches.by_route == {"bound": 2, "perm": 0}
    assert S.backward_launches.count == 1
    (again,) = torch.autograd.grad(S.spmm(x, src_t, w_t, prep), x, g)
    xc = x.detach().cpu().requires_grad_()
    prep_c = S.prepare_tiles(dst, N)
    (want,) = torch.autograd.grad(
        S.spmm(xc, src_t.cpu(), None if w_t is None else w_t.cpu(), prep_c),
        xc, g.cpu())
    assert torch.equal(got, again)
    _close(got.cpu(), want, SPMM_TOL)
