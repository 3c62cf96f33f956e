"""The port's ``spmm``, ``segment_sum_tiles`` and ``prepare_tiles`` against
the reference's.

On the CPU the ops run the plain torch version (an ``index_add_`` into
float32); they must give the reference's ``spmm(..., interpret=True)`` and
``segment_sum_tiles(..., interpret=True)`` (its Pallas kernel in interpret
mode) and its ``spmm_ref`` within rtol = atol = 1e-4, the reference test's
own tolerance (the sums are taken in another order: the differences seen
are ~1e-6).  ``prepare_tiles`` must give the reference's edge order
exactly.  Inputs are drawn with numpy from fixed seeds.  The CUDA kernel is
held to the plain version by the ``gpu`` cases, which need a card and skip
without one (``chip_smoke.py`` runs the same checks on the card), within
1e-5 of each output's absolute sum plus 1e-6.

Both routes are held to the reference: ``bound`` (edges bound in
destination order by ``TilePrep.with_edges``; on the CPU its plain version
``sorted_sum_ref`` reads the bound arrays) and ``perm``; a binding must be
used only for the very tensors it was built from, unchanged, and the row
count it was built for.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm import prepare_tiles as r_prepare_tiles
from repro.kernels.spmm import segment_sum_tiles as r_segment_sum_tiles
from repro.kernels.spmm import spmm as r_spmm
from repro.kernels.spmm import spmm_ref as r_spmm_ref
from repro_torch.kernels.spmm import (kernel, launches, prepare_tiles,
                                      route, segment_sum_ref,
                                      segment_sum_tiles, sorted_sum_ref,
                                      spmm, spmm_ref)

RTOL = ATOL = 1e-4
#: (V, E, D, weighted): the reference test's six cases and its unweighted one
CASES = [(50, 300, 16, True), (300, 2000, 70, True), (1000, 5000, 128, True),
         (257, 1, 5, True), (128, 128, 128, True), (5, 40, 200, True),
         (100, 500, 32, False)]


def _graph(V, E, D, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    w = rng.standard_normal(E).astype(np.float32)
    x = rng.standard_normal((V, D)).astype(np.float32)
    return src, dst, w, x


@pytest.mark.parametrize("V,E,D,weighted", CASES)
def test_spmm_matches_reference(V, E, D, weighted):
    src, dst, w, x = _graph(V, E, D, seed=V + E + D)
    wj = jnp.asarray(w) if weighted else None
    want_k = np.asarray(r_spmm(jnp.asarray(x), jnp.asarray(src), wj,
                               r_prepare_tiles(dst, V), interpret=True))
    want_r = np.asarray(r_spmm_ref(jnp.asarray(x), jnp.asarray(src),
                                   jnp.asarray(dst), wj, V))
    got = spmm(torch.from_numpy(x), torch.from_numpy(src),
               torch.from_numpy(w) if weighted else None,
               prepare_tiles(dst, V))
    assert got.shape == (V, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_k, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), want_r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("V,E,D,weighted", CASES)
def test_bound_route_matches_reference(V, E, D, weighted):
    src, dst, w, x = _graph(V, E, D, seed=V + E + D)
    wj = jnp.asarray(w) if weighted else None
    want_k = np.asarray(r_spmm(jnp.asarray(x), jnp.asarray(src), wj,
                               r_prepare_tiles(dst, V), interpret=True))
    src_t = torch.from_numpy(src)
    w_t = torch.from_numpy(w) if weighted else None
    x_t = torch.from_numpy(x)
    prep = prepare_tiles(dst, V).with_edges(src_t, w_t, num_rows=V)
    assert route(x_t, src_t, w_t, prep) == "bound"
    got = spmm(x_t, src_t, w_t, prep)
    assert got.shape == (V, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_k, rtol=RTOL, atol=ATOL)


def _reference_spmm(x, src, dst, w, V):
    return np.asarray(r_spmm_ref(jnp.asarray(x), jnp.asarray(src),
                                 jnp.asarray(dst),
                                 None if w is None else jnp.asarray(w), V))


@pytest.mark.parametrize("kind", ["bad_src", "bad_src_int64", "isolated",
                                  "empty", "hubs", "hubs_no_split"])
def test_bound_route_edge_cases(kind):
    """Wrap-then-clamp src (int32 and int64 ids), nodes without an
    in-edge, no edges, and hubs cut into chunks (or not), on the bound
    route's plain path, against the reference."""
    V, D = 40, 6
    src, dst, w, x = _graph(V, 3000, D, seed=11)
    if kind.startswith("bad_src"):
        src[::7] = -np.arange(1, len(src[::7]) + 1) % (2 * V + 1) - 1
        src[3::7] = V + np.arange(len(src[3::7])) % (2 * V)
    if kind == "isolated":
        dst = dst % 10
    if kind == "empty":
        src, dst, w = src[:0], dst[:0], w[:0]
    if kind.startswith("hubs"):
        dst[:2100] = 7
    src_t = torch.from_numpy(src)
    if kind == "bad_src_int64":
        src_t = src_t.long()
    w_t = torch.from_numpy(w)
    prep = prepare_tiles(dst, V)
    if kind == "hubs_no_split":
        prep = prep.with_split(None)
    prep = prep.with_edges(src_t, w_t, num_rows=V)
    x_t = torch.from_numpy(x)
    assert route(x_t, src_t, w_t, prep) == "bound"
    got = spmm(x_t, src_t, w_t, prep)
    np.testing.assert_allclose(got.numpy(), _reference_spmm(x, src, dst, w,
                                                            V),
                               rtol=RTOL, atol=ATOL)
    if kind == "isolated":
        assert torch.equal(got[10:], torch.zeros(V - 10, D))


def test_with_edges_survives_to_and_with_split():
    src, dst, w, x = _graph(50, 300, 16, seed=2)
    src_t, w_t, x_t = (torch.from_numpy(a) for a in (src, w, x))
    bound = prepare_tiles(dst, 50).with_edges(src_t, w_t, num_rows=50)
    want = _reference_spmm(x, src, dst, w, 50)
    for prep in (bound.to("cpu"), bound.with_split(None),
                 bound.with_split(4).to("cpu")):
        assert prep.edges is not None
        assert torch.equal(prep.edges.src, bound.edges.src)
        assert route(x_t, src_t, w_t, prep) == "bound"
        np.testing.assert_allclose(spmm(x_t, src_t, w_t, prep).numpy(),
                                   want, rtol=RTOL, atol=ATOL)
    moved = bound.to("meta")
    assert moved.edges.src.device.type == "meta"
    assert moved.edges.weights.device.type == "meta"


@pytest.mark.parametrize("change", ["other_src", "equal_copy_of_src",
                                    "other_row_count", "mask_in_place",
                                    "src_in_place", "weights_dropped",
                                    "weights_added"])
def test_stale_binding_is_not_used(change):
    """A prep bound to one src / weights / row count and handed another
    takes the ``perm`` route, and its result is the reference's for what it
    was handed."""
    V, D = 30, 8
    src, dst, w, x = _graph(V, 400, D, seed=5)
    src[::5] = -3                 # wraps to V - 3 for this row count only
    src_t, w_t, x_t = (torch.from_numpy(a) for a in (src, w, x))
    prep = prepare_tiles(dst, V).with_edges(
        src_t, None if change == "weights_added" else w_t, num_rows=V)
    rows = V
    if change == "other_src":
        src_t = torch.from_numpy(np.roll(src, 1))
    elif change == "equal_copy_of_src":
        src_t = src_t.clone()
    elif change == "other_row_count":
        rows = V + 7
        x_t = torch.from_numpy(np.random.default_rng(6).standard_normal(
            (rows, D)).astype(np.float32))
    elif change == "mask_in_place":
        w_t.mul_(0.5)
    elif change == "src_in_place":
        src_t[1] = 0
    elif change == "weights_dropped":
        w_t = None
    assert route(x_t, src_t, w_t, prep) == "perm"
    got = spmm(x_t, src_t, w_t, prep)
    want = _reference_spmm(x_t.numpy(), src_t.numpy(), dst,
                           None if w_t is None else w_t.numpy(), V)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_with_edges_rejects_what_it_cannot_bind():
    src, dst, w, _ = _graph(20, 50, 4, seed=1)
    prep = prepare_tiles(dst, 20)
    with pytest.raises(ValueError, match="shape"):
        prep.with_edges(torch.from_numpy(src[:-1]), num_rows=20)
    with pytest.raises(TypeError, match="int32 or int64"):
        prep.with_edges(torch.from_numpy(src).float(), num_rows=20)
    with pytest.raises(TypeError, match="weights"):
        prep.with_edges(torch.from_numpy(src),
                        torch.from_numpy(src), num_rows=20)
    with pytest.raises(ValueError, match="prep on"):
        prep.with_edges(torch.from_numpy(src).to("meta"), num_rows=20)
    with pytest.raises(ValueError, match="negative"):
        prep.with_edges(torch.from_numpy(src), num_rows=-1)


#: D -> (vec_bytes, lanes, chunks) on an aligned base, by dtype
PLANS = {
    "float32": {4: (16, 1, 1), 5: (4, 8, 1), 63: (4, 32, 2),
                64: (16, 16, 1), 65: (4, 32, 4), 70: (8, 32, 2),
                128: (16, 32, 1), 520: (16, 32, 4)},
    "bfloat16": {4: (8, 1, 1), 5: (2, 8, 1), 63: (2, 32, 2),
                 64: (16, 8, 1), 65: (2, 32, 4), 70: (2, 32, 4),
                 128: (16, 16, 1), 520: (16, 32, 4)},
}


@pytest.mark.parametrize("dtype", sorted(PLANS))
@pytest.mark.parametrize("D", [4, 5, 63, 64, 65, 70, 128, 520])
def test_plan_vector_width(D, dtype):
    """16-byte loads where the row's bytes and the base allow them, else 8,
    else one element; lanes and chunks cover the row's vectors."""
    item = 4 if dtype == "float32" else 2
    assert kernel.plan(D, item, 1024) == kernel.Plan(*PLANS[dtype][D])
    # a base off by one element (a view) takes one element a load
    p = kernel.plan(D, item, 1024 + item)
    assert p.vec_bytes == item
    n = D
    assert p.lanes == min(32, 1 << (n - 1).bit_length())
    assert p.lanes * p.chunks >= min(n, 128)


def test_plan_follows_the_base_alignment():
    assert kernel.plan(64, 4, 1024 + 8) == kernel.Plan(8, 32, 1)
    assert kernel.plan(64, 2, 1024 + 8) == kernel.Plan(8, 16, 1)
    x = torch.zeros(65 * 64, dtype=torch.float32)
    assert kernel.plan_for(x[64:].view(64, 64)).vec_bytes == 16
    assert kernel.plan_for(x[1:4097].view(64, 64)).vec_bytes == 4
    with pytest.raises(ValueError):
        kernel.plan(0, 4, 0)


@pytest.mark.parametrize("V,E,seed", [(1, 0, 0), (7, 0, 0), (40, 3000, 1),
                                      (2000, 9000, 2), (5000, 400, 3)])
def test_row_blocks_cover_the_rows(V, E, seed):
    """Row blocks: 0 first, N last, rising; at most 31 rows each, and a
    block's edges within 256 plus its last row's."""
    _, dst, _, _ = _graph(V, E, 1, seed)
    dst[: E // 3] = V // 2                      # a hub
    prep = prepare_tiles(dst, V)
    b = prep.blocks.numpy()
    rp = prep.row_ptr.numpy()
    assert b[0] == 0 and b[-1] == V and (np.diff(b) > 0).all()
    assert (np.diff(b) <= 31).all()
    last = rp[b[1:]] - rp[b[1:] - 1]
    assert (rp[b[1:]] - rp[b[:-1]] <= 256 + last).all()
    assert torch.equal(prep.to("cpu").with_split(None).blocks, prep.blocks)


@pytest.mark.parametrize("V,E,D,weighted", CASES)
def test_sorted_sum_of_messages_matches_reference(V, E, D, weighted):
    """The bound route's plain version with ``perm`` as the row ids (how
    ``chip_smoke.py`` times the messages' sum on the bound kernel)."""
    _, dst, _, _ = _graph(V, E, D, seed=V + E + D)
    msg = np.random.default_rng(E).standard_normal((E, D)).astype(np.float32)
    want = np.asarray(r_segment_sum_tiles(jnp.asarray(msg),
                                          r_prepare_tiles(dst, V),
                                          interpret=True))
    prep = prepare_tiles(dst, V)
    got = sorted_sum_ref(torch.from_numpy(msg), prep.perm, None,
                         prep.row_ptr)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("V,E,D,weighted", CASES)
def test_segment_sum_tiles_matches_reference(V, E, D, weighted):
    _, dst, _, _ = _graph(V, E, D, seed=V + E + D)
    msg = np.random.default_rng(E).standard_normal((E, D)).astype(np.float32)
    want = np.asarray(r_segment_sum_tiles(jnp.asarray(msg),
                                          r_prepare_tiles(dst, V),
                                          interpret=True))
    got = segment_sum_tiles(torch.from_numpy(msg), prepare_tiles(dst, V))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("V,E,D,weighted", CASES)
def test_prepare_tiles_keeps_the_reference_order(V, E, D, weighted):
    _, dst, _, _ = _graph(V, E, D, seed=V + E + D)
    ref = r_prepare_tiles(dst, V)
    prep = prepare_tiles(dst, V)
    np.testing.assert_array_equal(prep.perm.numpy(),
                                  ref.perm[ref.pad_mask == 1])
    np.testing.assert_array_equal(np.diff(prep.row_ptr.numpy()),
                                  np.bincount(dst, minlength=V))
    assert prep.num_nodes == V and prep.num_edges == E
    assert torch.equal(prep.dst(), torch.from_numpy(dst).long())


def test_empty_edge_list_gives_zeros():
    x = torch.randn(7, 3)
    prep = prepare_tiles(np.zeros(0, np.int32), 7)
    src = torch.zeros(0, dtype=torch.int32)
    assert torch.equal(spmm(x, src, None, prep), torch.zeros(7, 3))
    assert torch.equal(segment_sum_tiles(torch.zeros(0, 3), prep),
                       torch.zeros(7, 3))


def test_isolated_nodes_are_zero():
    V, D = 40, 6
    src, dst, w, x = _graph(V, 200, D, seed=3)
    dst = dst % 10                      # nodes 10..39 have no in-edge
    got = spmm(torch.from_numpy(x), torch.from_numpy(src),
               torch.from_numpy(w), prepare_tiles(dst, V))
    assert torch.equal(got[10:], torch.zeros(V - 10, D))
    want = np.asarray(r_spmm_ref(jnp.asarray(x), jnp.asarray(src),
                                 jnp.asarray(dst), jnp.asarray(w), V))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", [-1, 5])
def test_dst_out_of_range_raises(bad):
    with pytest.raises(ValueError, match="outside"):
        prepare_tiles(np.array([0, bad, 1], np.int32), 5)


def test_src_follows_jax_index_semantics():
    """Negative ids wrap once, then every id clamps to [0, V - 1]."""
    V, D = 10, 4
    src = np.array([-1, 5, 100, -100, -11, -10, 9, 0], np.int32)
    dst = np.arange(len(src), dtype=np.int32) % 3
    x = np.random.default_rng(1).standard_normal((V, D)).astype(np.float32)
    want = np.asarray(r_spmm_ref(jnp.asarray(x), jnp.asarray(src),
                                 jnp.asarray(dst), None, 3))
    for idx in (torch.from_numpy(src), torch.from_numpy(src).long()):
        got = spmm(torch.from_numpy(x), idx, None, prepare_tiles(dst, 3))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_hubs_are_cut_into_chunks():
    dst = np.array([2] * 2500 + [0] * 1024 + [1] * 1025, np.int32)
    prep = prepare_tiles(dst, 4)
    assert prep.hub_rows.tolist() == [1, 2]          # more than 1,024 edges
    assert prep.hub_chunk_ptr.tolist() == [0, 2, 5]  # ceil(1025/1024), 2500
    assert prep.n_chunks == 5
    flat = prep.with_split(None)
    assert flat.split == 0 and flat.n_chunks == 0
    assert flat.hub_rows.numel() == 0
    assert torch.equal(flat.perm, prep.perm)


def test_cpu_path_counts_no_launch():
    src, dst, w, x = _graph(50, 300, 16, seed=0)
    prep = prepare_tiles(dst, 50)
    launches.reset()
    spmm(torch.from_numpy(x), torch.from_numpy(src), torch.from_numpy(w),
         prep)
    segment_sum_tiles(torch.randn(300, 16), prep)
    src_t, w_t = torch.from_numpy(src), torch.from_numpy(w)
    spmm(torch.from_numpy(x), src_t, w_t,
         prep.with_edges(src_t, w_t, num_rows=50))
    assert launches.count == 0
    assert launches.by_route == {"bound": 0, "perm": 0}


def test_prep_on_another_device_raises():
    src, dst, w, x = _graph(50, 300, 16, seed=0)
    prep = prepare_tiles(dst, 50).to("meta")
    with pytest.raises(ValueError, match="prep is on"):
        spmm(torch.from_numpy(x), torch.from_numpy(src), None, prep)
    with pytest.raises(ValueError, match="prep is on"):
        segment_sum_tiles(torch.randn(300, 16), prep)


def _cuda_case(V, E, D, seed, *, dtype=torch.float32, idx=torch.int32,
               hub=0):
    src, dst, w, x = _graph(V, E, D, seed)
    if hub:
        dst[:hub] = V // 2
    dev = "cuda"
    prep = prepare_tiles(dst, V).to(dev)
    return (torch.from_numpy(x).to(dev, dtype),
            torch.from_numpy(src).to(dev, idx),
            torch.from_numpy(w).to(dev), torch.from_numpy(dst).to(dev),
            prep)


def _within(got, want, scale, rel=0.0):
    diff = (got.float() - want.float()).abs()
    return bool((diff <= 1e-5 * scale + 1e-6 + rel * want.float().abs())
                .all())


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("V,E,D,hub,dtype,idx", [
    (50, 300, 16, 0, "float32", "int32"), (300, 2000, 70, 0, "float32",
                                           "int64"),
    (1000, 5000, 128, 0, "float32", "int32"), (257, 1, 5, 0, "float32",
                                               "int32"),
    (5, 40, 200, 0, "float32", "int32"), (100, 6000, 64, 5000, "float32",
                                          "int32"),
    (64, 3000, 300, 2100, "float32", "int64"), (300, 2000, 70, 0,
                                                "bfloat16", "int32")])
def test_cuda_kernel_matches_plain_version(V, E, D, hub, dtype, idx,
                                           weighted):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x, src, w, dst, prep = _cuda_case(V, E, D, seed=V + E, hub=hub,
                                      dtype=getattr(torch, dtype),
                                      idx=getattr(torch, idx))
    w = w if weighted else None
    before = launches.count
    got = spmm(x, src, w, prep)
    want = spmm_ref(x, src, dst, w, V)
    scale = spmm_ref(x.float().abs(), src, dst,
                     None if w is None else w.abs(), V)
    msg = x[src.long()].float()
    seg = segment_sum_tiles(msg, prep)
    seg_want = segment_sum_ref(msg, dst, V)
    seg_scale = segment_sum_ref(msg.abs(), dst, V)
    torch.cuda.synchronize()
    assert launches.count == before + 2
    assert got.dtype == want.dtype
    rel = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    assert _within(got, want, scale, rel)
    assert _within(seg, seg_want, seg_scale)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


def _rows_view(V, D, dtype, offset, seed):
    """(V, D) rows on the card, starting ``offset`` elements into a
    larger buffer (a contiguous view whose base is off the 16 bytes)."""
    x = np.random.default_rng(seed).standard_normal(V * D + offset)
    buf = torch.from_numpy(x.astype(np.float32)).to("cuda", dtype)
    return buf[offset:].view(V, D)


@pytest.mark.gpu
@pytest.mark.parametrize("D,dtype,offset", [
    (4, "float32", 0), (5, "float32", 0), (63, "float32", 0),
    (64, "float32", 0), (65, "float32", 0), (70, "float32", 0),
    (128, "float32", 0), (520, "float32", 0), (64, "float32", 1),
    (64, "float32", 2), (70, "float32", 1), (64, "bfloat16", 0),
    (64, "bfloat16", 1), (70, "bfloat16", 0), (128, "bfloat16", 0)])
def test_cuda_routes_match_plain_version(D, dtype, offset):
    """Both routes, weighted and not, at the plan's widths and on a
    misaligned view (with a hub above the split), against the plain
    version; each call counted on its route."""
    _needs_card()
    V, E = 300, 4000
    src, dst, w, _ = _graph(V, E, D, seed=D + offset)
    dst[:1500] = V // 3
    x = _rows_view(V, D, getattr(torch, dtype), offset, seed=D)
    src_d = torch.from_numpy(src).cuda()
    dst_d = torch.from_numpy(dst).cuda()
    prep = prepare_tiles(dst, V).to("cuda")
    assert prep.n_chunks
    for wt in (torch.from_numpy(w).cuda(), None):
        bound = prep.with_edges(src_d, wt, num_rows=V)
        want = spmm_ref(x, src_d, dst_d, wt, V)
        scale = spmm_ref(x.float().abs(), src_d, dst_d,
                         None if wt is None else wt.abs(), V)
        rel = 2.0 ** -7 if want.dtype == torch.bfloat16 else 0.0
        for pr, name in ((prep, "perm"), (bound, "perm"), (bound, "bound")):
            s = src_d if pr is prep or name == "bound" else src_d.clone()
            launches.reset()
            got = spmm(x, s, wt, pr)
            torch.cuda.synchronize()
            assert launches.by_route == {"bound": int(name == "bound"),
                                         "perm": int(name == "perm")}
            assert got.dtype == want.dtype
            assert _within(got, want, scale, rel)
    msg = x.float()[src_d.long().clamp(0, V - 1)]
    seg_want = segment_sum_ref(msg, dst_d, V)
    seg_scale = segment_sum_ref(msg.abs(), dst_d, V)
    seg_bound = torch.empty_like(seg_want)
    kernel.launch_bound(msg, prep.perm, None, prep, blocks=prep.blocks,
                        out=seg_bound)
    for got in (segment_sum_tiles(msg, prep), seg_bound):
        assert _within(got, seg_want, seg_scale)


@pytest.mark.gpu
@pytest.mark.parametrize("D,dtype", [(64, "float32"), (70, "float32"),
                                     (64, "bfloat16")])
def test_cuda_bound_launches_are_bit_equal(D, dtype):
    _needs_card()
    x, src, w, dst, prep = _cuda_case(1000, 30000, D, seed=3, hub=3000,
                                      dtype=getattr(torch, dtype))
    bound = prep.with_edges(src, w, num_rows=1000)
    a = spmm(x, src, w, bound)
    b = spmm(x, src, w, bound)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_refuses_a_plan_it_cannot_take():
    """16-byte loads from a base off the 16 bytes: the C entry refuses."""
    _needs_card()
    V, D = 50, 64
    src, dst, _, _ = _graph(V, 300, D, seed=4)
    x = _rows_view(V, D, torch.float32, 1, seed=4)
    prep = prepare_tiles(dst, V).to("cuda")
    idx = torch.from_numpy(src).cuda()[prep.perm.long()]
    out = torch.empty((V, D), device="cuda")
    with pytest.raises(RuntimeError, match="bound route"):
        kernel.launch_bound(x, idx, None, prep, blocks=prep.blocks, out=out,
                            use_plan=kernel.Plan(16, 16, 1))
