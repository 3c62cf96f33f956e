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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmm import prepare_tiles as r_prepare_tiles
from repro.kernels.spmm import segment_sum_tiles as r_segment_sum_tiles
from repro.kernels.spmm import spmm as r_spmm
from repro.kernels.spmm import spmm_ref as r_spmm_ref
from repro_torch.kernels.spmm import (launches, prepare_tiles,
                                      segment_sum_ref, segment_sum_tiles,
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
    assert launches.count == 0


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
