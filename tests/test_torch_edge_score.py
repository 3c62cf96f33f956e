"""The port's ``edge_score_choose`` against the reference's two paths.

On the CPU the wrapper runs the plain torch version; it must choose what
the reference's Pallas kernel (interpret mode) and its jitted jnp oracle
choose, with ``best`` bit-equal to the jitted oracle.  The CUDA kernel is
held to the plain version by the ``gpu`` case, which needs a card and is
skipped without one (``chip_smoke.py`` runs the same check on the card).
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.edge_score import edge_score_choose as r_choose
from repro.kernels.edge_score import edge_score_choose_ref as r_ref
from repro_torch.kernels.edge_score import (edge_score_choose,
                                            edge_score_choose_ref, launches)

_r_ref_jit = jax.jit(r_ref, static_argnames="dcn_penalty")


def _inputs(E, seed, n_valid=None, hosted=False):
    rng = np.random.default_rng(seed)
    n_valid = E if n_valid is None else n_valid
    arrs = [rng.integers(1, 100, E).astype(np.int32),
            rng.integers(1, 100, E).astype(np.int32),
            rng.integers(1, 1000, E).astype(np.int32),
            rng.integers(1, 1000, E).astype(np.int32),
            *(rng.integers(0, 2, E).astype(np.int8) for _ in range(4)),
            rng.integers(0, 16, E).astype(np.int32),
            rng.integers(0, 16, E).astype(np.int32)]
    host = ([rng.integers(0, 2, E).astype(np.int8) for _ in range(4)]
            if hosted else [])
    for a in arrs + host:          # the engine's zero-padded tail
        a[n_valid:] = 0
    return arrs, host


def _check(arrs, host=(), pen=0.0):
    t = [torch.from_numpy(a) for a in list(arrs) + list(host)]
    c, b = edge_score_choose(*t, dcn_penalty=pen)
    c_p, b_p = r_choose(*arrs, *host, dcn_penalty=pen, interpret=True)
    c_j, b_j = _r_ref_jit(*arrs, *host, dcn_penalty=pen)
    c, b = c.numpy(), b.numpy()
    assert c.dtype == np.int32 and b.dtype == np.float32
    assert np.all(np.isfinite(b))
    np.testing.assert_array_equal(c, np.asarray(c_p))
    np.testing.assert_array_equal(c, np.asarray(c_j))
    np.testing.assert_array_equal(b.view(np.int32),
                                  np.asarray(b_j).view(np.int32))
    return c, b


@pytest.mark.parametrize("E", [1, 5, 128, 1024, 3000])
def test_matches_reference(E):
    _check(*_inputs(E, seed=E))


@pytest.mark.parametrize("n_valid", [0, 1, 1000])
def test_padded_streaming_chunk(n_valid):
    """Fixed-size chunks whose tail (or, for the all-invalid tail chunk, the
    whole chunk) is zero padding: du=dv=0, rep=0, pu=pv=0."""
    _check(*_inputs(2048, seed=n_valid, n_valid=n_valid))


def test_exact_ties_go_to_pu():
    """Equal degrees, volumes and mirrored flags on two distinct candidates
    score identically; the first candidate wins, as in the reference."""
    arrs, host = _inputs(512, seed=9, hosted=True)
    du, dv, vu, vv, ru1, rv1, ru2, rv2, pu, pv = arrs
    dv[:] = du
    vv[:] = vu
    ru2[:], rv2[:] = ru1, rv1
    host[2][:], host[3][:] = host[0], host[1]
    pv[:] = (pu + 1) % 16
    for pen, h in ((0.0, ()), (1.0, host)):
        c, _ = _check(arrs, h, pen)
        np.testing.assert_array_equal(c, pu)


@pytest.mark.parametrize("E,pen", [(5, 0.5), (128, 1.0), (1024, 2.5)])
def test_host_variant_matches_reference(E, pen):
    arrs, host = _inputs(E, seed=E + 1, hosted=True)
    _check(arrs, host, pen)
    # penalty 0: the host flags are ignored, the flat expression runs
    t = [torch.from_numpy(a) for a in arrs]
    h = [torch.from_numpy(a) for a in host]
    c0, b0 = edge_score_choose(*t, *h, dcn_penalty=0.0)
    cf, bf = edge_score_choose(*t)
    assert torch.equal(c0, cf) and torch.equal(b0, bf)


def test_cpu_path_counts_no_launch():
    launches.reset()
    _check(*_inputs(64, seed=3))
    assert launches.count == 0


@pytest.mark.gpu
@pytest.mark.parametrize("E,pen", [(1, 0.0), (1000, 0.0), (65536, 0.0),
                                   (65537, 1.0)])
def test_cuda_kernel_matches_plain_version(E, pen):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    arrs, host = _inputs(E, seed=E, hosted=bool(pen))
    t = [torch.from_numpy(a).cuda() for a in arrs + host]
    before = launches.count
    c, b = edge_score_choose(*t, dcn_penalty=pen)
    c_p, b_p = edge_score_choose_ref(*t, dcn_penalty=pen)
    torch.cuda.synchronize()
    assert launches.count == before + 1
    assert torch.equal(c, c_p)
    assert torch.equal(b.view(torch.int32), b_p.view(torch.int32))


def test_cuda_build_compiles_once_and_cleans_up(tmp_path, monkeypatch):
    """The build machinery with a stand-in compiler (this machine has no
    nvcc): one compile per source, cached by content, and a failed compile
    raises and leaves no partial library behind."""
    from repro_torch.kernels import cuda_build
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    calls = tmp_path / "calls"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo run >> {calls}\n"
        'case "$*" in *bad.cu*) echo "error: bad kernel"; exit 2;; esac\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && echo lib > "$2"; shift;'
        " done\n"
        'echo "ptxas info    : Used 28 registers, used 0 barriers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "build_info", {})
    good, bad = tmp_path / "good.cu", tmp_path / "bad.cu"
    good.write_text("// kernel\n")
    bad.write_text("// kernel\n")

    path = cuda_build.build({"good": good})["good"]
    assert path.read_text() == "lib\n"
    assert "registers" in cuda_build.build_info["good"]["log"]
    cuda_build.build({"good": good})               # cached: no compile
    assert calls.read_text().count("run") == 1
    good.write_text("// kernel, edited\n")          # new hash: rebuilds
    assert cuda_build.build({"good": good})["good"] != path
    assert calls.read_text().count("run") == 2

    with pytest.raises(RuntimeError, match="nvcc failed for bad"):
        cuda_build.build({"bad": bad})
    bad_dir = cuda_build.library_path("bad", bad).parent
    assert not any(bad_dir.iterdir())
