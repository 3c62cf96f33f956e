"""The port's ``edge_score_choose`` and ``edge_score_choose_bits`` against
the reference's two paths.

On the CPU the wrapper runs the plain torch version; it must choose what
the reference's Pallas kernel (interpret mode) and its jitted jnp oracle
choose, with ``best`` bit-equal to the jitted oracle.  The CUDA kernel is
held to the plain version by the ``gpu`` cases, which need a card and are
skipped without one (``chip_smoke.py`` runs the same check on the card).

``edge_score_choose_bits`` reads the packed bit matrices and the cluster
tables itself; on the CPU it must give the ``chosen`` and ``todo`` of the
reference's ``_twopsl_choose`` on both backends, ``best`` bit-equal to the
reference's jitted oracle on operands gathered with numpy, and ``hi`` =
``where(d[u] >= d[v], u, v)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitops as rbitops
from repro.core import partitioning as RP
from repro.kernels.edge_score import edge_score_choose as r_choose
from repro.kernels.edge_score import edge_score_choose_ref as r_ref
from repro_torch.kernels.edge_score import (edge_score_choose,
                                            edge_score_choose_bits,
                                            edge_score_choose_bits_ref,
                                            edge_score_choose_ref, kernel,
                                            launches)

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
    assert launches.by_entry == {"bits": 0, "flags": 0}


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
    assert launches.by_entry["flags"] >= 1
    assert torch.equal(c, c_p)
    assert torch.equal(b.view(torch.int32), b_p.view(torch.int32))


# ---------------------------------------------------------------------------
# the bits entry: the replication state and the cluster tables read in place
# ---------------------------------------------------------------------------

def _bits_state(V, E, k, hosts, seed, n_valid=None):
    """2PS-L's scoring state as numpy arrays: clusters of about three
    vertices, their LPT-like partitions, a third of the replica bits set,
    per-host bits, and a chunk of E edges with the engine's zero-padded
    tail (``valid`` False from ``n_valid``).  The live edges hold self-loops,
    a duplicate, edges inside one cluster and between clusters of one
    partition (both skipped), and exact ties: endpoints with empty rows,
    equal degrees and clusters of equal volume on two partitions."""
    rng = np.random.default_rng(seed)
    n_valid = E if n_valid is None else n_valid
    C = V // 3
    v2c = rng.integers(0, C, V).astype(np.int32)
    vol = rng.integers(1, 1000, C).astype(np.int32)
    c2p = rng.integers(0, k, C).astype(np.int32)
    d = rng.integers(1, 60, V).astype(np.int32)
    bm = rbitops.alloc_np(V, k)
    n = V * k // 3 + 1
    rbitops.set_np(bm, rng.integers(0, V, n), rng.integers(0, k, n))
    H = max(hosts, 1)
    host_of = (np.arange(k) * H // k).astype(np.int32)
    hbm = rbitops.alloc_np(V, H)
    rbitops.set_np(hbm, rng.integers(0, V, V), rng.integers(0, H, V))
    tie_v = rng.choice(V, V // 6, replace=False)
    bm[tie_v], hbm[tie_v], d[tie_v] = 0, 0, 7
    vol[v2c[tie_v]] = 500
    e = rng.integers(0, V, (E, 2))
    r = rng.random(E)
    e[r < 0.1, 1] = e[r < 0.1, 0]                       # self-loops
    same_c = (r >= 0.1) & (r < 0.2)                     # one cluster
    first = {c: i for i, c in reversed(list(enumerate(v2c)))}
    e[same_c, 1] = [first[c] for c in v2c[e[same_c, 0]]]
    tie = (r >= 0.2) & (r < 0.4)
    e[tie] = rng.choice(tie_v, (int(tie.sum()), 2))
    e[E // 2] = e[E // 3]                               # a duplicate
    e[n_valid:] = 0
    valid = np.arange(E) < n_valid
    return dict(bits=bm, d=d, vol=vol, v2c=v2c, c2p=c2p, hbits=hbm,
                host_of=host_of, edges=e.astype(np.int32), valid=valid)


def _torch_bits_state(st, idx=torch.int64):
    t = {key: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                               else a)
         for key, a in st.items()}
    t["edges"] = t["edges"].to(idx)
    return t


def _r_gathered_best(st, pen):
    """The reference's jitted oracle on operands gathered with numpy."""
    u, v = st["edges"][:, 0], st["edges"][:, 1]
    cu, cv = st["v2c"][u], st["v2c"][v]
    pu, pv = st["c2p"][cu], st["c2p"][cv]
    get = rbitops.get_np
    flags = [get(st["bits"], x, p).astype(np.int8)
             for x, p in ((u, pu), (v, pu), (u, pv), (v, pv))]
    host = []
    if pen:
        hu, hv = st["host_of"][pu], st["host_of"][pv]
        host = [get(st["hbits"], x, h).astype(np.int8)
                for x, h in ((u, hu), (v, hu), (u, hv), (v, hv))]
    d, vol = st["d"], st["vol"]
    return _r_ref_jit(d[u], d[v], vol[cu], vol[cv], *flags, pu, pv, *host,
                      dcn_penalty=pen)[1]


@pytest.mark.parametrize("hosts", [0, 2, 4])
@pytest.mark.parametrize("k", [1, 2, 8, 31, 32, 33, 64, 200])
def test_bits_entry_matches_reference(k, hosts):
    """``edge_score_choose_bits`` on the CPU against the reference:
    ``chosen`` and ``todo`` equal to its ``_twopsl_choose`` with the Pallas
    kernel (interpret mode) and with jnp, ``best`` bit-equal to its jitted
    oracle, ``hi`` the higher-degree endpoint; k = 33, 64 and 200 read
    more than one word of each row, the tail is padding."""
    pen = 1.0 if hosts == 2 else (0.5 if hosts else 0.0)
    st = _bits_state(200, 96, k, hosts, seed=k * 10 + hosts, n_valid=80)
    t = _torch_bits_state(st)
    host_kw = (dict(hbits=t["hbits"], host_of=t["host_of"], dcn_penalty=pen)
               if pen else {})
    c, b, todo, hi = edge_score_choose_bits(
        t["bits"], t["d"], t["vol"], t["v2c"], t["c2p"], t["edges"],
        t["valid"], **host_kw)
    assert (c.dtype, b.dtype, todo.dtype, hi.dtype) == (
        torch.int32, torch.float32, torch.bool, torch.int64)
    r_host = (dict(hbits=jnp.asarray(st["hbits"]),
                   host_of=jnp.asarray(st["host_of"]), dcn_penalty=pen)
              if pen else {})
    for backend in ("pallas", "jnp"):
        r_todo, r_chosen, *_ = RP._twopsl_choose(
            jnp.asarray(st["bits"]), st["d"], st["vol"], st["v2c"],
            st["c2p"], jnp.asarray(st["edges"]), jnp.asarray(st["valid"]),
            backend=backend, **r_host)
        np.testing.assert_array_equal(c.numpy(), np.asarray(r_chosen))
        np.testing.assert_array_equal(todo.numpy(), np.asarray(r_todo))
    np.testing.assert_array_equal(b.numpy().view(np.int32),
                                  np.asarray(_r_gathered_best(st, pen))
                                  .view(np.int32))
    u, v = st["edges"][:, 0], st["edges"][:, 1]
    np.testing.assert_array_equal(
        hi.numpy(), np.where(st["d"][u] >= st["d"][v], u, v))
    live = st["valid"]
    assert todo.numpy().sum() < live.sum()        # some edges were skipped


def test_bits_entry_ties_and_settings():
    """Exact ties go to pu; int32 endpoints give the same choice with hi in
    int32; a penalty of 0 ignores the host tables; a penalty without them
    raises; the CPU path counts no launch."""
    st = _bits_state(300, 512, 32, 4, seed=3)
    t = _torch_bits_state(st)
    args = [t[key] for key in ("bits", "d", "vol", "v2c", "c2p", "edges",
                               "valid")]
    launches.reset()
    c, b, todo, hi = edge_score_choose_bits(*args)
    c32, b32, todo32, hi32 = edge_score_choose_bits(
        *args[:5], t["edges"].int(), t["valid"])
    assert hi32.dtype == torch.int32 and torch.equal(hi32.long(), hi)
    assert torch.equal(c32, c) and torch.equal(b32, b)
    assert torch.equal(todo32, todo)
    zero = edge_score_choose_bits(*args, hbits=t["hbits"],
                                  host_of=t["host_of"], dcn_penalty=0.0)
    assert all(torch.equal(x, y) for x, y in zip(zero, (c, b, todo, hi)))
    with pytest.raises(ValueError, match="hbits"):
        edge_score_choose_bits(*args, dcn_penalty=1.0)
    assert launches.count == 0 and launches.by_entry == {"bits": 0,
                                                         "flags": 0}
    # ties: both endpoints with empty rows, equal degrees and volumes
    u, v = st["edges"][:, 0], st["edges"][:, 1]
    pu = st["c2p"][st["v2c"][u]]
    pv = st["c2p"][st["v2c"][v]]
    empty = ~st["bits"].any(1)
    tie = (empty[u] & empty[v] & (st["d"][u] == st["d"][v])
           & (st["vol"][st["v2c"][u]] == st["vol"][st["v2c"][v]])
           & (pu != pv))
    assert tie.sum() > 10
    np.testing.assert_array_equal(c.numpy()[tie], pu[tie])
    for pen in (0.5, 1.0):
        ch, *_ = edge_score_choose_bits(*args, hbits=t["hbits"],
                                        host_of=t["host_of"],
                                        dcn_penalty=pen)
        np.testing.assert_array_equal(ch.numpy()[tie], pu[tie])


def _cuda_bits_args(st, idx, misaligned):
    t = {key: val.cuda() for key, val in _torch_bits_state(st, idx).items()}
    if misaligned:             # a view one id past an aligned base
        flat = torch.zeros(t["edges"].numel() + 1, dtype=idx, device="cuda")
        flat[1:] = t["edges"].reshape(-1)
        t["edges"] = flat[1:].view(-1, 2)
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("E,k,hosts,idx,misaligned", [
    (1, 1, 0, torch.int64, False), (64, 2, 2, torch.int32, False),
    (64, 31, 0, torch.int64, True), (65536, 32, 0, torch.int64, False),
    (65536, 32, 4, torch.int32, True), (65537, 33, 0, torch.int32, False),
    (65537, 64, 8, torch.int64, False), (3000, 200, 4, torch.int64, True),
    (3000, 64, 40, torch.int32, False), (1000, 32, 40, torch.int64, False)])
def test_cuda_bits_entry_matches_plain_version(E, k, hosts, idx, misaligned):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    pen = 0.5 if hosts else 0.0
    st = _bits_state(4096, E, k, hosts, seed=E + k, n_valid=E - E // 10)
    t = _cuda_bits_args(st, idx, misaligned)
    args = [t[key] for key in ("bits", "d", "vol", "v2c", "c2p", "edges",
                               "valid")]
    kw = (dict(hbits=t["hbits"], host_of=t["host_of"], dcn_penalty=pen)
          if hosts else {})
    launches.reset()
    got = edge_score_choose_bits(*args, **kw)
    want = edge_score_choose_bits_ref(*args, **kw)
    torch.cuda.synchronize()
    assert launches.by_entry == {"bits": 1, "flags": 0}
    c, b, todo, hi = got
    assert torch.equal(c, want[0]) and torch.equal(todo, want[2])
    assert torch.equal(hi, want[3])
    assert torch.equal(b.view(torch.int32), want[1].view(torch.int32))


@pytest.mark.gpu
def test_cuda_bits_entry_refuses():
    """The C entry refuses an empty bit matrix under live edges and a
    hosted call without its host tables; the wrapper raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    st = _bits_state(2048, 5000, 32, 4, seed=1)
    t = _cuda_bits_args(st, torch.int64, False)
    args = [t[key] for key in ("bits", "d", "vol", "v2c", "c2p", "edges",
                               "valid")]
    out = dict(chosen=torch.empty(5000, dtype=torch.int32, device="cuda"),
               best=torch.empty(5000, dtype=torch.float32, device="cuda"),
               todo=torch.empty(5000, dtype=torch.bool, device="cuda"),
               hi=torch.empty(5000, dtype=torch.int64, device="cuda"))
    empty = torch.zeros((0, 1), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="edge_score kernel"):
        kernel.launch_bits(empty, *args[1:], None, None, dcn_penalty=0.0,
                           **out)
    no_host = torch.zeros((2048, 0), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="edge_score kernel"):
        kernel.launch_bits(*args, no_host, t["host_of"], dcn_penalty=1.0,
                           **out)


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
