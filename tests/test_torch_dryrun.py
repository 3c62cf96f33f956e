"""``repro_torch.launch.dryrun`` against ``repro.launch.dryrun``, cell by
cell, on the production meshes: the record's keys, the argument bytes (the
reference's per-leaf shard sums, exactly), the output bytes, per-device
FLOPs, the trace's layer count, ``main``'s files; and the shape-only GNN
preparation against a real one.

Each package runs in a subprocess of its own (the reference forces 512
placeholder devices on import, the port starts a fake process group), both
at once, every cell in one call each.  The reference's attention evaluates
kv blocks in a ``lax.scan`` above 8,192 keys, whose body XLA's cost
analysis counts once; its LM cells here run with that scan off
(``BLOCKWISE_KV_THRESHOLD`` raised in the subprocess: the same products,
whole), so both sides count every block.

Where the two sides' FLOPs are expected to differ, the ratio measured on
the CPU (torch 2.13, jax 0.9.0) is pinned within 10%:

- DIEN: the GRU and AUGRU are scans over 100 steps whose body XLA counts
  once (the port counts all 100);
- the GNNs: XLA counts elementwise work (activations, batch norm, masks,
  AdamW), ``torch.utils.flop_counter`` only products.

starcoder2-3b's 24 heads do not divide the 16-wide model axis.  The port
splits each data rank's (row, head) units over it, 16 ways; GSPMD splits
them 8 ways (its attention products, f32[2, 98304, 32768] a device at
prefill: 6 of the 48 units), so the reference counts the attention twice.
Its cells are held within 5% to the products split evenly over the 256
ranks, counted from the config; at prefill the reference within 5% to that
count plus the attention once more.  At decode the reference's count also
holds elementwise work over the cache and products over the whole batch,
and is only held above the port's.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (id, arch, shape, multi_pod, n_layers): n_layers None runs run_cell (the
# full cell), else _cell_costs at that depth
CELLS = [
    ("dien-serve", "dien", "serve_p99", False, None),
    ("dien-train", "dien", "train_batch", False, None),
    ("gin-molecule", "gin-tu", "molecule", False, None),
    ("egnn-molecule", "egnn", "molecule", False, None),
    ("starcoder-decode", "starcoder2-3b", "decode_32k", False, None),
    ("starcoder-prefill-1", "starcoder2-3b", "prefill_32k", False, 1),
    ("starcoder-prefill-2", "starcoder2-3b", "prefill_32k", False, 2),
    ("minitron-prefill-1", "minitron-8b", "prefill_32k", False, 1),
    ("olmoe-train-1", "olmoe-1b-7b", "train_4k", False, 1),
    ("dien-serve-pods", "dien", "serve_p99", True, None),
]
FULL = [c[0] for c in CELLS if c[4] is None]

#: port / reference FLOPs per device, as measured (pinned within 10%);
#: cells not named here nor in ``EVEN_SPLIT`` are held within 5%
FLOPS_RATIO = {
    "dien-serve": 2.617, "dien-serve-pods": 2.617, "dien-train": 3.073,
    "gin-molecule": 0.8826, "egnn-molecule": 0.9817,
}
#: starcoder2-3b's cells: (query length, layers) of the even-split count
EVEN_SPLIT = {"starcoder-decode": (1, 30), "starcoder-prefill-1": (32768, 1),
              "starcoder-prefill-2": (32768, 2)}

_REF_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro.launch import dryrun as RD
    import repro.kernels.flash_attention.ops as FO
    import jax
    import numpy as np
    from repro.launch.mesh import make_production_mesh
    FO.BLOCKWISE_KV_THRESHOLD = 1 << 40

    captured = []
    named = RD._named

    def capture(mesh, spec_tree, abs_tree):
        out = named(mesh, spec_tree, abs_tree)
        captured.append(out)
        return out
    RD._named = capture

    def leaf_bytes(args, shardings):
        out = []
        for leaf, sh in zip(jax.tree.leaves(args), jax.tree.leaves(
                shardings)):
            out.append(int(np.prod(sh.shard_shape(leaf.shape)))
                       * leaf.dtype.itemsize)
        return out

    out = {}
    for cid, arch, shape, mp, n_layers in json.loads(sys.argv[1]):
        mesh = make_production_mesh(multi_pod=mp)
        if n_layers is not None:
            f, b, c = RD._cell_costs(arch, shape, mesh, n_layers=n_layers)
            out[cid] = {"flops": f}
            continue
        captured.clear()
        jitted, args = RD.build_cell(arch, shape, mesh)
        with mesh:
            compiled = jitted.lower(*args).compile()
        per_leaf = leaf_bytes(args, tuple(captured[:2]))
        kept = compiled._executable._kept_var_idx
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(args)[0]]
        n_out = len(jax.tree.leaves(jax.eval_shape(jitted, *args)))
        rec = RD.run_cell(arch, shape, multi_pod=mp, verbose=False)
        out[cid] = {"record": rec, "flops": rec["flops_per_device"],
                    "shard_sum": sum(per_leaf),
                    "unread": {p: b for i, (p, b) in
                               enumerate(zip(paths, per_leaf))
                               if i not in kept},
                    "output_leaves": n_out}
    print(json.dumps(out))
""")

_PORT_SCRIPT = textwrap.dedent("""
    import json, sys
    from repro_torch.launch import dryrun as D

    out = {}
    for cid, arch, shape, mp, n_layers in json.loads(sys.argv[1]):
        if n_layers is not None:
            mesh = D.production_mesh(mp)
            f, b, c = D._cell_costs(arch, shape, mesh, n_layers=n_layers)
            out[cid] = {"flops": f, "bytes": b, "collectives": c}
            continue
        rec = D.run_cell(arch, shape, multi_pod=mp, verbose=False)
        out[cid] = {"record": rec, "flops": rec["flops_per_device"]}
    # the layer count: decode_32k at 1 and 2 layers against its full depth
    mesh = D.production_mesh(False)
    out["depth"] = [D._cell_costs("starcoder2-3b", "decode_32k", mesh,
                                  n_layers=n) for n in (1, 2)]
    print(json.dumps(out))
""")


def _env():
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": os.path.join(ROOT, "src") + os.pathsep
            + os.environ.get("PYTHONPATH", "")}


def _start(script, *args):
    return subprocess.Popen([sys.executable, "-c", script, *args],
                            env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(proc, what):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{what}: {err[-4000:]}"
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both():
    cells = json.dumps([list(c) for c in CELLS])
    ref, port = _start(_REF_SCRIPT, cells), _start(_PORT_SCRIPT, cells)
    return _finish(port, "port"), _finish(ref, "reference")


def _record(side, cid):
    return side[cid]["record"]


@pytest.mark.parametrize("cid", FULL)
def test_record_keys_equal_the_reference(both, cid):
    port, ref = (_record(s, cid) for s in both)
    assert list(port) == list(ref)
    for key in ("memory", "collectives"):
        assert list(port[key]) == list(ref[key])
    for key in ("arch", "shape", "mesh", "multi_pod", "n_devices"):
        assert port[key] == ref[key]
    assert port["compile_s"] == 0.0 and port["lower_s"] > 0


@pytest.mark.parametrize("cid", FULL)
def test_argument_bytes_equal_the_reference_shard_sums(both, cid):
    port, ref = both
    want = ref[cid]["shard_sum"]
    assert _record(port, cid)["memory"]["argument_bytes"] == want
    # XLA drops the arguments the step never reads
    unread = ref[cid]["unread"]
    assert (_record(ref, cid)["memory"]["argument_bytes"]
            + sum(unread.values()) == want)
    if cid.startswith("dien-serve"):
        assert [p for p in unread] == ["[0]['aux_w']"]


@pytest.mark.parametrize("cid", [c for c in FULL if "decode" not in c])
def test_output_bytes_equal_the_reference(both, cid):
    """Equal, but for the 8-byte entry a tuple output of XLA's keeps for
    each of its leaves.  (A decode cell is left out: GSPMD chooses another
    layout for the returned cache than the donated one, the port returns
    the cache it updated in place.)"""
    port, ref = both
    n = ref[cid]["output_leaves"]
    table = 8 * n if n > 1 else 0
    got = _record(port, cid)["memory"]
    assert got["output_bytes"] + table == _record(ref, cid)["memory"][
        "output_bytes"]
    if "train" in cid or "molecule" in cid:     # the donated train state
        assert got["alias_bytes"] == _record(ref, cid)["memory"][
            "alias_bytes"] > 0
        assert got["output_bytes"] - got["alias_bytes"] == 12  # 3 metrics


def test_decode_cache_is_updated_in_place(both):
    mem = _record(both[0], "starcoder-decode")["memory"]
    assert 0 < mem["alias_bytes"] < mem["output_bytes"] < mem[
        "argument_bytes"]
    assert mem["peak_estimate_bytes"] == (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])


@pytest.mark.parametrize("cid", [c[0] for c in CELLS
                                 if c[0] not in EVEN_SPLIT])
def test_flops_per_device_against_the_reference(both, cid):
    port, ref = both
    ratio = port[cid]["flops"] / ref[cid]["flops"]
    want = FLOPS_RATIO.get(cid, 1.0)
    tol = 0.10 if cid in FLOPS_RATIO else 0.05
    assert abs(ratio / want - 1) <= tol, (cid, ratio)


def _even_split(cid):
    """(all products, attention products) a device computes in a
    starcoder2-3b cell with every product split evenly over the (16, 16)
    mesh: each data rank's rows, their tokens' projections and the tied
    head over ``"model"``, their (row, head) units over ``"model"``; the
    attention over the whole key length (the cache's at decode)."""
    from repro_torch.configs import get_arch
    c = next(c for c in CELLS if c[0] == cid)
    cfg = get_arch("starcoder2-3b").make_config()
    sh = get_arch("starcoder2-3b").shapes[c[2]]
    sq, layers = EVEN_SPLIT[cid]
    d, dh = cfg.d_model, cfg.head_dim
    rows = sh["batch"] // 16
    tokens = rows * sq
    proj = d * dh * (cfg.n_heads + 2 * cfg.n_kv_heads) \
        + cfg.n_heads * dh * d + 2 * d * cfg.d_ff
    attn = layers * rows * cfg.n_heads / 16 * 4 * sq * sh["seq"] * dh
    dense = layers * 2 * tokens * proj / 16 + 2 * tokens * d * cfg.vocab / 16
    return dense + attn, attn


@pytest.mark.parametrize("cid", list(EVEN_SPLIT))
def test_starcoder_flops_are_the_even_split(both, cid):
    """24 heads over a 16-wide model axis: the port computes the products
    split evenly over the mesh; GSPMD's 8-way split of the (row, head)
    units counts the attention twice (prefill), and its decode count is
    larger still."""
    port, ref = both
    total, attn = _even_split(cid)
    assert abs(port[cid]["flops"] / total - 1) <= 0.05, (
        cid, port[cid]["flops"], total)
    if "prefill" in cid:
        assert abs(ref[cid]["flops"] / (total + attn) - 1) <= 0.05, (
            cid, ref[cid]["flops"], total + attn)
    else:
        assert ref[cid]["flops"] > port[cid]["flops"]


def test_every_layer_counted_and_affine_in_depth(both):
    """The reference's assumption: the full-depth count is c(1) + (L - 1)
    (c(2) - c(1)), here over the port's eager trace of every layer."""
    port = both[0]
    (f1, b1, c1), (f2, b2, c2) = port["depth"]
    L = 30                                   # starcoder2-3b's layers
    full = _record(port, "starcoder-decode")
    assert full["flops_per_device"] == f1 + (L - 1) * (f2 - f1)
    assert full["bytes_per_device"] == b1 + (L - 1) * (b2 - b1)
    got = full["collectives"]
    for k in ("count", "total_bytes"):
        assert got[k] == pytest.approx(c1[k] + (L - 1) * (c2[k] - c1[k]),
                                       rel=1e-12)
    assert f2 > f1 > 0


def test_prefill_layers_add_equal_costs(both):
    port = both[0]
    one, two = port["starcoder-prefill-1"], port["starcoder-prefill-2"]
    assert two["flops"] > one["flops"] > 0
    assert two["collectives"]["count"] > one["collectives"]["count"]


def test_main_writes_the_reference_tags_and_fails_an_unknown_shape(
        tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "dien",
         "--shape", "serve_p99,no_such_shape", "--mesh", "both", "--out",
         str(tmp_path)], env=_env(), cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert sorted(os.listdir(tmp_path)) == [
        "dien__no_such_shape__16x16.json.failed",
        "dien__no_such_shape__2x16x16.json.failed",
        "dien__serve_p99__16x16.json", "dien__serve_p99__2x16x16.json"]
    rec = json.loads((tmp_path / "dien__serve_p99__2x16x16.json").read_text())
    assert rec["mesh"] == "2x16x16" and rec["n_devices"] == 512
    assert rec["multi_pod"] is True
    assert "KeyError" in (tmp_path / "dien__no_such_shape__16x16.json"
                          ".failed").read_text()
    assert "=== dry-run complete: 2 ok, 2 failed ===" in proc.stdout


def test_importing_the_module_starts_no_process_group():
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun\n"
            "print(dist.is_initialized())\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "False"


# ---------------------------------------------------------------------------
# the shape-only GNN preparation
# ---------------------------------------------------------------------------

def _uniform_batch(n_graphs: int, nodes: int, degree: int, seed: int):
    """A batch whose every node has ``degree`` in-edges and ``degree``
    out-edges, in a random order, and whose graphs have ``nodes`` nodes
    each: no hub row, no id out of range, uniform degrees both ways (the
    reverse preparation's too)."""
    rng = np.random.default_rng(seed)
    N = n_graphs * nodes
    dst = rng.permutation(np.repeat(np.arange(N), degree))
    src = rng.permutation(np.repeat(np.arange(N), degree))
    return {"edges": torch.from_numpy(np.stack([src, dst], 1)
                                      .astype(np.int32)),
            "edge_mask": torch.ones(dst.size),
            "node_mask": torch.ones(N),
            "graph_ids": torch.from_numpy(
                np.repeat(np.arange(n_graphs), nodes).astype(np.int32))}


def _shapes(obj, prefix=""):
    """{path: (shape, dtype)} of every tensor in a GraphPrep, its
    TilePreps, bound and reverse edges; ints as themselves."""
    import dataclasses
    out = {}
    if isinstance(obj, torch.Tensor):
        return {prefix: (tuple(obj.shape), obj.dtype)}
    if isinstance(obj, int):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            if f.name in ("rows", "marks"):
                continue
            out.update(_shapes(getattr(obj, f.name), f"{prefix}.{f.name}"))
    return out


@pytest.mark.parametrize("n_graphs,nodes,degree,reverse", [
    (1, 40, 3, False), (1, 40, 3, True), (4, 30, 2, True),
    (8, 64, 5, True), (2, 1000, 1, False), (3, 300, 7, True)])
def test_abstract_graph_prep_has_the_real_shapes(n_graphs, nodes, degree,
                                                 reverse):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import gnn as G
    batch = _uniform_batch(n_graphs, nodes, degree, seed=nodes + degree)
    real = G.graph_prep(batch, n_graphs, reverse=reverse)
    with FakeTensorMode() as mode:
        fake = G.graph_prep({k: mode.from_tensor(v) for k, v in
                             batch.items()}, n_graphs, reverse=reverse,
                            abstract=True)
    assert _shapes(fake) == _shapes(real)
    assert real.edges.hub_rows.numel() == 0          # H = 0 here
    assert (fake.edges.reverse is None) == (real.edges.reverse is None)
    if reverse:
        assert _shapes(fake.edges.reverse) == _shapes(real.edges.reverse)


def test_abstract_graph_prep_reads_no_id_under_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.models import gnn as G
    with FakeTensorMode():
        batch = {"edges": torch.empty(5000, 2, dtype=torch.int32),
                 "edge_mask": torch.empty(5000),
                 "node_mask": torch.empty(1000),
                 "graph_ids": torch.empty(1000, dtype=torch.int32)}
        gp = G.graph_prep(batch, 10, reverse=True, abstract=True)
        assert gp.edges.perm.shape == (5000,)
        assert gp.edges.reverse.prep.row_ptr.shape == (1001,)
        assert gp.graphs.row_ptr.shape == (11,)
        with pytest.raises(Exception):
            G.graph_prep(batch, 10)              # the real one reads ids


def test_a_given_prep_replaces_the_step_cache():
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as S
    cfg = get_arch("gin-tu").make_smoke_config()
    assert S.make_gnn_train_step(cfg, "molecule").prep_cache is not None
    assert S.make_gnn_train_step(cfg, "molecule",
                                 prep=object()).prep_cache is None
