"""``repro_torch.launch.hlo_analysis`` against ``repro.launch.hlo_analysis``:
``parse_collectives`` on the reference's own cases and on HLO lines made
from a numpy seed (equal dicts), and ``collectives_from_trace`` on
hand-made traces of each collective over an 8-rank fake process group (in
a subprocess: the group is process-wide), equal to the ring formulas."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.launch.hlo_analysis import parse_collectives as ref_parse
from repro_torch.launch import hlo_analysis as H

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the six cases of tests/test_hlo_analysis.py
REFERENCE_CASES = {
    "scalar_and_simple_shapes":
        "%ar = f32[] all-reduce(%x), replica_groups=[2,4]<=[8]\n"
        "%ag = bf16[16,4096]{1,0} all-gather(%h), "
        "replica_groups=[16,16]<=[256]\n",
    "tuple_shapes_with_index_comments":
        "%ar2 = (f32[64]{0}, f32[64,64]{1,0}, /*index=2*/f32[]) "
        "all-reduce(%a, %b, %c), replica_groups={{0,1,2,3}}\n",
    "get_tuple_element_not_counted":
        "%gte = f32[1,1448,64]{2,1,0} get-tuple-element(%all-to-all), "
        "index=0\n",
    "all_to_all_ring_factor":
        "%a2a = (f32[1,8,4]{2,1,0}, f32[1,8,4]{2,1,0}) all-to-all(%p, %q), "
        "replica_groups=[1,256]<=[256]\n",
    "collective_permute_no_group_discount":
        "%cp = f32[8,128]{1,0} collective-permute(%y), "
        "source_target_pairs={{0,1}}\n",
    "start_done_pairs_counted_once":
        "%ars = f32[256]{0} all-reduce-start(%x), replica_groups=[1,8]<=[8]\n"
        "%ard = f32[256]{0} all-reduce-done(%ars)\n",
}


@pytest.mark.parametrize("name", sorted(REFERENCE_CASES))
def test_reference_cases_equal_the_reference(name):
    text = REFERENCE_CASES[name]
    assert H.parse_collectives(text) == ref_parse(text)


_DTYPES = ("f32", "bf16", "s32", "u8", "pred", "f64", "c64", "token", "s4")
_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute")


def _shape(rng) -> str:
    dt = _DTYPES[rng.integers(len(_DTYPES))]
    dims = ",".join(str(int(d)) for d in
                    rng.integers(1, 300, size=rng.integers(0, 4)))
    layout = "{" + ",".join(map(str, range(len(dims.split(",")) - 1, -1,
                                         -1))) + "}" if dims else ""
    return f"{dt}[{dims}]{layout}"


def _groups(rng) -> str:
    r = rng.integers(4)
    if r == 0:
        n, m = (int(x) for x in rng.integers(1, 33, size=2))
        return f", replica_groups=[{n},{m}]<=[{n * m}]"
    if r == 1:
        ids = ",".join(map(str, rng.permutation(int(rng.integers(1, 17)))))
        return f", replica_groups={{{{{ids}}},{{0,1}}}}"
    if r == 2:
        return ", source_target_pairs={{0,1},{1,2}}"
    return ""


def _line(rng, i: int) -> str:
    kind = rng.integers(6)
    if kind == 5:                  # not a collective
        op = ("fusion", "get-tuple-element", "add", "copy")[
            rng.integers(4)]
        return f"  %x.{i} = {_shape(rng)} {op}(%y.{i}), index=0"
    n = int(rng.integers(1, 5))
    shapes = [_shape(rng) for _ in range(n)]
    if n > 1:
        parts = [s if j < 2 else f"/*index={j}*/{s}"
                 for j, s in enumerate(shapes)]
        shapes_str = "(" + ", ".join(parts) + ")"
    else:
        shapes_str = shapes[0]
    op = _OPS[kind]
    suffix = ("", "-start", "-done")[rng.integers(3)]
    return (f"  %c.{i} = {shapes_str} {op}{suffix}(%a.{i}, %b.{i})"
            f"{_groups(rng)}, channel_id={i}")


@pytest.mark.parametrize("seed", range(5))
def test_seeded_hlo_lines_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    text = "\n".join(_line(rng, i) for i in range(200))
    got, want = H.parse_collectives(text), ref_parse(text)
    assert got == want
    assert want["count"] > 20          # the lines do hold collectives


# ---------------------------------------------------------------------------
# collectives_from_trace over an 8-rank fake group
# ---------------------------------------------------------------------------

_TRACE_SCRIPT = textwrap.dedent("""
    import json
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.hlo_analysis import collectives_from_trace
    from repro_torch.launch.mesh import make_device_mesh

    D.fake_world(8)
    mesh = make_device_mesh((4, 2, 1), ("a", "b", "c"), device="cpu")
    ga, gb, gc = (mesh.get_group(i) for i in range(3))
    out = {}

    def run(name, fn):
        mode = FakeTensorMode()
        with mode:
            x = torch.empty(64, 48, dtype=torch.float32)
            with D.TraceCosts() as tc:
                y = fn(x)
                if isinstance(y, torch.Tensor):
                    y = funcol.wait_tensor(y)
        out[name] = {"records": tc.collectives,
                     "dict": collectives_from_trace(tc.collectives)}

    run("all_reduce", lambda x: funcol.all_reduce(x, "sum", ga))
    run("all_gather", lambda x: funcol.all_gather_tensor(x, 0, gb))
    run("reduce_scatter",
        lambda x: funcol.reduce_scatter_tensor(x, "sum", 0, ga))
    run("all_to_all",
        lambda x: funcol.all_to_all_single(x, None, None, ga))
    run("c10d_all_reduce", lambda x: dist.all_reduce(x, group=gb))
    run("one_rank_group", lambda x: funcol.all_reduce(x, "sum", gc))
    run("world", lambda x: funcol.all_reduce(x, "sum", dist.group.WORLD))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def traced():
    env = {**os.environ,
           "PYTHONPATH": os.path.join(ROOT, "src") + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", _TRACE_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


B = 64 * 48 * 4             # the traced tensor's bytes

# (name, kind, the group's size, bytes the estimate is of, wire bytes)
TRACE_CASES = [
    ("all_reduce", "all-reduce", 4, B, 2 * B * 3 / 4),
    ("all_gather", "all-gather", 2, 2 * B, 2 * B * 1 / 2),
    ("reduce_scatter", "reduce-scatter", 4, B, B * 3 / 4),
    ("all_to_all", "all-to-all", 4, B, B * 3 / 4),
    ("c10d_all_reduce", "all-reduce", 2, B, 2 * B * 1 / 2),
    ("world", "all-reduce", 8, B, 2 * B * 7 / 8),
]


@pytest.mark.parametrize("name,kind,n,size,wire", TRACE_CASES,
                         ids=[c[0] for c in TRACE_CASES])
def test_trace_records_each_collective_once_by_the_ring_formula(
        traced, name, kind, n, size, wire):
    got = traced[name]
    assert got["records"] == [[kind, size, n]]   # the wait is not counted
    want = dict.fromkeys(H.KINDS, 0.0)
    want.update({kind: wire, "count": 1, "total_bytes": wire})
    assert got["dict"] == want


def test_trace_skips_a_group_of_one_rank(traced):
    got = traced["one_rank_group"]
    assert got["records"] == [["all-reduce", B, 1]]
    assert got["dict"]["count"] == 0 and got["dict"]["total_bytes"] == 0.0


def test_collective_permute_record_is_not_discounted():
    # no functional collective is a permute; the record form is HLO's
    got = H.collectives_from_trace([("collective-permute", 1000, 1),
                                    ("collective-permute", 24, 8)])
    assert got["collective-permute"] == 1024.0 and got["count"] == 2
    want = ref_parse("%cp = u8[1000]{0} collective-permute(%y)\n"
                     "%cq = f32[6]{0} collective-permute(%z), "
                     "replica_groups=[1,8]<=[8]\n")
    assert got == want
