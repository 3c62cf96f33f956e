#!/usr/bin/env python3
"""Drive the PyTorch port's 2PS-L path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each (any failure raises and exits non-zero):

1. env        the card (nvidia-smi name and power limit), torch and CUDA.
2. build      every kernel of the path, compiled from ``src/`` with one
              nvcc per source, all started together.
3. kernels    each kernel against its plain torch version on the card, at
              the main path's shapes plus ragged, zero-padded and tied
              rows, flat and host-aware; CUDA-event timings.
4. main_path  the port's CLI on an RMAT-21 stream (the user's entry point,
              through ``MemmapEdgeStream``), k=32, with the kernels'
              launch counters reset just before and read just after.
5. hosted     the host-aware path (4 host groups, dcn_penalty 1.0).
6. card_vs_cpu  the same run on the card and on the CPU: byte-equal.
7. least_loaded_rounds  the overflow tail as shipped (one ``.any()``
              host sync, rounds skipped when nothing is pending) against
              running its k+1 rounds unconditionally.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks used for bounds (NVIDIA's data sheet: HBM3 bandwidth and
#: float32 rate outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 200, warmup: int = 20) -> float:
    """Median of per-call CUDA-event timings."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# edge_score inputs: random rows, a zero-padded tail, exact ties
# ---------------------------------------------------------------------------

def edge_score_inputs(E: int, seed: int, hosted: bool, device):
    import torch
    rng = np.random.default_rng(seed)
    du = rng.integers(1, 5000, E).astype(np.int32)
    dv = rng.integers(1, 5000, E).astype(np.int32)
    vu = rng.integers(1, 200_000, E).astype(np.int32)
    vv = rng.integers(1, 200_000, E).astype(np.int32)
    flags = [rng.integers(0, 2, E).astype(bool) for _ in range(4)]
    hflags = [rng.integers(0, 2, E).astype(bool) for _ in range(4)]
    pu = rng.integers(0, 32, E).astype(np.int32)
    pv = rng.integers(0, 32, E).astype(np.int32)
    n_pad = E // 10          # the engine's padded tail: all-zero rows
    live = E - n_pad
    # exact ties: equal degrees, volumes and mirrored flags on two
    # distinct candidates score identically; the kernel must pick pu
    tie = rng.choice(live, size=live // 10, replace=False) if live else []
    dv[tie], vv[tie] = du[tie], vu[tie]
    flags[2][tie], flags[3][tie] = flags[0][tie], flags[1][tie]
    hflags[2][tie], hflags[3][tie] = hflags[0][tie], hflags[1][tie]
    pv[tie] = (pu[tie] + 1) % 32
    for a in (du, dv, vu, vv, pu, pv, *flags, *hflags):
        a[live:] = 0
    t = [torch.from_numpy(a).to(device) for a in
         (du, dv, vu, vv, *flags, pu, pv)]
    host = [torch.from_numpy(a).to(device) for a in hflags] if hosted else []
    return t, host, np.asarray(tie, np.int64)


def check_edge_score(sizes, penalties) -> dict:
    """The CUDA kernel against its plain version on the card (and the
    plain version on the card against the CPU) — chosen equal, best
    bit-equal."""
    import torch
    from repro_torch.kernels.edge_score import (edge_score_choose,
                                                edge_score_choose_ref)
    cases, max_err = [], 0.0
    for E in sizes:
        for pen in penalties:
            args, host, tie = edge_score_inputs(E, seed=E, hosted=bool(pen),
                                                device="cuda")
            c_k, b_k = edge_score_choose(*args, *host, dcn_penalty=pen)
            c_p, b_p = edge_score_choose_ref(*args, *host, dcn_penalty=pen)
            cpu = [a.cpu() for a in args + host]
            c_c, b_c = edge_score_choose_ref(*cpu, dcn_penalty=pen)
            torch.cuda.synchronize()
            c_k, b_k, c_p, b_p = (x.cpu() for x in (c_k, b_k, c_p, b_p))
            mism = int((c_k != c_p).sum())
            bits_diff = int((b_k.view(torch.int32)
                             != b_p.view(torch.int32)).sum())
            cpu_diff = int((c_p != c_c).sum()) + int(
                (b_p.view(torch.int32) != b_c.view(torch.int32)).sum())
            ties_to_pu = bool((c_k[tie] == args[8].cpu()[tie]).all())
            err = float((b_k - b_p).abs().max()) if E else 0.0
            max_err = max(max_err, err)
            cases.append({"E": E, "dcn_penalty": pen,
                          "chosen_mismatches": mism,
                          "best_bit_mismatches": bits_diff,
                          "plain_card_vs_cpu_mismatches": cpu_diff,
                          "ties": len(tie), "ties_to_pu": ties_to_pu})
            if mism or bits_diff or cpu_diff or not ties_to_pu:
                raise AssertionError(f"edge_score disagrees: {cases[-1]}")
    return {"tolerance": "exact: chosen equal, best bit-equal",
            "cases": cases, "max_abs_err": max_err}


def device_ms_per_call(fn, reps: int = 100) -> float | None:
    """Device time per call: the summed durations of the CUDA kernels
    that ``reps`` calls of ``fn`` ran, from torch.profiler (CUPTI); None
    when the profiler saw no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3 if us > 0 else None


def time_edge_score(E: int) -> dict:
    """``ms``/``plain_ms``: device time per call (profiler); ``call_ms``/
    ``plain_call_ms``: wall time of one call between CUDA events, which on
    an idle card is the host's launch cost."""
    from repro_torch.kernels.edge_score import (edge_score_choose,
                                                edge_score_choose_ref)
    args, _, _ = edge_score_inputs(E, seed=7, hosted=False, device="cuda")
    call_ms = cuda_time_ms(lambda: edge_score_choose(*args))
    plain_call_ms = cuda_time_ms(lambda: edge_score_choose_ref(*args))
    kernel_ms = device_ms_per_call(lambda: edge_score_choose(*args))
    plain_ms = device_ms_per_call(lambda: edge_score_choose_ref(*args))
    source = "profiler"
    if kernel_ms is None or plain_ms is None:
        kernel_ms, plain_ms, source = call_ms, plain_call_ms, "cuda_events"
    # bytes each input read once, each output written once: 4 int32
    # operands + 4 one-byte flags + 2 int32 candidates in, int32 + float32
    # out; ~22 float32 operations per edge
    nbytes = E * (4 * 4 + 4 * 1 + 2 * 4 + 4 + 4)
    ops = E * 22
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return {"E": E, "ms": kernel_ms, "plain_ms": plain_ms,
            "ms_source": source, "call_ms": call_ms,
            "plain_call_ms": plain_call_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


# ---------------------------------------------------------------------------
# the partitioning path
# ---------------------------------------------------------------------------

def write_graph(scale: int, tmp: str) -> tuple[str, int]:
    from repro_torch.data import rmat_graph
    edges = rmat_graph(scale, edge_factor=16, seed=0)
    path = os.path.join(tmp, f"rmat{scale}.bin")
    np.ascontiguousarray(edges, dtype=np.uint32).tofile(path)
    return path, len(edges)


def run_cli(argv) -> tuple[dict, object]:
    """The port's CLI, its JSON report parsed (the CLI prints it)."""
    from repro_torch.launch.partition import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv + ["--json"])
    return json.loads(buf.getvalue()), res


def check_run(report: dict, res, k: int, num_edges: int) -> dict:
    from repro_torch.core import capacity
    asg = np.asarray(res.assignment)
    if asg.shape != (num_edges,) or asg.min() < 0 or asg.max() >= k:
        raise AssertionError("assignment has rows outside [0, k)")
    sizes = np.bincount(asg, minlength=k)
    cap = capacity(num_edges, k, res.alpha)
    if sizes.max() > cap or not np.array_equal(sizes,
                                               res.quality.part_sizes):
        raise AssertionError(f"sizes {sizes.max()} over capacity {cap} or "
                             f"not the engine's")
    if not report["replication_factor"] >= 1.0:
        raise AssertionError("replication factor below 1")
    return {"max_size": int(sizes.max()), "capacity": cap}


def main_path(scale: int, tmp: str, k: int = 32) -> dict:
    from repro_torch.core import spec_for
    from repro_torch.kernels.edge_score import launches
    t0 = time.perf_counter()
    path, E = write_graph(scale, tmp)
    gen_s = time.perf_counter() - t0
    chunk = spec_for("2psl").chunk_size
    launches.reset()
    t0 = time.perf_counter()
    report, res = run_cli(["--input", path, "--k", str(k),
                           "--out", os.path.join(tmp, "assign.bin")])
    wall = time.perf_counter() - t0
    n_launch = launches.count
    checks = check_run(report, res, k, E)
    chunks = -(-E // chunk)
    if n_launch != chunks:
        raise AssertionError(f"edge_score launched {n_launch} times, "
                             f"expected one per scoring chunk ({chunks})")
    timings = report["timings_s"]
    return {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": E, "vertices": report["vertices"], "k": k,
            "chunk_size": chunk, "graph_gen_s": gen_s, "wall_s": wall,
            "edges_per_s": E / wall, "timings_s": timings,
            "clustering_ms_per_chunk": timings["clustering"] / chunks * 1e3,
            "replication_factor": report["replication_factor"],
            "alpha_measured": report["alpha_measured"],
            "kernel_backend": report["kernel_backend"],
            "edge_score_launches": n_launch, "scoring_chunks": chunks,
            **checks}


def hosted_path(scale: int, tmp: str, k: int = 32) -> dict:
    from repro_torch.core import spec_for
    from repro_torch.kernels.edge_score import launches
    path, E = write_graph(scale, tmp)
    launches.reset()
    t0 = time.perf_counter()
    report, res = run_cli(["--input", path, "--k", str(k), "--hosts", "4",
                           "--dcn-penalty", "1.0"])
    wall = time.perf_counter() - t0
    n_launch = launches.count
    checks = check_run(report, res, k, E)
    chunks = -(-E // spec_for("2psl").chunk_size)
    if n_launch != chunks:
        raise AssertionError(f"hosted: {n_launch} launches for {chunks} "
                             f"scoring chunks")
    if not 1.0 <= report["cross_host_rf"] <= report["replication_factor"]:
        raise AssertionError("cross-host RF outside [1, RF]")
    return {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": E, "k": k, "hosts": 4, "dcn_penalty": 1.0,
            "wall_s": wall, "timings_s": report["timings_s"],
            "replication_factor": report["replication_factor"],
            "cross_host_rf": report["cross_host_rf"],
            "edge_score_launches": n_launch, **checks}


def device_busy_share(fn) -> float | None:
    """Share of a run's wall time the card spent in kernels (the summed
    kernel durations torch.profiler records); None when it records none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA)
    return busy / wall_us if busy > 0 else None


def card_vs_cpu(scale: int, k: int = 32) -> dict:
    from repro_torch.core import InMemoryEdgeStream, run_spec, spec_for
    from repro_torch.data import rmat_graph
    edges = rmat_graph(scale, edge_factor=16, seed=0)
    spec = spec_for("2psl")
    out = {}
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = run_spec(spec, InMemoryEdgeStream(edges), k, device=dev)
        out[f"{dev}_wall_s"] = time.perf_counter() - t0
    a, b = runs["cuda"], runs["cpu"]
    mism = int((a.assignment != b.assignment).sum())
    same_q = (a.quality.replication_factor == b.quality.replication_factor
              and a.quality.balance == b.quality.balance
              and np.array_equal(a.quality.part_sizes, b.quality.part_sizes))
    if mism or not same_q:
        raise AssertionError(f"card vs cpu: {mism} assignment mismatches, "
                             f"quality equal: {same_q}")
    busy = device_busy_share(
        lambda: run_spec(spec, InMemoryEdgeStream(edges), k, device="cuda"))
    return {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": len(edges), "k": k, "assignment_mismatches": mism,
            "replication_factor": a.quality.replication_factor,
            "balance": a.quality.balance, **out,
            "device_busy_share_profiled": busy if busy is not None
            else "not measured"}


def least_loaded_rounds(scale: int, k: int = 32) -> dict:
    """The port's overflow tail (one ``.any()`` host sync that skips the
    rounds when nothing is pending) against running the k+1 rounds
    unconditionally (no sync, ~300 more launches per call); order guarded,
    fixed, fixed, guarded in one process, equal results required."""
    import repro_torch.core.partitioning as P
    from repro_torch.core import InMemoryEdgeStream, run_spec, spec_for
    from repro_torch.data import rmat_graph
    edges = rmat_graph(scale, edge_factor=16, seed=0)
    guarded = P._least_loaded_rounds
    times = {"guarded": [], "fixed": []}
    asg = {}
    try:
        for variant in ("guarded", "fixed", "fixed", "guarded"):
            P._least_loaded_rounds = (guarded if variant == "guarded"
                                      else P._fill_rounds)
            res = run_spec(spec_for("2psl"), InMemoryEdgeStream(edges), k,
                           device="cuda")
            t = res.timings
            times[variant].append(t["prepartition"] + t["scoring"]
                                  + t["writeback"])
            asg[variant] = res.assignment
    finally:
        P._least_loaded_rounds = guarded
    if not np.array_equal(asg["fixed"], asg["guarded"]):
        raise AssertionError("the two overflow tails disagree")
    return {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": len(edges), "k": k,
            "passes_s_any_guard": times["guarded"],
            "passes_s_fixed_rounds": times["fixed"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="RMAT scale of the main-path graph (default 21)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.edge_score import kernel as es_kernel

    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    cuda_build.build({es_kernel.NAME: es_kernel.SOURCE})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": i["seconds"],
                          "ptxas": [ln for ln in i["log"].splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for n, i in cuda_build.build_info.items()}})

    check = check_edge_score((1, 1000, 65536, 65537), (0.0, 0.5, 1.0))
    timing = time_edge_score(65536)
    emit({"phase": "kernels", "edge_score": {**check, **timing}})

    with tempfile.TemporaryDirectory() as tmp:
        mp = main_path(args.scale, tmp)
        emit({"phase": "main_path", **mp})
        emit({"phase": "hosted", **hosted_path(min(args.scale, 18), tmp)})
    emit({"phase": "card_vs_cpu", **card_vs_cpu(min(args.scale, 16))})
    emit({"phase": "least_loaded_rounds",
          **least_loaded_rounds(min(args.scale, 17))})

    main_launches = mp["edge_score_launches"]
    if main_launches == 0:
        raise AssertionError("the main path launched no edge_score kernel")
    emit({"kernels": [{
        "name": "edge_score", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_score/csrc/edge_score.cu",
        "replaces": "src/repro/kernels/edge_score/kernel.py:103",
        "launches": main_launches, "max_abs_err": check["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
