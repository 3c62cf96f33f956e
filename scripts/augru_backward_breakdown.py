#!/usr/bin/env python
"""Where the time of ``augru``'s tile backward goes, read without a
profiler's counters (``ncu`` does not run on the card's machine).

Builds copies of ``src/repro_torch/kernels/augru/csrc/augru_backward.cu``
with one part of ``tile::backward_kernel`` taken out or changed (the text
substitutions in ``VARIANTS``) and times each beside the kernel as it is,
on the same inputs and plan (``kernel.backward_plan``), back to back
between CUDA events, in turns (the list, then the list reversed).  A copy
without a part gives wrong gradients: only its time is read, and its
difference from ``as_is`` is what that part costs where it does not
overlap the rest.  ``as_is`` is also held bit-equal to the library that
``kernel.launch_backward`` launches.  One JSON line per variant, then the
card's name and power limit.

    python3 scripts/augru_backward_breakdown.py [--rows 65536] [--steps 100]

Needs one CUDA card and nvcc; the copies are built under the kernels'
``build/`` directory (listed in ``.gitignore``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import cuda_build  # noqa: E402
from repro_torch.kernels.augru import kernel  # noqa: E402

PHASE1 = "#pragma unroll 1\n        for (int k4 = 0; k4 < UG; ++k4) {"
PHASE2 = "#pragma unroll 2\n        for (int g2 = 0; g2 < UG; ++g2) {"
GATES = """            const float rr = sigmoid_f(acc[0][i][q]);
            const float zz = sigmoid_f(acc[1][i][q]);
            const float hn = acc[2][i][q];
            const float nn = tanhf(xn[i] + rr * hn);"""
GATES_CHEAP = """            const float rr = acc[0][i][q] * 0.5f;
            const float zz = acc[1][i][q] * 0.5f;
            const float hn = acc[2][i][q];
            const float nn = xn[i] + rr * hn;"""
BARRIER1 = "      __syncthreads();\n\n      // phase 2: datt"
BARRIER2 = ("          cp_async_wait_all();\n        }\n      }\n"
            "      __syncthreads();")

#: name -> [(text in the source, its replacement)]
VARIANTS = {
    "as_is": [],
    "no_phase1_products": [(PHASE1, PHASE1.replace("k4 < UG", "k4 < 0"))],
    "no_phase2_products": [(PHASE2, PHASE2.replace("g2 < UG", "g2 < 0"))],
    "no_products": [(PHASE1, PHASE1.replace("k4 < UG", "k4 < 0")),
                    (PHASE2, PHASE2.replace("g2 < UG", "g2 < 0"))],
    "no_transcendentals": [(GATES, GATES_CHEAP)],
    "no_products_no_transcendentals": [
        (PHASE1, PHASE1.replace("k4 < UG", "k4 < 0")),
        (PHASE2, PHASE2.replace("g2 < UG", "g2 < 0")), (GATES, GATES_CHEAP)],
    "no_step_barriers": [(BARRIER1, BARRIER1.replace("__syncthreads();", "")),
                         (BARRIER2, BARRIER2.replace("__syncthreads();",
                                                     ""))],
    "phase1_unroll_2": [(PHASE1, PHASE1.replace("unroll 1", "unroll 2"))],
    "phase2_unroll_1": [(PHASE2, PHASE2.replace("unroll 2", "unroll 1"))],
}


def variant_source(subs) -> str:
    text = kernel.BACKWARD_SOURCE.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"the source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=65_536)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("augru_backward_breakdown: no CUDA device", file=sys.stderr)
        return 2
    out_dir = cuda_build.BUILD_ROOT / "augru_backward_breakdown"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, subs in VARIANTS.items():
        path = out_dir / f"{name}.cu"
        path.write_text(variant_source(subs))
        sources[f"augru_bwd_{name}"] = path
    paths = cuda_build.build(sources)
    B, T, H = args.rows, args.steps, 108
    operands = C.augru_backward_operands(B, T, H)
    plan = kernel.backward_plan(B, H, *kernel.device_limits(0))
    if plan.route != "tile":
        raise RuntimeError(f"({B}, {H}) takes the {plan.route} route")
    want = C.augru_backward_outputs(B, T, H)
    kernel.launch_backward(*operands, **want, use_plan=plan)
    got = C.augru_backward_outputs(B, T, H)
    ptrs = [t.data_ptr() for t in operands] + [
        got[k].data_ptr() for k in ("dx_gates", "dhu_n", "datt", "dh0")]
    stream = torch.cuda.current_stream().cuda_stream
    launches, times = {}, {}
    for name in VARIANTS:
        fn = ctypes.CDLL(str(paths[f"augru_bwd_{name}"])
                         ).augru_backward_tile_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launches[name] = (lambda f=fn: f(*ptrs, B, T, H, plan.groups,
                                         plan.threads, plan.blocks, stream))
        if launches[name]() != 0:
            raise RuntimeError(f"{name}: the launch failed")
        torch.cuda.synchronize()
        if name == "as_is" and not all(torch.equal(got[k], want[k])
                                       for k in got):
            raise AssertionError("as_is differs from the kernel's library")
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        times.setdefault(name, []).append(
            C.batched_ms(launches[name], args.reps, 1))
    for name in VARIANTS:
        ptxas = [r for r in C.ptxas_report(
            cuda_build.build_info[f"augru_bwd_{name}"]["log"])
            if r["function"] == "tile::backward_kernel<true>"]
        print(json.dumps({"variant": name, "shape": [B, T, H],
                          "plan": plan._asdict(), "ms": times[name],
                          "ms_source": "cuda_events (batched_ms), in turns",
                          "ptxas": ptxas}), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
