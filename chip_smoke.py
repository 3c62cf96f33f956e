#!/usr/bin/env python3
"""Drive the PyTorch port's partitioning, DIEN serving, LM serving, GNN
aggregation and embedding pooling paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each (any failure raises and exits non-zero):

1. env        the card (nvidia-smi name and power limit), torch and CUDA.
2. build      every kernel (``edge_score``, ``hdrf_score``, ``augru``,
              ``flash_attention``, ``spmm``, ``embedding_bag``), compiled
              from ``src/`` with one nvcc per source, all started together.
3. kernels    each kernel against its plain torch version on the card, at
              the paths' shapes plus ragged, zero-padded and tied rows,
              flat and host-aware (``augru``: att == 1 and random, and an
              H whose U does not fit in shared memory, within 1e-5;
              ``flash_attention``: the reference test's cases,
              starcoder2-3b's heads at 4,096 tokens, decode and chunked
              prefill, and the prefill layer (1, 24/2, 32,768, 128) in the
              model's layout in both dtypes, within 2e-5 in float32 and
              2e-2 in bf16, each bf16 element also within 2^-7 of the
              plain output plus 1e-5; ``spmm`` and ``segment_sum_tiles``:
              the reference test's cases weighted and not, no edges,
              isolated nodes, wrapped and clamped src, int64 indices, bf16
              rows and hubs above the split length, with and without the
              split; ``embedding_bag``: the reference test's cases, no
              weights, an all-zero bag in ``mean``, wrapped and clamped
              indices, int64 indices, a bf16 table and an empty bag; both
              within 1e-5 of each element's absolute sum plus 1e-6);
              device and CUDA-event timings, ``augru`` beside cuDNN's GRU
              and ``flash_attention`` beside SDPA's flash backend.
4. recsys_serve  DIEN at full width through the serving CLI (``python -m
              repro_torch.launch.serve --arch dien --full --requests N``):
              ``serve_p99`` (512) after a warm-up, ``serve_bulk`` as four
              calls of 65,536; exactly 2 ``augru`` launches per call.
5. recsys_retrieval  the retrieval step at 1 user x 1,000,000 candidates,
              top 100: 1 ``augru`` launch per call.
6. recsys_card_vs_cpu  the same full-width weights on the card and on the
              CPU: CTR and top-100 values within 1e-5, equal top-100 sets.
7. lm_prefill  starcoder2-3b at full width and depth (bf16, 30 layers):
              ``make_lm_prefill_step`` on (1, 32,768) tokens, one warm-up
              and two timed calls (and one profiled); exactly 30
              ``flash_attention`` launches per call.
8. lm_serve   ``python -m repro_torch.launch.serve --arch starcoder2-3b
              --full --requests 4 --max-new 16``: greedy decode through the
              plain GQA attention, no kernel launch.
9. lm_card_vs_cpu  starcoder2-3b's widths in float32: 2 layers on (1, 512)
              tokens, card against CPU; all 30 layers on (1, 2,048) on the
              card, through the kernel against through the plain attention
              (last logits within 1e-3 of their largest magnitude, the same
              argmax).
10. main_path  2PS-L through the port's partitioning CLI on an RMAT-19
              stream (the user's entry point, through
              ``MemmapEdgeStream``), k=32.
11. hosted     the host-aware 2PS-L path (RMAT-18, 4 host groups,
              dcn_penalty 1.0).
12. two_ps_hdrf  2PS-HDRF through the CLI at RMAT-20 (``--scale``): one
              ``hdrf_score`` launch per scoring chunk, no ``edge_score``.
13. hdrf_baselines  HDRF, Greedy and host-aware HDRF through the CLI at
              RMAT-16: one ``hdrf_score`` launch per non-empty 64-edge
              micro-batch.
14. hash      DBH, Grid and Random through the CLI at RMAT-20.
15. gnn_aggregate  one GIN layer's neighbour sum at ogb_products' scale:
              4 relabelled copies of the RMAT-20 graph (~2.58M nodes,
              ~64.3M edges), ``prepare_tiles`` on the host, ``spmm(h, src,
              edge_mask, prep)`` at gin-tu's D = 64 (a warm-up and 5 calls)
              and ``segment_sum_tiles`` of (E, 70) messages (a warm-up and
              2 calls), exactly one ``spmm`` launch per call; the outputs
              against the plain versions, timed beside cuSPARSE's SpMM and
              without the hub split.
16. bag_pool  ``embedding_bag`` over DIEN's 2,097,152 x 18 item table with
              ``InteractionStream`` histories (seq 100, ``hist_mask`` as
              the weights) at 512 and 65,536 bags, ``sum`` and ``mean``: a
              warm-up and 3 calls each, exactly one launch per call; timed
              beside ``F.embedding_bag``.
17. ops_card_vs_cpu  ``spmm`` at D = 64 on a relabelled RMAT-16 graph and
              ``embedding_bag`` at 512 bags, on the card and on the CPU
              through the same op, within the kernels' tolerance.
18. card_vs_cpu  the same runs on the card and on the CPU: byte-equal
              (2PS-L at RMAT-16; 2PS-HDRF, HDRF and Greedy at RMAT-14);
              the card's busy share profiled over the first 2^18 (2PS-L)
              or 2^15 edges.
19. least_loaded_rounds  the overflow tail as shipped (one ``.any()``
              host sync, rounds skipped when nothing is pending) against
              running its k+1 rounds unconditionally (2PS-L, RMAT-16).

Every path phase resets every kernel's launch counter just before it and
checks the counts just after.

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

#: H100 SXM peaks used for bounds (NVIDIA's data sheet: HBM3 bandwidth,
#: float32 rate outside the tensor cores, dense bf16 tensor-core rate)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; phase lines carry ``t_s``, the seconds since start."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T0}
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


def batched_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Time per call of ``reps`` back-to-back calls between two CUDA
    events: the device time where the card, not the host's launches, sets
    the pace."""
    import torch
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def launch_ms(fn, kernel: str, reps: int = 50) -> tuple[float | None, int]:
    """The mean device duration of the recorded launches of the CUDA
    kernel whose name holds ``kernel`` over ``reps`` profiled calls of
    ``fn`` (None when none was recorded), and how many were recorded: late
    in a long run the profiler has kept as few as ~30% of its records, so
    a mean over what it kept, not a sum over ``reps``."""
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
    us = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return (sum(us) / len(us) / 1e3 if us else None), len(us)


def bound(nbytes: float, ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate of their type (float32 by default),
    whichever is larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def timed(fn, plain_fn, reps: int = 100, profile: bool = True) -> dict:
    """``ms``/``plain_ms``: device time per call (profiler); ``call_ms``/
    ``plain_call_ms``: wall time of one call between CUDA events, which on
    an idle card is the host's launch cost.  ``reps`` profiled calls (twice
    as many timed by events).  ``profile=False`` takes the events' times
    for calls of tens of ms, where the launch cost vanishes (over 3 such
    calls the profiler lost a kernel's record)."""
    warmup = max(1, reps // 5)
    call_ms = cuda_time_ms(fn, 2 * reps, warmup)
    plain_call_ms = cuda_time_ms(plain_fn, 2 * reps, warmup)
    kernel_ms = device_ms_per_call(fn, reps) if profile else None
    plain_ms = device_ms_per_call(plain_fn, reps) if profile else None
    source = "profiler"
    if kernel_ms is None or plain_ms is None:
        kernel_ms, plain_ms, source = call_ms, plain_call_ms, "cuda_events"
    return {"ms": kernel_ms, "plain_ms": plain_ms, "ms_source": source,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms}


def time_edge_score(E: int) -> dict:
    from repro_torch.kernels.edge_score import (edge_score_choose,
                                                edge_score_choose_ref)
    args, _, _ = edge_score_inputs(E, seed=7, hosted=False, device="cuda")
    # bytes each input read once, each output written once: 4 int32
    # operands + 4 one-byte flags + 2 int32 candidates in, int32 + float32
    # out; ~22 float32 operations per edge
    return {"E": E, **timed(lambda: edge_score_choose(*args),
                            lambda: edge_score_choose_ref(*args)),
            **bound(E * (4 * 4 + 4 * 1 + 2 * 4 + 4 + 4), E * 22),
            "library_ms": None}


# ---------------------------------------------------------------------------
# hdrf_score inputs: random rows, a zero-padded tail, all-zero flag rows
# ---------------------------------------------------------------------------

HDRF_LAM = 1.1


def hdrf_inputs(E: int, k: int, seed: int, hosts: int, equal_sizes: bool,
                device):
    """Degrees, (E, k) flags and sizes as the chunk functions build them.
    A tenth of the live rows have no replica anywhere; with
    ``equal_sizes`` every partition of such a row scores the same, and the
    kernel must pick partition 0."""
    import torch
    from repro_torch.core.scoring import host_any
    rng = np.random.default_rng(seed)
    du = rng.integers(1, 5000, E).astype(np.int32)
    dv = rng.integers(1, 5000, E).astype(np.int32)
    ru = rng.random((E, k)) < 0.3
    rv = rng.random((E, k)) < 0.3
    sizes = (np.full(k, 1000, np.int32) if equal_sizes
             else rng.integers(0, 100_000, k).astype(np.int32))
    n_pad = E // 10
    live = E - n_pad
    tie = rng.choice(live, size=live // 10, replace=False) if live else []
    ru[tie], rv[tie] = False, False
    for a in (du, dv, ru, rv):
        a[live:] = 0
    t = [torch.from_numpy(a).to(device) for a in (du, dv, ru, rv, sizes)]
    host = ([host_any(t[2], hosts), host_any(t[3], hosts)] if hosts
            else [])
    return t, host, np.asarray(tie, np.int64)


def check_hdrf_score(sizes, ks) -> dict:
    """The CUDA kernel against its plain version on the card (and the
    plain version on the card against the CPU), flat and host-aware
    (4 hosts, penalty 0.7, where 4 divides k), HDRF and Greedy, random
    and equal partition sizes: chosen equal, best bit-equal."""
    import torch
    from repro_torch.kernels.hdrf_score import hdrf_choose, hdrf_choose_ref
    cases, max_err = [], 0.0
    for E in sizes:
        for k in ks:
            for dw in (True, False):
                for pen, hosts in ((0.0, 0), (0.7, 4)):
                    if hosts and k % hosts:
                        continue
                    for eq in (False, True):
                        args, host, tie = hdrf_inputs(
                            E, k, seed=E + k, hosts=hosts, equal_sizes=eq,
                            device="cuda")
                        kw = dict(lam=HDRF_LAM, dcn_penalty=pen,
                                  degree_weighted=dw)
                        c_k, b_k = hdrf_choose(*args, *host, **kw)
                        c_p, b_p = hdrf_choose_ref(*args, *host, **kw)
                        cpu = [a.cpu() for a in args + host]
                        c_c, b_c = hdrf_choose_ref(*cpu, **kw)
                        torch.cuda.synchronize()
                        c_k, b_k, c_p, b_p = (x.cpu() for x in
                                              (c_k, b_k, c_p, b_p))
                        mism = int((c_k != c_p).sum())
                        bits_diff = int((b_k.view(torch.int32)
                                         != b_p.view(torch.int32)).sum())
                        cpu_diff = int((c_p != c_c).sum()) + int(
                            (b_p.view(torch.int32)
                             != b_c.view(torch.int32)).sum())
                        ties_to_0 = (not eq) or bool((c_k[tie] == 0).all())
                        err = float((b_k - b_p).abs().max()) if E else 0.0
                        max_err = max(max_err, err)
                        cases.append({
                            "E": E, "k": k, "degree_weighted": dw,
                            "dcn_penalty": pen, "equal_sizes": eq,
                            "chosen_mismatches": mism,
                            "best_bit_mismatches": bits_diff,
                            "plain_card_vs_cpu_mismatches": cpu_diff,
                            "tie_rows": len(tie) if eq else 0,
                            "ties_to_partition_0": ties_to_0})
                        if mism or bits_diff or cpu_diff or not ties_to_0:
                            raise AssertionError(
                                f"hdrf_score disagrees: {cases[-1]}")
    return {"tolerance": "exact: chosen equal, best bit-equal",
            "cases": len(cases),
            "tie_rows": sum(c["tie_rows"] for c in cases),
            "chosen_mismatches": 0, "best_bit_mismatches": 0,
            "max_abs_err": max_err}


def time_hdrf_score(E: int, k: int = 32) -> dict:
    from repro_torch.kernels.hdrf_score import hdrf_choose, hdrf_choose_ref
    args, _, _ = hdrf_inputs(E, k, seed=7, hosts=0, equal_sizes=False,
                             device="cuda")
    # bytes each input read once, each output written once: two int32
    # degrees + 2k one-byte flags per edge and k int32 sizes in, int32 +
    # float32 out; ~5 float32 operations per edge (theta, g) and ~3 per
    # (edge, partition) (two adds, the compare)
    return {"E": E, "k": k,
            **timed(lambda: hdrf_choose(*args, lam=HDRF_LAM),
                    lambda: hdrf_choose_ref(*args, lam=HDRF_LAM)),
            **bound(E * (4 + 4 + 2 * k + 4 + 4) + 4 * k, E * (5 + 3 * k)),
            "library_ms": None}


# ---------------------------------------------------------------------------
# augru inputs: the reference test's distributions, att == 1 or random
# ---------------------------------------------------------------------------

AUGRU_TOL = 1e-5
#: (B, T, H) checked on the card: the reference test's shapes, the serve
#: paths', an H whose U (3H^2 float32, 307 KB) does not fit in shared
#: memory, so the kernel reads it from global memory, and one whose
#: recurrent state does not fit either, so it lives in global scratch
AUGRU_CHECK = ((1, 1, 1), (4, 7, 16), (33, 50, 108), (8, 100, 128),
               (512, 100, 108), (65_536, 100, 108), (5, 9, 160),
               (2, 4, 3000))


def augru_inputs(B: int, T: int, H: int, seed: int, ones: bool, device):
    """Drawn on ``device`` from a seeded generator (numpy takes tens of
    seconds for the 2.1e9 gates of a 65,536-row batch).  u ~ N(0, 0.2^2) as
    the reference test draws it, up to H = 1000; beyond, at DIEN's own init
    scale 1/sqrt(H): with 0.2 at H = 3000, |hU| reaches ~10 and two
    summation orders of 3000 float32 terms differ by ~4e-5, which says
    nothing about the kernel."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=device) * scale

    xg = normal((B, T, 3 * H), 0.5)
    u = normal((H, 3 * H), 0.2 if H <= 1000 else 1.0 / np.sqrt(H))
    att = (torch.ones((B, T), device=device) if ones
           else torch.rand((B, T), generator=g, device=device))
    return [xg, u, att, normal((B, H), 0.1)]


def check_augru(shapes) -> dict:
    """The CUDA kernel against its plain version on the card, att == 1 (the
    GRU stage) and random att: every state within ``AUGRU_TOL``."""
    import torch
    from repro_torch.kernels.augru import augru, augru_ref
    cases, max_err = [], 0.0
    for B, T, H in shapes:
        for ones in (True, False):
            args = augru_inputs(B, T, H, seed=B + T + H, ones=ones,
                                device="cuda")
            got = augru(*args)
            want = augru_ref(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            cases.append({"B": B, "T": T, "H": H, "att": "ones" if ones
                          else "random", "max_abs_err": err,
                          "u_bytes": 3 * H * H * 4})
            if not err <= AUGRU_TOL:
                raise AssertionError(f"augru disagrees: {cases[-1]}")
    return {"tolerance": f"max |kernel - plain| <= {AUGRU_TOL}",
            "cases": cases, "max_abs_err": max_err}


def gru_library_ms(B: int, T: int = 100, e: int = 18, H: int = 108,
                   reps: int = 20) -> float:
    """cuDNN's GRU (``torch.nn.GRU``, float32 without TF32) on (B, T, e):
    the dense 18 -> 324 and the GRU recurrence of DIEN's att == 1 stage in
    one library call.  Its z gate is the complement of AUGRU's, so it is a
    yardstick of speed only, never of parity."""
    import torch
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gru = torch.nn.GRU(e, H, batch_first=True).cuda()
        x = torch.randn(B, T, e, device="cuda")
        with torch.no_grad():
            return cuda_time_ms(lambda: gru(x), reps, max(1, reps // 5))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


#: torch.nn.GRU's cuDNN call faults (an illegal memory access, in a
#: process of its own) at batch 65,536 of (100, 18) on the card, and runs
#: at 32,768: the library is timed up to this batch
GRU_MAX_BATCH = 32_768


def time_augru(B: int, T: int = 100, H: int = 108, reps: int = 20,
               profile: bool = True) -> dict:
    import torch
    from repro_torch.kernels.augru import augru, augru_ref
    args = augru_inputs(B, T, H, seed=7, ones=False, device="cuda")
    # bytes: x_gates, u, att, h0 read once, the states written once;
    # operations: the products hU = h @ U, 2*H*3H per (row, step) (the
    # gates add ~1% and are not counted, so the bound stays a lower one)
    nbytes = 4 * (B * T * 3 * H + 3 * H * H + B * T + B * H + B * T * H)
    out = {"B": B, "T": T, "H": H,
           **timed(lambda: augru(*args), lambda: augru_ref(*args), reps,
                   profile),
           **bound(nbytes, 2 * B * T * H * 3 * H),
           "library_ms": (gru_library_ms(B, T, reps=reps)
                          if B <= GRU_MAX_BATCH else None),
           "library": "torch.nn.GRU(18, 108) on (B, 100, 18), cuDNN, "
                      "float32 (the att == 1 stage with its input dense)"
                      if B <= GRU_MAX_BATCH else
                      f"none: cuDNN's GRU faults above batch {GRU_MAX_BATCH}"}
    del args
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# flash_attention inputs: the reference test's cases and the LM's shapes
# ---------------------------------------------------------------------------

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: (B, Hq, Hkv, Sq, Skv, D, causal, dtype) checked on the card: the
#: reference test's seven cases, starcoder2-3b's heads (24 over 2) causal at
#: 4,096 tokens in both dtypes, one decode step against a 32,768-key cache,
#: a chunked prefill, the largest head dim and a ragged one, non-causal
FLASH_CHECK = (
    (1, 2, 2, 128, 128, 64, True, "float32"),
    (2, 4, 2, 256, 256, 32, True, "float32"),
    (1, 8, 1, 64, 64, 128, False, "float32"),
    (1, 2, 2, 100, 100, 16, True, "float32"),
    (1, 4, 2, 1, 512, 64, True, "float32"),
    (1, 2, 1, 130, 390, 32, True, "float32"),
    (1, 2, 2, 128, 128, 64, True, "bfloat16"),
    (1, 24, 2, 4096, 4096, 128, True, "bfloat16"),
    (1, 24, 2, 4096, 4096, 128, True, "float32"),
    (1, 24, 2, 1, 32768, 128, True, "bfloat16"),
    (1, 24, 2, 1000, 5000, 128, True, "bfloat16"),
    (1, 4, 2, 300, 300, 256, True, "float32"),
    (1, 4, 1, 65, 65, 80, False, "float32"),
)
#: the prefill layer's shape, checked in float32 in the model's layout (the
#: bf16 one is checked where it is timed, in ``time_flash_attention``)
FLASH_MAIN = ((1, 24, 2, 32_768, 32_768, 128, True, "float32"),)


def flash_inputs(B, Hq, Hkv, Sq, Skv, D, dtype: str, seed: int, device,
                 model_layout: bool = False):
    """q, k, v ~ N(0, 1), as the reference test draws them, made on
    ``device`` from a seeded generator.  ``model_layout``: v is the (B, Hkv,
    Skv, D) transposed view of a (B, Skv, Hkv, D) tensor, as the LM's value
    projection reaches the kernel (q and k come out of RoPE contiguous)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    v_shape = (B, Skv, Hkv, D) if model_layout else (B, Hkv, Skv, D)
    q, k, v = (torch.randn(shape, generator=g, device=device).to(
        getattr(torch, dtype))
        for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D), v_shape))
    return [q, k, v.transpose(1, 2) if model_layout else v]


#: bf16 outputs: each element within one bf16 rounding of the plain one
#: (both round the same float32 result once, so they differ by at most one
#: unit in the last of bf16's 8 significant bits, 2^-7 of the value) plus
#: 1e-5 for the float32 arithmetic's own differences (float32 cases: below
#: 1e-6)
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-5


def flash_agree(got, want, dtype: str) -> dict:
    """max |kernel - plain| against the reference test's tolerance of the
    dtype; for bf16 also every element against ``BF16_REL`` |plain| +
    ``BF16_ABS``, which, unlike the reference's absolute 2e-2, is smaller
    than the outputs themselves (~0.009 at 32,768 keys)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    line = {"max_abs_err": err, "max_abs_out": float(want.abs().max())}
    ok = err <= FLASH_TOL[dtype]
    if dtype == "bfloat16":
        excess = float((diff / (BF16_REL * want.abs() + BF16_ABS)).max())
        line["max_err_over_elementwise_bound"] = excess
        ok = ok and excess <= 1.0
    line["ok"] = ok
    return line


def check_flash_attention(cases, model_layout: bool = False) -> dict:
    """The CUDA kernel against its plain version (``gqa_attention``, as the
    wrapper runs it on the CPU) on the card, by ``flash_agree``."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import plain_attention
    out, max_err = [], 0.0
    for i, (B, Hq, Hkv, Sq, Skv, D, causal, dtype) in enumerate(cases):
        args = flash_inputs(B, Hq, Hkv, Sq, Skv, D, dtype, seed=i,
                            device="cuda", model_layout=model_layout)
        got = flash_attention(*args, causal=causal)
        want = plain_attention(*args, causal=causal)
        torch.cuda.synchronize()
        out.append({"shape": [B, Hq, Hkv, Sq, Skv, D], "causal": causal,
                    "dtype": dtype, "model_layout": model_layout,
                    **flash_agree(got, want, dtype)})
        max_err = max(max_err, out[-1]["max_abs_err"])
        if not out[-1]["ok"]:
            raise AssertionError(f"flash_attention disagrees: {out[-1]}")
        del args, got, want
    torch.cuda.empty_cache()
    return {"tolerance": f"max |kernel - plain| <= {FLASH_TOL}; bf16 also "
                         f"|kernel - plain| <= {BF16_REL} |plain| + "
                         f"{BF16_ABS} elementwise",
            "cases": out, "max_abs_err": max_err}


def flash_work(B, Hq, Hkv, Sq, Skv, D, causal, itemsize) -> tuple:
    """(bytes, operations) of one call: q, k, v read once and o written
    once; 4 D operations (two multiply-adds of D) per visible (query, key)
    pair and head."""
    off = Skv - Sq
    pairs = (sum(min(Skv, max(0, i + off + 1)) for i in range(Sq))
             if causal else Sq * Skv)
    nbytes = itemsize * D * (2 * B * Hq * Sq + 2 * B * Hkv * Skv)
    return nbytes, 4 * D * pairs * B * Hq


def time_flash_attention(S: int, Hq: int = 24, Hkv: int = 2,
                         D: int = 128) -> dict:
    """One causal bf16 prefill layer of (1, Hq, S, D) in the model's layout
    (``flash_inputs(model_layout=True)``): the kernel's output held to its
    plain version's by ``flash_agree``, then the kernel, the plain version
    and SDPA (flash backend, GQA, causal; a yardstick of speed only, never
    on the port's path) timed between CUDA events on the same inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import plain_attention
    q, k, v = flash_inputs(1, Hq, Hkv, S, S, D, "bfloat16", seed=7,
                           device="cuda", model_layout=True)
    agree = flash_agree(flash_attention(q, k, v), plain_attention(q, k, v),
                        "bfloat16")
    if not agree["ok"]:
        raise AssertionError(f"flash_attention disagrees at the prefill "
                             f"shape: {agree}")
    ms = cuda_time_ms(lambda: flash_attention(q, k, v), reps=3, warmup=1)
    plain_ms = cuda_time_ms(lambda: plain_attention(q, k, v), reps=2,
                            warmup=1)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=10, warmup=2)
    nbytes, ops = flash_work(1, Hq, Hkv, S, S, D, True, 2)
    del q, k, v
    torch.cuda.empty_cache()
    return {"shape": [1, Hq, Hkv, S, S, D], "causal": True,
            "dtype": "bfloat16", "model_layout": True, **agree, "ms": ms,
            "plain_ms": plain_ms, "ms_source": "cuda_events",
            "tflop_per_s": ops / ms / 1e9,
            **bound(nbytes, ops, BF16_OPS_PER_S), "library_ms": lib_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True), flash backend"}


# ---------------------------------------------------------------------------
# spmm and embedding_bag inputs: the reference test's cases and the edges
# ---------------------------------------------------------------------------

#: every element within SUM_REL of the absolute sum of its terms (sum_p
#: |w(p) R[g(p), :]|, or of the bag's) plus SUM_ABS: the kernel and the plain
#: version add in other orders; a bf16 output also within one bf16 rounding
#: of the plain one (BF16_REL |plain|)
SUM_REL, SUM_ABS = 1e-5, 1e-6
SUM_TOL = (f"|kernel - plain| <= {SUM_REL} * sum |w R| + {SUM_ABS} per "
           f"element (+ {BF16_REL} |plain| for a bf16 output)")
#: (V, E, D, options) checked on the card, each weighted and unweighted: the
#: reference test's six cases, no edges, nodes with no in-edge, negative and
#: out-of-range src, int64 indices, bf16 rows, hubs above the split length
#: (one of exactly 1,025 edges, one at a D of two column passes), a wide D
SPMM_CHECK = (
    (50, 300, 16, {}), (300, 2000, 70, {}), (1000, 5000, 128, {}),
    (257, 1, 5, {}), (128, 128, 128, {}), (5, 40, 200, {}),
    (10, 0, 16, {}), (1000, 300, 32, {"isolated": True}),
    (50, 300, 16, {"bad_src": True}), (300, 2000, 70, {"idx": "int64"}),
    (300, 2000, 70, {"dtype": "bfloat16"}),
    (1000, 5000, 128, {"dtype": "bfloat16", "idx": "int64"}),
    (100, 6000, 64, {"hub": 5000}), (200, 3000, 70, {"hub": 1025}),
    (64, 3000, 300, {"hub": 2100, "idx": "int64", "bad_src": True}),
    (40, 600, 520, {}))
#: (V, D, B, L, mode, options): the reference test's four cases, no
#: weights, a bag whose weights are all 0 (mean), negative and
#: out-of-range indices, int64 indices, a bf16 table, an empty bag
BAG_CHECK = (
    (100, 16, 4, 10, "sum", {}), (1000, 18, 33, 100, "mean", {}),
    (50, 128, 8, 5, "sum", {}), (10, 260, 1, 3, "mean", {}),
    (100, 16, 4, 10, "sum", {"unweighted": True}),
    (100, 16, 4, 10, "mean", {"unweighted": True}),
    (100, 16, 4, 10, "mean", {"zero_bag": True}),
    (10, 8, 2, 3, "sum", {"bad_idx": True}),
    (1000, 18, 33, 100, "mean", {"idx": "int64", "bad_idx": True}),
    (1000, 18, 33, 100, "sum", {"dtype": "bfloat16"}),
    (1000, 18, 33, 100, "mean", {"dtype": "bfloat16"}),
    (100, 16, 4, 0, "mean", {}))


def sum_agree(got, want, scale) -> dict:
    """Every element of ``got`` within ``SUM_REL`` * ``scale`` + ``SUM_ABS``
    of ``want`` (plus one bf16 rounding for a bf16 output)."""
    import torch
    rel = BF16_REL if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if diff.numel() == 0:
        return {"max_abs_err": 0.0, "max_err_over_bound": 0.0, "ok": True}
    ratio = float((diff / (SUM_REL * scale.float() + SUM_ABS
                           + rel * want.abs())).max())
    return {"max_abs_err": float(diff.max()), "max_err_over_bound": ratio,
            "ok": ratio <= 1.0}


def spmm_inputs(V, E, D, seed, *, dtype="float32", idx="int32", hub=0,
                isolated=False, bad_src=False):
    """x ~ N(0, 1), w ~ N(0, 1), src and dst uniform (the reference test's
    draws), on the card; ``hub`` edges all into node V // 2, ``isolated``
    leaves three quarters of the nodes without an in-edge, ``bad_src``
    makes every 7th src negative and every 7th out of range."""
    import torch
    from repro_torch.kernels.spmm import prepare_tiles
    rng = np.random.default_rng(seed)
    src = rng.integers(0, V, E)
    dst = rng.integers(0, V, E)
    if isolated:
        dst %= max(1, V // 4)
    dst[:hub] = V // 2
    if bad_src:
        src[::7] = -rng.integers(1, 2 * V + 1, len(src[::7]))
        src[3::7] = V + rng.integers(0, 2 * V, len(src[3::7]))
    w = rng.standard_normal(E).astype(np.float32)
    x = rng.standard_normal((V, D)).astype(np.float32)
    return (torch.from_numpy(x).to("cuda", getattr(torch, dtype)),
            torch.from_numpy(src).to("cuda", getattr(torch, idx)),
            torch.from_numpy(w).cuda(), torch.from_numpy(dst).cuda(),
            prepare_tiles(dst, V).to("cuda"))


def check_spmm(cases) -> dict:
    """``spmm`` (weighted and not) and ``segment_sum_tiles`` through the
    CUDA kernel against ``spmm_ref`` / ``segment_sum_ref`` on the card,
    each element by ``sum_agree``; hub cases also with the split off."""
    from repro_torch.kernels import wrap_clamp_index
    from repro_torch.kernels.spmm import (segment_sum_ref, segment_sum_tiles,
                                          spmm, spmm_ref)
    out, max_err = [], 0.0
    for i, (V, E, D, opt) in enumerate(cases):
        x, src, w, dst, prep = spmm_inputs(V, E, D, seed=i, **opt)
        preps = {"split": prep}
        if prep.n_chunks:
            preps["no_split"] = prep.with_split(None)
        for name, pr in preps.items():
            for wt in (w, None):
                got = spmm(x, src, wt, pr)
                want = spmm_ref(x, src, dst, wt, V)
                scale = spmm_ref(x.float().abs(), src, dst,
                                 None if wt is None else wt.abs(), V)
                out.append({"op": "spmm", "V": V, "E": E, "D": D, **opt,
                            "weighted": wt is not None, "prep": name,
                            "hub_chunks": pr.n_chunks,
                            **sum_agree(got, want, scale)})
            msg = x[wrap_clamp_index(src, V)] * w[:, None].to(x.dtype)
            got = segment_sum_tiles(msg, pr)
            want = segment_sum_ref(msg, dst, V)
            scale = segment_sum_ref(msg.float().abs(), dst, V)
            out.append({"op": "segment_sum_tiles", "V": V, "E": E, "D": D,
                        **opt, "prep": name, **sum_agree(got, want, scale)})
    for line in out:
        max_err = max(max_err, line["max_abs_err"])
        if not line["ok"]:
            raise AssertionError(f"spmm disagrees: {line}")
    ratios = {dt: [c["max_err_over_bound"] for c in out
                   if c.get("dtype", "float32") == dt]
              for dt in ("float32", "bfloat16")}
    return {"tolerance": SUM_TOL, "cases": len(out),
            "max_err_over_bound": {dt: max(r) for dt, r in ratios.items()},
            "max_abs_err": max_err}


def check_embedding_bag(cases) -> dict:
    """``embedding_bag`` through the CUDA kernel against
    ``embedding_bag_ref`` on the card, each element by ``sum_agree``
    (the bag's absolute sum divided, for ``mean``, as the output is)."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)
    out, max_err = [], 0.0
    for i, (V, D, B, L, mode, opt) in enumerate(cases):
        rng = np.random.default_rng(i)
        t = rng.standard_normal((V, D)).astype(np.float32)
        idx = rng.integers(0, V, (B, L))
        w = rng.random((B, L)).astype(np.float32)
        if opt.get("bad_idx"):
            idx[:, ::3] = -rng.integers(1, 2 * V + 1, idx[:, ::3].shape)
            idx[:, 1::3] = V + rng.integers(0, 2 * V, idx[:, 1::3].shape)
        if opt.get("zero_bag"):
            w[1] = 0.0
        t = torch.from_numpy(t).to("cuda",
                                   getattr(torch, opt.get("dtype", "float32")))
        idx = torch.from_numpy(idx).to("cuda",
                                       getattr(torch, opt.get("idx", "int32")))
        w = None if opt.get("unweighted") else torch.from_numpy(w).cuda()
        got = embedding_bag(t, idx, w, mode=mode)
        want = embedding_bag_ref(t, idx, w, mode=mode)
        scale = embedding_bag_ref(t.float().abs(), idx,
                                  None if w is None else w.abs(), mode=mode)
        torch.cuda.synchronize()
        out.append({"V": V, "D": D, "B": B, "L": L, "mode": mode, **opt,
                    **sum_agree(got, want, scale)})
        max_err = max(max_err, out[-1]["max_abs_err"])
        if not out[-1]["ok"]:
            raise AssertionError(f"embedding_bag disagrees: {out[-1]}")
    return {"tolerance": SUM_TOL, "cases": out, "max_abs_err": max_err}


# ---------------------------------------------------------------------------
# the DIEN serving path
# ---------------------------------------------------------------------------

SERVE_TIMED_CALLS = 3
BULK_CALLS, BULK_BATCH = 4, 65_536


def run_serve(argv) -> dict:
    """The port's serving CLI, its JSON report parsed and checked."""
    from repro_torch.launch.serve import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + ["--json"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    if set(report) != {"arch", "mode", "requests", "mean_ctr"}:
        raise AssertionError(f"serve report keys {sorted(report)}")
    if not 0.0 < report["mean_ctr"] < 1.0:
        raise AssertionError(f"mean CTR {report['mean_ctr']} outside (0, 1)")
    return report


def serve_calls(batch: int, seeds, *, warmup: bool) -> dict:
    """``main(--arch dien --full --requests batch --seed s)`` once per
    seed, each with the counters reset just before and read just after
    (exactly 2 augru launches, nothing else); then the serve step alone on
    the first seed's request, timed between CUDA events."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.launch.steps import make_recsys_serve_step
    if warmup:
        run_serve(["--arch", "dien", "--full", "--requests", str(batch)])
    walls, ctrs, launches = [], [], 0
    torch.cuda.reset_peak_memory_stats()
    for seed in seeds:
        report, counts, wall = counted(lambda: run_serve(
            ["--arch", "dien", "--full", "--requests", str(batch),
             "--seed", str(seed)]))
        expect_launches(counts, {"edge_score": 0, "hdrf_score": 0,
                                 "augru": 2},
                        f"DIEN serve of {batch} (2 augru per call)")
        walls.append(wall)
        ctrs.append(report["mean_ctr"])
        launches += counts["augru"]
    peak = torch.cuda.max_memory_allocated()
    cfg, params, request = serve.recsys_request(
        "dien", batch=batch, seed=seeds[0], full=True, device="cuda")
    step = make_recsys_serve_step(cfg)
    ctr = step(params, request)
    if ctr.shape != (batch,) or not bool(torch.isfinite(ctr).all()):
        raise AssertionError("serve step: CTR not finite or misshapen")
    step_ms = cuda_time_ms(lambda: step(params, request), reps=5, warmup=1)
    return {"requests_per_call": batch, "calls": len(seeds),
            "main_wall_s": walls, "mean_ctr": ctrs,
            "augru_launches": launches, "step_ms": step_ms,
            "requests_per_s": batch / step_ms * 1e3,
            "step_profile": kernel_breakdown(lambda: step(params, request),
                                             step_ms),
            "peak_device_bytes": peak}


def recsys_serve() -> dict:
    """DIEN at full width through the serving CLI: ``serve_p99`` (512) in
    ``SERVE_TIMED_CALLS`` calls after one warm-up, and ``serve_bulk`` as
    ``BULK_CALLS`` calls of 65,536."""
    import torch
    from repro_torch.configs.base import RECSYS_SHAPES
    p99 = serve_calls(RECSYS_SHAPES["serve_p99"]["batch"],
                      list(range(SERVE_TIMED_CALLS)), warmup=True)
    bulk = serve_calls(BULK_BATCH, list(range(BULK_CALLS)), warmup=False)
    torch.cuda.empty_cache()
    full_bulk = RECSYS_SHAPES["serve_bulk"]["batch"]
    return {"config": "configs/dien.py::full (2,097,152 x 18 table, seq "
                      "100, GRU 108, MLP 200-80)",
            "serve_p99": p99, "serve_bulk": bulk,
            "serve_bulk_cut": f"{BULK_CALLS} calls of {BULK_BATCH} instead "
                              f"of one of {full_bulk}: two (262,144, 100, "
                              "324) float32 gate tensors are 34 GB each",
            "augru_launches": p99["augru_launches"]
            + bulk["augru_launches"]}


def retrieval_request(cfg, n_candidates: int, seed: int, device):
    """One user's history and ``n_candidates`` distinct items."""
    import torch
    from repro_torch.data import InteractionStream
    b = InteractionStream(cfg.n_items, 1, cfg.seq_len, seed=seed).next_batch()
    cand = np.random.default_rng(seed).permutation(cfg.n_items)
    req = {"hist": b["hist"], "hist_mask": b["hist_mask"],
           "candidates": cand[:n_candidates].astype(np.int32)}
    return {k: torch.from_numpy(v).to(device) for k, v in req.items()}


def recsys_retrieval(top_k: int = 100) -> dict:
    """``make_recsys_retrieval_step(cfg, top_k=100)`` at ``retrieval_cand``
    (1 user x 1,000,000 candidates): one augru launch per call."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.launch.steps import make_recsys_retrieval_step
    from repro_torch.models.recsys import dien_init
    M = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    cfg = get_arch("dien").make_config()
    params = dien_init(cfg, torch.Generator(device="cuda").manual_seed(0))
    req = retrieval_request(cfg, M, seed=0, device="cuda")
    step = make_recsys_retrieval_step(cfg, top_k=top_k)
    (values, indices), counts, wall = counted(lambda: step(params, req))
    expect_launches(counts, {"edge_score": 0, "hdrf_score": 0, "augru": 1},
                    "DIEN retrieval (1 augru per call)")
    if (values.shape != (top_k,) or not bool(torch.isfinite(values).all())
            or not bool((values[:-1] >= values[1:]).all())
            or not 0 <= int(indices.min()) <= int(indices.max()) < M):
        raise AssertionError("retrieval: top-k not finite, sorted, in range")
    ms = cuda_time_ms(lambda: step(params, req), reps=10, warmup=2)
    return {"candidates": M, "top_k": top_k, "first_call_wall_s": wall,
            "ms_per_call": ms, "candidates_per_s": M / ms * 1e3,
            "step_profile": kernel_breakdown(lambda: step(params, req), ms),
            "augru_launches": counts["augru"]}


def recsys_card_vs_cpu(batch: int = 512, top_k: int = 100) -> dict:
    """The same full-width weights and requests on the card and on the
    CPU: CTR within 1e-5; retrieval values within 1e-5 and the top-k sets
    equal except among scores that tie (within 1e-5) with the k-th."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data import InteractionStream
    from repro_torch.launch.steps import (make_recsys_retrieval_step,
                                          make_recsys_serve_step)
    from repro_torch.models.recsys import (dien_init, dien_retrieval_score,
                                           params_to)
    cfg = get_arch("dien").make_config()
    params = {"cuda": dien_init(cfg, torch.Generator(device="cuda")
                                .manual_seed(1))}
    params["cpu"] = params_to(params["cuda"], "cpu")
    b = InteractionStream(cfg.n_items, batch, cfg.seq_len, seed=1).next_batch()
    serve = make_recsys_serve_step(cfg)
    ctr, wall = {}, {}
    for dev in ("cuda", "cpu"):
        req = {k: torch.from_numpy(b[k]).to(dev)
               for k in ("hist", "hist_mask", "target")}
        t0 = time.perf_counter()
        ctr[dev] = serve(params[dev], req).cpu()
        wall[f"serve_{dev}_s"] = time.perf_counter() - t0
    ctr_err = float((ctr["cuda"] - ctr["cpu"]).abs().max())
    M = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    retrieve = make_recsys_retrieval_step(cfg, top_k=top_k)
    top = {}
    for dev in ("cuda", "cpu"):
        req = retrieval_request(cfg, M, seed=1, device=dev)
        t0 = time.perf_counter()
        top[dev] = [x.cpu().numpy() for x in retrieve(params[dev], req)]
        wall[f"retrieval_{dev}_s"] = time.perf_counter() - t0
    scores = dien_retrieval_score(cfg, params["cpu"], req).numpy()
    (v_gpu, i_gpu), (v_cpu, i_cpu) = top["cuda"], top["cpu"]
    val_err = float(np.abs(v_gpu - v_cpu).max())
    kth = v_cpu[-1]
    sure = set(np.flatnonzero(scores > kth + 1e-5).tolist())
    sets_ok = (sure <= set(i_gpu.tolist()) and sure <= set(i_cpu.tolist())
               and bool((scores[i_gpu] >= kth - 1e-5).all()))
    line = {"batch": batch, "ctr_max_abs_err": ctr_err, "candidates": M,
            "top_k": top_k, "retrieval_value_max_abs_err": val_err,
            "top_k_index_differences": len(set(i_gpu.tolist())
                                           ^ set(i_cpu.tolist())),
            "top_k_sets_equal_where_distinct": sets_ok,
            "tolerance": "1e-5", **wall}
    if not (ctr_err <= 1e-5 and val_err <= 1e-5 and sets_ok):
        raise AssertionError(f"DIEN card vs cpu disagree: {line}")
    return line


# ---------------------------------------------------------------------------
# the LM serving path (starcoder2-3b)
# ---------------------------------------------------------------------------

LM_ARCH = "starcoder2-3b"
#: the prefill shape: ``prefill_32k``'s length at batch 1 (cut from 32)
PREFILL_SEQ = 32_768
#: a timed prefill call above this many seconds times half the length
PREFILL_CALL_LIMIT_S = 20.0


def lm_params(cfg, seed: int, device="cuda"):
    import torch
    from repro_torch.models.transformer import init_params
    return init_params(cfg, torch.Generator(device=device).manual_seed(seed))


def lm_tokens(cfg, seq: int, seed: int, device="cuda"):
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (1, seq))).to(device)


def prefill_calls(step, params, tokens, n: int, n_layers: int) -> tuple:
    """``n`` calls of the prefill step, each ending in a synchronize, with
    every counter reset just before and read just after (exactly one
    ``flash_attention`` launch per layer); their wall seconds and the sum
    of the ``flash_attention`` counts read."""
    import torch
    walls, launches = [], 0
    for _ in range(n):
        logits, counts, wall = counted(lambda: (
            step(params, {"tokens": tokens}), torch.cuda.synchronize())[0])
        expect_launches(counts, {"flash_attention": n_layers},
                        f"LM prefill of {tuple(tokens.shape)} (one "
                        f"flash_attention per layer)")
        if (logits.shape != (tokens.shape[0], params["embed"]["table"]
                             .shape[0])
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError("prefill logits not finite or misshapen")
        walls.append(wall)
        launches += counts["flash_attention"]
    return walls, launches


def lm_prefill(seq: int = PREFILL_SEQ) -> dict:
    """``make_lm_prefill_step`` on starcoder2-3b at full width and depth:
    one warm-up call at ``seq`` tokens, then two timed calls (at ``seq // 2``
    if the warm-up took more than ``PREFILL_CALL_LIMIT_S``) and one profiled
    call; 30 ``flash_attention`` launches per call."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_lm_prefill_step
    cfg = get_arch(LM_ARCH).make_config()
    params = lm_params(cfg, seed=0)
    step = make_lm_prefill_step(cfg)
    tokens = lm_tokens(cfg, seq, seed=0)
    warm, launches = prefill_calls(step, params, tokens, 1, cfg.n_layers)
    timed_seq = seq if warm[0] <= PREFILL_CALL_LIMIT_S else seq // 2
    tokens = tokens[:, :timed_seq]
    torch.cuda.reset_peak_memory_stats()
    walls, n = prefill_calls(step, params, tokens, 2, cfg.n_layers)
    launches += n
    peak = torch.cuda.max_memory_allocated()
    call_ms = float(np.median(walls)) * 1e3
    profiled = []
    by_name, _ = profile_kernels(lambda: profiled.append(prefill_calls(
        step, params, tokens, 1, cfg.n_layers)[1]))
    launches += profiled[0]
    busy_us = sum(us for us, _ in by_name.values())
    flash_us = sum(us for name, (us, _) in by_name.items()
                   if "flash_attention" in name)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    del params
    torch.cuda.empty_cache()
    return {"config": "configs/starcoder2_3b.py::full (30 layers, d_model "
                      "3072, 24 heads over 2 KV heads, head dim 128, d_ff "
                      "12288, vocab 49152, bf16, random weights, seed 0)",
            "shape": [1, timed_seq], "warmup_shape": [1, seq],
            "cut": "batch 1 of prefill_32k's 32 (one card; the attention "
                   "of one sequence is the kernel's unit of work)"
                   + ("" if timed_seq == seq else
                      f"; timed at {timed_seq} tokens because the warm-up "
                      f"call took {warm[0]:.1f} s"),
            "warmup_wall_s": warm[0], "call_wall_s": walls,
            "ms_per_call": call_ms,
            "tokens_per_s": timed_seq / call_ms * 1e3,
            "peak_device_bytes": peak,
            "flash_attention_launches": launches,
            "kernel_breakdown": {
                "device_ms": busy_us / 1e3,
                "device_busy_share": (busy_us / 1e3 / call_ms if busy_us
                                      else "not measured"),
                "flash_attention_ms": flash_us / 1e3,
                "flash_attention_share": (flash_us / busy_us if busy_us
                                          else "not measured"),
                "kernels": sum(n for _, n in by_name.values()),
                "top_kernels_ms": {k[:80]: us / 1e3
                                   for k, (us, _) in ranked}}}


def run_lm_serve(argv) -> dict:
    """The port's serving CLI for an LM, its JSON report checked."""
    from repro_torch.launch.serve import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv + ["--json"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    keys = {"arch", "mode", "requests", "generated_tokens", "decode_s",
            "tokens_per_s"}
    if set(report) != keys:
        raise AssertionError(f"LM serve report keys {sorted(report)}")
    return report


def lm_serve(requests: int = 4, max_new: int = 16,
             prompt_len: int = 16) -> dict:
    """``main(--arch starcoder2-3b --full --requests 4 --max-new 16)``:
    decode takes the plain GQA attention, as the reference's does, so no
    kernel launches."""
    report, counts, wall = counted(lambda: run_lm_serve(
        ["--arch", LM_ARCH, "--full", "--requests", str(requests),
         "--max-new", str(max_new)]))
    expect_launches(counts, {}, "LM serve (decode through the plain "
                                "attention)")
    if report["generated_tokens"] != requests * max_new:
        raise AssertionError(f"generated {report['generated_tokens']} "
                             f"tokens, expected {requests * max_new}")
    steps = prompt_len + max_new - 1
    return {**report, "main_wall_s": wall, "decode_steps": steps,
            "ms_per_decode_step": report["decode_s"] / steps * 1e3,
            "launches": counts,
            "decode_step_profile": decode_profile(requests,
                                                  prompt_len + max_new)}


def decode_profile(requests: int, max_len: int) -> dict:
    """One full-width decode step (position ``max_len // 2`` of a cache of
    ``max_len``) timed between CUDA events, and its kernels profiled."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_lm_decode_step
    from repro_torch.models.transformer import init_cache
    cfg = get_arch(LM_ARCH).make_config()
    params = lm_params(cfg, seed=0)
    cache = {k: t.cuda() for k, t in
             init_cache(cfg, requests, max_len).items()}
    batch = {"cache": cache, "pos": max_len // 2,
             "tokens": torch.zeros((requests, 1), dtype=torch.long).cuda()}
    step = make_lm_decode_step(cfg)
    ms = cuda_time_ms(lambda: step(params, batch), reps=10, warmup=2)
    out = {"step_ms": ms, **kernel_breakdown(lambda: step(params, batch),
                                             ms)}
    del params, cache
    torch.cuda.empty_cache()
    return out


def logits_agree(a, b) -> dict:
    """max |a - b| against 1e-3 of max |b|, and the argmax of each row."""
    import torch
    a, b = a.float().cpu(), b.float().cpu()
    diff = float((a - b).abs().max())
    scale = float(b.abs().max())
    same = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    return {"max_abs_diff": diff, "max_abs_logit": scale,
            "relative": diff / scale, "same_argmax": same,
            "ok": diff <= 1e-3 * scale and same}


def lm_card_vs_cpu(short: int = 512, long: int = 2048) -> dict:
    """starcoder2-3b's widths in float32 (TF32 off): 2 layers on (1,
    ``short``) on the card and on the CPU; all 30 layers on (1, ``long``)
    on the card through the kernel and through the plain attention."""
    import dataclasses
    import torch
    import repro_torch.models.transformer as T
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import plain_attention
    from repro_torch.launch.steps import make_lm_prefill_step
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    full = dataclasses.replace(get_arch(LM_ARCH).make_config(),
                               dtype="float32")
    cfg = dataclasses.replace(full, n_layers=2)
    step = make_lm_prefill_step(cfg)
    cpu_params = lm_params(cfg, seed=1, device="cpu")
    tokens = lm_tokens(cfg, short, seed=1, device="cpu")
    t0 = time.perf_counter()
    on_cpu = step(cpu_params, {"tokens": tokens})
    cpu_s = time.perf_counter() - t0
    card_params = T.params_to(cpu_params, "cuda")
    on_card, counts, _ = counted(lambda: step(card_params,
                                              {"tokens": tokens.cuda()}))
    expect_launches(counts, {"flash_attention": cfg.n_layers},
                    "2-layer float32 prefill")
    short_line = {"layers": 2, "shape": [1, short], "cpu_s": cpu_s,
                  **logits_agree(on_card, on_cpu)}
    del card_params, cpu_params
    params = lm_params(full, seed=2)
    step = make_lm_prefill_step(full)
    tokens = lm_tokens(full, long, seed=2)
    kernel, counts, _ = counted(lambda: step(params, {"tokens": tokens}))
    expect_launches(counts, {"flash_attention": full.n_layers},
                    "30-layer float32 prefill")
    saved = T.flash_attention
    T.flash_attention = plain_attention
    try:
        plain, counts, _ = counted(lambda: step(params, {"tokens": tokens}))
    finally:
        T.flash_attention = saved
    expect_launches(counts, {}, "30-layer float32 prefill, plain attention")
    long_line = {"layers": full.n_layers, "shape": [1, long],
                 **logits_agree(kernel, plain)}
    del params
    torch.cuda.empty_cache()
    line = {"dtype": "float32", "tolerance": "max |a - b| <= 1e-3 max |b|, "
            "same argmax", "card_vs_cpu": short_line,
            "kernel_vs_plain": long_line}
    if not (short_line["ok"] and long_line["ok"]):
        raise AssertionError(f"LM card vs cpu disagree: {line}")
    return line


# ---------------------------------------------------------------------------
# the partitioning path
# ---------------------------------------------------------------------------

def write_graph(scale: int, tmp: str) -> tuple[str, int]:
    """The RMAT graph of ``scale`` as a binary edge list in ``tmp``, made
    once per scale and reused by every phase."""
    path = os.path.join(tmp, f"rmat{scale}.bin")
    if not os.path.exists(path):
        from repro_torch.data import rmat_graph
        edges = rmat_graph(scale, edge_factor=16, seed=0)
        np.ascontiguousarray(edges, dtype=np.uint32).tofile(path)
    return path, os.path.getsize(path) // 8


def run_cli(argv) -> tuple[dict, object]:
    """The port's CLI, its JSON report parsed (the CLI prints it)."""
    from repro_torch.launch.partition import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = main(argv + ["--json"])
    return json.loads(buf.getvalue()), res


def check_run(report: dict, res, k: int, num_edges: int) -> dict:
    """Every row in [0, k), sizes equal to the engine's and (for the specs
    that enforce it) within the capacity, RF >= 1."""
    from repro_torch.core import capacity
    asg = np.asarray(res.assignment)
    if asg.shape != (num_edges,) or asg.min() < 0 or asg.max() >= k:
        raise AssertionError("assignment has rows outside [0, k)")
    sizes = np.bincount(asg, minlength=k)
    cap = capacity(num_edges, k, res.alpha)
    if not np.array_equal(sizes, res.quality.part_sizes):
        raise AssertionError("sizes are not the engine's")
    if res.spec.enforces_capacity and sizes.max() > cap:
        raise AssertionError(f"size {sizes.max()} over capacity {cap}")
    if not report["replication_factor"] >= 1.0:
        raise AssertionError("replication factor below 1")
    return {"max_size": int(sizes.max()), "capacity": cap,
            "capacity_enforced": res.spec.enforces_capacity}


def counters() -> dict:
    """Every kernel's launch counter, by kernel name."""
    from repro_torch.kernels import (augru, edge_score, embedding_bag,
                                     flash_attention, hdrf_score, spmm)
    return {"edge_score": edge_score.launches,
            "hdrf_score": hdrf_score.launches,
            "augru": augru.launches,
            "flash_attention": flash_attention.launches,
            "spmm": spmm.launches,
            "embedding_bag": embedding_bag.launches}


def counted(fn):
    """Run ``fn`` with every launch counter set to 0 just before it;
    returns (its result, the counts just after, its wall seconds)."""
    cs = counters()
    for c in cs.values():
        c.reset()
    t0 = time.perf_counter()
    out = fn()
    wall = time.perf_counter() - t0
    return out, {name: c.count for name, c in cs.items()}, wall


def expect_launches(counts: dict, expected: dict, what: str) -> None:
    """``counts`` must be ``expected``, every kernel it does not name at 0."""
    expected = {**dict.fromkeys(counts, 0), **expected}
    if counts != expected:
        raise AssertionError(f"{what}: launches {counts}, expected "
                             f"{expected}")


def main_path(scale: int, tmp: str, k: int = 32) -> dict:
    from repro_torch.core import spec_for
    t0 = time.perf_counter()
    path, E = write_graph(scale, tmp)
    gen_s = time.perf_counter() - t0
    chunk = spec_for("2psl").chunk_size
    (report, res), counts, wall = counted(lambda: run_cli(
        ["--input", path, "--k", str(k),
         "--out", os.path.join(tmp, "assign.bin")]))
    n_launch = counts["edge_score"]
    checks = check_run(report, res, k, E)
    chunks = -(-E // chunk)
    expect_launches(counts, {"edge_score": chunks, "hdrf_score": 0,
                             "augru": 0},
                    "2PS-L main path (one edge_score per scoring chunk)")
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
    path, E = write_graph(scale, tmp)
    (report, res), counts, wall = counted(lambda: run_cli(
        ["--input", path, "--k", str(k), "--hosts", "4",
         "--dcn-penalty", "1.0"]))
    n_launch = counts["edge_score"]
    checks = check_run(report, res, k, E)
    chunks = -(-E // spec_for("2psl").chunk_size)
    expect_launches(counts, {"edge_score": chunks, "hdrf_score": 0,
                             "augru": 0},
                    "hosted 2PS-L")
    if not 1.0 <= report["cross_host_rf"] <= report["replication_factor"]:
        raise AssertionError("cross-host RF outside [1, RF]")
    return {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": E, "k": k, "hosts": 4, "dcn_penalty": 1.0,
            "wall_s": wall, "timings_s": report["timings_s"],
            "replication_factor": report["replication_factor"],
            "cross_host_rf": report["cross_host_rf"],
            "edge_score_launches": n_launch, **checks}


def path_line(scale, E, k, report, wall, counts, checks, **extra) -> dict:
    timings = report["timings_s"]
    return {"algorithm": report["algorithm"],
            "graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": E, "k": k, **extra, "wall_s": wall,
            "edges_per_s": E / wall, "timings_s": timings,
            "replication_factor": report["replication_factor"],
            "alpha_measured": report["alpha_measured"],
            "launches": counts, **checks}


def two_ps_hdrf_path(scale: int, tmp: str, k: int = 32) -> dict:
    """2PS-HDRF through the CLI: 2PS-L's Phase 1 and pre-partitioning, then
    HDRF over all k partitions with one hdrf_score launch per chunk."""
    from repro_torch.core import spec_for
    path, E = write_graph(scale, tmp)
    chunks = -(-E // spec_for("2ps-hdrf").chunk_size)
    (report, res), counts, wall = counted(lambda: run_cli(
        ["--input", path, "--k", str(k), "--algorithm", "2ps-hdrf",
         "--out", os.path.join(tmp, "assign_2ps_hdrf.bin")]))
    checks = check_run(report, res, k, E)
    expect_launches(counts, {"edge_score": 0, "hdrf_score": chunks,
                             "augru": 0},
                    "2PS-HDRF (one hdrf_score per scoring chunk)")
    return path_line(scale, E, k, report, wall, counts, checks,
                     scoring_chunks=chunks,
                     prepartition_ratio=report["prepartition_ratio"])


def hdrf_launches(E: int, chunk: int, sub: int = 64) -> int:
    """One launch per micro-batch that holds a valid row: the engine skips
    the all-padding micro-batches of the last chunk."""
    return sum(-(-min(chunk, E - lo) // sub) for lo in range(0, E, chunk))


def hdrf_baselines(scale: int, tmp: str, k: int = 32) -> dict:
    """HDRF, Greedy and host-aware HDRF through the CLI.  Each 64-edge
    micro-batch is a few dozen eager launches; at RMAT-16 that is 14,927
    micro-batches per run (15-20 s each), which is why this phase runs
    below the 2PS-HDRF path's scale."""
    path, E = write_graph(scale, tmp)
    chunk = 1 << 16                     # the CLI's --chunk-size default
    want = hdrf_launches(E, chunk)
    runs = {}
    for name, extra in (("hdrf", []), ("greedy", []),
                        ("hdrf_hosted", ["--hosts", "4",
                                         "--dcn-penalty", "1.0"])):
        algo = name.split("_")[0]
        (report, res), counts, wall = counted(lambda: run_cli(
            ["--input", path, "--k", str(k), "--algorithm", algo, *extra]))
        checks = check_run(report, res, k, E)
        expect_launches(counts, {"edge_score": 0, "hdrf_score": want,
                                 "augru": 0},
                        f"{name} (one hdrf_score per non-empty 64-edge "
                        f"micro-batch)")
        runs[name] = path_line(scale, E, k, report, wall, counts, checks,
                               micro_batches=want)
        if extra:
            runs[name]["cross_host_rf"] = report["cross_host_rf"]
    return {"why_reduced": "64-edge micro-batches of a few dozen eager "
                           "launches each: 14,927 per run at RMAT-16",
            **runs}


def hash_paths(scale: int, tmp: str, k: int = 32) -> dict:
    """DBH, Grid and Random through the CLI: hashing on the card, the bits
    and sizes folded on the host; no kernel of the port runs."""
    path, E = write_graph(scale, tmp)
    runs = {}
    for algo in ("dbh", "grid", "random"):
        (report, res), counts, wall = counted(lambda: run_cli(
            ["--input", path, "--k", str(k), "--algorithm", algo]))
        checks = check_run(report, res, k, E)
        expect_launches(counts, {"edge_score": 0, "hdrf_score": 0,
                                 "augru": 0}, algo)
        runs[algo] = path_line(scale, E, k, report, wall, counts, checks)
    return runs


# ---------------------------------------------------------------------------
# the GNN aggregation and embedding pooling ops at ogb_products' and DIEN's
# scale
# ---------------------------------------------------------------------------

#: gin-tu aggregates at d_hidden 64 over 5 layers; GatedGCN's width is 70
GIN_D, GIN_LAYERS, GATED_D = 64, 5, 70
GNN_COPIES = 4
#: ogb_products (configs/base.py GNN_SHAPES), for the line beside the graph
OGB_PRODUCTS = {"n_nodes": 2_449_029, "n_edges": 61_859_140}


def relabelled_copies(edges, copies: int, seed: int) -> tuple:
    """``copies`` disjoint copies of the graph on its touched vertices, the
    node ids relabelled by a seeded permutation and the edges shuffled:
    (src, dst) int32 and the node count."""
    touched = np.zeros(int(edges.max()) + 1, bool)
    touched[edges.ravel()] = True
    n1 = int(touched.sum())
    compact = (np.cumsum(touched) - 1)[edges]
    rng = np.random.default_rng(seed)
    label = rng.permutation(copies * n1)
    copy, row = np.divmod(rng.permutation(copies * len(edges)), len(edges))
    base = copy * n1
    return (label[compact[row, 0] + base].astype(np.int32),
            label[compact[row, 1] + base].astype(np.int32), copies * n1)


def counted_calls(fn, n: int, kernel: str, what: str) -> tuple:
    """``n`` calls of ``fn``, each with every counter reset just before and
    read just after (exactly one launch of ``kernel``, nothing else), each
    timed between CUDA events; (the last output, ms per call, launches)."""
    import torch
    ms, launches, out = [], 0, None
    for _ in range(n):
        out = None           # as a layer loop frees the last output
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)

        def call():
            a.record()
            r = fn()
            b.record()
            b.synchronize()
            return r
        out, counts, _ = counted(call)
        expect_launches(counts, {kernel: 1}, what)
        ms.append(a.elapsed_time(b))
        launches += counts[kernel]
    return out, ms, launches


def csr_library_ms(prep, col, values, n_cols: int, rows, reps: int = 5):
    """cuSPARSE's SpMM (``torch.sparse.mm`` of a CSR matrix built once from
    the prep) on the same operands: a yardstick of speed only, never on the
    port's path.  Returns (ms, its output)."""
    import torch
    a = torch.sparse_csr_tensor(prep.row_ptr, col, values,
                                size=(prep.num_nodes, n_cols),
                                check_invariants=False)
    ms = cuda_time_ms(lambda: torch.sparse.mm(a, rows), reps, 1)
    return ms, torch.sparse.mm(a, rows)


def gnn_aggregate(scale: int, tmp: str) -> dict:
    """One GIN layer's neighbour sum at ogb_products' scale: 4 relabelled
    copies of RMAT-``scale``; ``spmm(h, src, edge_mask, prep)`` at gin-tu's
    D = 64, one warm-up and one call per layer, and ``segment_sum_tiles``
    of (E, 70) messages, one warm-up and two calls; exactly one ``spmm``
    launch per call.  Then the last outputs against the plain versions,
    and the kernel, the plain versions and cuSPARSE timed on the inputs."""
    import torch
    from repro_torch.kernels import wrap_clamp_index
    from repro_torch.kernels.spmm import (prepare_tiles, segment_sum_ref,
                                          segment_sum_tiles, spmm, spmm_ref)
    t0 = time.perf_counter()
    path, _ = write_graph(scale, tmp)
    src, dst, N = relabelled_copies(np.fromfile(path, np.uint32)
                                    .reshape(-1, 2), GNN_COPIES, seed=0)
    graph_s = time.perf_counter() - t0
    E = len(src)
    t0 = time.perf_counter()
    host_prep = prepare_tiles(dst, N)
    prepare_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prep = host_prep.to("cuda")
    torch.cuda.synchronize()
    to_s = time.perf_counter() - t0
    deg = np.diff(host_prep.row_ptr.numpy())
    g = torch.Generator(device="cuda").manual_seed(0)
    src_d = torch.from_numpy(src).cuda()
    dst_d = torch.from_numpy(dst).cuda()
    h = torch.randn((N, GIN_D), generator=g, device="cuda")
    mask = (torch.rand(E, generator=g, device="cuda") < 0.99).float()
    torch.cuda.reset_peak_memory_stats()
    y, gin_ms, gin_n = counted_calls(lambda: spmm(h, src_d, mask, prep),
                                     1 + GIN_LAYERS, "spmm",
                                     "gin-tu neighbour sum (one spmm)")
    gin_peak = torch.cuda.max_memory_allocated()
    gather = wrap_clamp_index(src_d, N)
    touched = int(torch.unique(gather).numel())
    # bytes: the x rows touched once (or one per edge), src, mask, perm,
    # row_ptr read once, Y written once; 2 operations per (edge, feature)
    rest = E * (4 + 4 + 4) + (N + 1) * 8 + N * GIN_D * 4
    gin_bound = bound(touched * GIN_D * 4 + rest, 2 * E * GIN_D)
    gin_gathered = bound(E * GIN_D * 4 + rest, 2 * E * GIN_D)
    timing = timed(lambda: spmm(h, src_d, mask, prep),
                   lambda: spmm_ref(h, src_d, dst_d, mask, N), reps=3,
                   profile=False)
    flat = prep.with_split(None)
    flat_ms = cuda_time_ms(lambda: spmm(h, src_d, mask, flat), 3, 1)
    flat_agree = sum_agree(spmm(h, src_d, mask, flat), y,
                           spmm_ref(h.abs(), src_d, dst_d, mask, N))
    perm = prep.perm.long()
    lib_ms, lib_y = csr_library_ms(prep, gather[perm], mask[perm], N, h)
    want = spmm_ref(h, src_d, dst_d, mask, N)
    agree = sum_agree(y, want, spmm_ref(h.abs(), src_d, dst_d, mask, N))
    lib_err = float((lib_y - want).abs().max())
    if not (agree["ok"] and flat_agree["ok"]):
        raise AssertionError(f"spmm disagrees at the path shape: {agree}, "
                             f"without the split: {flat_agree}")
    del h, y, want, lib_y, gather
    torch.cuda.empty_cache()
    gin = {"D": GIN_D, "calls_ms": gin_ms, "warmup_ms": gin_ms[0],
           "ms_per_call": float(np.median(gin_ms[1:])), "launches": gin_n,
           "peak_device_bytes": gin_peak, "touched_rows": touched,
           "gb_per_s": (touched * GIN_D * 4 + rest) / 1e6
           / float(np.median(gin_ms[1:])),
           "gathered_gb_per_s": (E * GIN_D * 4 + rest) / 1e6
           / float(np.median(gin_ms[1:])),
           **timing, **gin_bound,
           "gathered_bound_ms": gin_gathered["bound_ms"],
           "no_split_ms": flat_ms, "no_split": flat_agree, **agree,
           "library_ms": lib_ms, "library_max_abs_diff": lib_err,
           "library": "torch.sparse.mm(CSR(row_ptr, src[perm], mask[perm]), "
                      "h), cuSPARSE SpMM"}

    msgs = torch.randn((E, GATED_D), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    y, seg_ms, seg_n = counted_calls(lambda: segment_sum_tiles(msgs, prep),
                                     3, "spmm",
                                     "GatedGCN message sum (one spmm)")
    seg_peak = torch.cuda.max_memory_allocated()
    seg_bytes = E * GATED_D * 4 + E * 4 + (N + 1) * 8 + N * GATED_D * 4
    seg_timing = timed(lambda: segment_sum_tiles(msgs, prep),
                       lambda: segment_sum_ref(msgs, dst_d, N), reps=2,
                       profile=False)
    lib_ms, lib_y = csr_library_ms(prep, perm, torch.ones_like(mask), E,
                                   msgs, reps=2)
    want = segment_sum_ref(msgs, dst_d, N)
    lib_err = float((lib_y - want).abs().max())
    del lib_y
    agree = sum_agree(y, want, segment_sum_ref(msgs.abs_(), dst_d, N))
    if not agree["ok"]:
        raise AssertionError(f"segment_sum_tiles disagrees at the path "
                             f"shape: {agree}")
    del msgs, y, want
    torch.cuda.empty_cache()
    seg = {"D": GATED_D, "calls_ms": seg_ms, "warmup_ms": seg_ms[0],
           "ms_per_call": float(np.median(seg_ms[1:])), "launches": seg_n,
           "peak_device_bytes": seg_peak,
           "gb_per_s": seg_bytes / 1e6 / float(np.median(seg_ms[1:])),
           **seg_timing, **bound(seg_bytes, E * GATED_D), **agree,
           "library_ms": lib_ms, "library_max_abs_diff": lib_err,
           "library": "torch.sparse.mm(CSR(row_ptr, perm, ones), messages), "
                      "cuSPARSE SpMM"}
    return {"graph": f"{GNN_COPIES} copies of rmat_graph({scale}, "
                     f"edge_factor=16, seed=0) on its touched vertices, ids "
                     f"relabelled and edges shuffled (seed 0)",
            "nodes": N, "edges": E, "ogb_products": OGB_PRODUCTS,
            "max_in_degree": int(deg.max()),
            "hub_rows": int(prep.hub_rows.numel()),
            "hub_chunks": prep.n_chunks, "split": prep.split,
            "graph_s": graph_s, "prepare_tiles_s": prepare_s,
            "prep_to_cuda_s": to_s, "tolerance": SUM_TOL,
            "gin_spmm": gin, "gated_segment_sum": seg,
            "spmm_launches": gin_n + seg_n}


def bag_pool() -> dict:
    """``embedding_bag`` over DIEN's 2,097,152 x 18 float32 item table
    (seeded ``torch.Generator``), batches of ``InteractionStream`` (seq
    100, seed 0) of ``serve_p99`` (512) and ``BULK_BATCH`` rows with
    ``hist`` as the indices and ``hist_mask`` as the weights, in ``sum``
    and ``mean``: one warm-up and three calls each,
    exactly one launch per call; then the last output against the plain
    version, and the kernel, the plain version and, for ``sum``,
    ``F.embedding_bag`` timed on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data import InteractionStream
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)
    cfg = get_arch("dien").make_config()
    V, D, L = cfg.n_items, cfg.embed_dim, cfg.seq_len
    batches = (RECSYS_SHAPES["serve_p99"]["batch"], BULK_BATCH)
    table = torch.randn((V, D), generator=torch.Generator(device="cuda")
                        .manual_seed(0), device="cuda")
    runs, launches = {}, 0
    for B in batches:
        b = InteractionStream(V, B, L, seed=0).next_batch()
        idx = torch.from_numpy(b["hist"]).cuda()
        w = torch.from_numpy(b["hist_mask"]).cuda()
        touched = int(torch.unique(idx).numel())
        rest = B * L * (4 + 4) + B * D * 4
        for mode in ("sum", "mean"):
            def op():
                return embedding_bag(table, idx, w, mode=mode)

            def plain():
                return embedding_bag_ref(table, idx, w, mode=mode)
            out, ms, n = counted_calls(op, 4, "embedding_bag",
                                       f"bag pooling {B} x {L} {mode} (one "
                                       f"embedding_bag)")
            launches += n
            agree = sum_agree(out, plain(), embedding_bag_ref(
                table.abs(), idx, w, mode=mode))
            if not agree["ok"]:
                raise AssertionError(f"embedding_bag disagrees at ({B}, {L}) "
                                     f"{mode}: {agree}")
            lib_ms = lib_err = None
            if mode == "sum":
                def lib():
                    return F.embedding_bag(idx, table, mode="sum",
                                           per_sample_weights=w)
                lib_ms = batched_ms(lib)
                lib_err = float((lib() - out).abs().max())
            kernel_ms, recorded = launch_ms(op, "embedding_bag_kernel")
            op_ms = batched_ms(op)
            runs[f"{B}_{mode}"] = {
                "B": B, "L": L, "D": D, "mode": mode, "calls_ms": ms,
                "ms_per_call": float(np.median(ms[1:])), "launches": n,
                "touched_rows": touched, **agree,
                "ms": op_ms if kernel_ms is None else kernel_ms,
                "ms_source": (f"profiler, mean of {recorded} recorded "
                              f"launches" if recorded else
                              "CUDA events over 50 back-to-back calls"),
                "batched_ms": op_ms, "plain_ms": batched_ms(plain),
                "plain_ms_source": "CUDA events over 50 back-to-back calls",
                **bound(touched * D * 4 + rest, 2 * B * L * D),
                "gathered_bound_ms": bound(B * L * D * 4 + rest,
                                           2 * B * L * D)["bound_ms"],
                "library_ms": lib_ms, "library_max_abs_diff": lib_err,
                "library": "F.embedding_bag(idx, table, mode='sum', "
                           "per_sample_weights=w), CUDA events over 50 "
                           "back-to-back calls" if mode == "sum" else
                           "none: torch's mean ignores per-sample weights"}
    del table
    torch.cuda.empty_cache()
    return {"table": [V, D], "config": "configs/dien.py::full item table, "
            "seq 100, hist_mask as weights", "tolerance": SUM_TOL,
            **runs, "embedding_bag_launches": launches}


def ops_card_vs_cpu(scale: int) -> dict:
    """The two ops on the card and on the CPU through the same call:
    ``spmm`` at D = 64 on one relabelled copy of RMAT-``scale``, and
    ``embedding_bag`` at B = 512 over the full DIEN table, each within the
    tolerance (one launch on the card, none on the CPU)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import InteractionStream, rmat_graph
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)
    from repro_torch.kernels.spmm import prepare_tiles, spmm, spmm_ref
    src, dst, N = relabelled_copies(rmat_graph(scale, edge_factor=16, seed=0),
                                    1, seed=1)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((N, GIN_D), generator=gen)
    w = torch.rand(len(src), generator=gen)
    src_t = torch.from_numpy(src)
    prep = prepare_tiles(dst, N)
    on_cpu, counts, cpu_s = counted(lambda: spmm(x, src_t, w, prep))
    expect_launches(counts, {}, "spmm on the CPU")
    card_prep = prep.to("cuda")
    on_card, counts, _ = counted(lambda: spmm(x.cuda(), src_t.cuda(),
                                              w.cuda(), card_prep).cpu())
    expect_launches(counts, {"spmm": 1}, "spmm on the card")
    gnn = {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0), "
                    f"relabelled (seed 1)", "nodes": N, "edges": len(src),
           "D": GIN_D, "cpu_s": cpu_s,
           **sum_agree(on_card, on_cpu, spmm_ref(
               x.abs(), src_t, torch.from_numpy(dst), w, N))}
    cfg = get_arch("dien").make_config()
    table = torch.randn((cfg.n_items, cfg.embed_dim),
                        generator=torch.Generator(device="cuda")
                        .manual_seed(2), device="cuda")
    b = InteractionStream(cfg.n_items, 512, cfg.seq_len, seed=2).next_batch()
    idx, mask = torch.from_numpy(b["hist"]), torch.from_numpy(b["hist_mask"])
    bags = {}
    for mode in ("sum", "mean"):
        on_card, counts, _ = counted(lambda: embedding_bag(
            table, idx.cuda(), mask.cuda(), mode=mode).cpu())
        expect_launches(counts, {"embedding_bag": 1},
                        f"embedding_bag {mode} on the card")
        cpu_table = table.cpu()
        on_cpu, counts, cpu_s = counted(lambda: embedding_bag(
            cpu_table, idx, mask, mode=mode))
        expect_launches(counts, {}, f"embedding_bag {mode} on the CPU")
        bags[mode] = {"B": 512, "cpu_s": cpu_s, **sum_agree(
            on_card, on_cpu, embedding_bag_ref(cpu_table.abs(), idx, mask,
                                               mode=mode))}
    line = {"tolerance": SUM_TOL, "spmm": gnn, "embedding_bag": bags}
    if not (gnn["ok"] and all(v["ok"] for v in bags.values())):
        raise AssertionError(f"ops card vs cpu disagree: {line}")
    return line


def profile_kernels(fn) -> tuple[dict, float]:
    """One profiled run of ``fn``: the device time (us) of the CUDA kernels
    torch.profiler records, summed by kernel name with their count, and
    the run's wall time (us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.device_time_total
            entry[1] += 1
    return by_name, wall_us


def device_busy(fn) -> tuple[float | None, int]:
    """Share of a run's wall time the card spent in kernels (the summed
    kernel durations torch.profiler records; None when it records none),
    and the number of kernels it ran."""
    by_name, wall_us = profile_kernels(fn)
    busy = sum(us for us, _ in by_name.values())
    return (busy / wall_us if busy > 0 else None), sum(
        n for _, n in by_name.values())


def kernel_breakdown(fn, call_ms: float, top: int = 6) -> dict:
    """One profiled call of ``fn`` after a warm-up: the device time its
    kernels took, that time's share of ``call_ms`` (the call's unprofiled
    time, since the profiler itself slows the host), the number of
    kernels, and the ``top`` kernels by device time (ms)."""
    import torch
    fn()
    torch.cuda.synchronize()
    by_name, _ = profile_kernels(fn)
    busy = sum(us for us, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_busy_share": busy / 1e3 / call_ms if busy
            else "not measured",
            "device_ms": busy / 1e3,
            "kernels": sum(n for _, n in by_name.values()),
            "top_kernels_ms": {k[:80]: us / 1e3 for k, (us, _) in ranked}}


def card_vs_cpu(scale: int, name: str = "2psl", k: int = 32,
                busy_edges: int | None = None) -> dict:
    """The same run on the card and on the CPU, byte-equal; then the
    card's busy share in a profiled run over the first ``busy_edges``
    edges (all when None: profiling every launch of a long micro-batch
    loop costs more than the run)."""
    from repro_torch.core import InMemoryEdgeStream, run_spec, spec_for
    from repro_torch.data import rmat_graph
    edges = rmat_graph(scale, edge_factor=16, seed=0)
    spec = spec_for(name)
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
        raise AssertionError(f"card vs cpu ({name}): {mism} assignment "
                             f"mismatches, quality equal: {same_q}")
    window = edges[:busy_edges]
    busy, n_kernels = device_busy(
        lambda: run_spec(spec, InMemoryEdgeStream(window), k, device="cuda"))
    return {"algorithm": name, "chunk_size": spec.chunk_size,
            "busy_share_edges": len(window),
            "device_kernels_profiled": n_kernels,
            "graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
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
    ap.add_argument("--scale", type=int, default=20,
                    help="RMAT scale of the 2PS-HDRF and hash graphs "
                         "(default 20); 2PS-L runs at min(scale, 19), the "
                         "hosted 2PS-L at min(scale, 18), the HDRF "
                         "baselines and the overflow-tail comparison at "
                         "min(scale, 16)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.augru import kernel as ag_kernel
    from repro_torch.kernels.edge_score import kernel as es_kernel
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.hdrf_score import kernel as hs_kernel
    from repro_torch.kernels.spmm import kernel as sp_kernel

    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    cuda_build.build({es_kernel.NAME: es_kernel.SOURCE,
                      hs_kernel.NAME: hs_kernel.SOURCE,
                      ag_kernel.NAME: ag_kernel.SOURCE,
                      fa_kernel.NAME: fa_kernel.SOURCE,
                      sp_kernel.NAME: sp_kernel.SOURCE,
                      eb_kernel.NAME: eb_kernel.SOURCE})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": i["seconds"],
                          "ptxas": [ln for ln in i["log"].splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for n, i in cuda_build.build_info.items()}})

    check = check_edge_score((1, 1000, 65536, 65537), (0.0, 0.5, 1.0))
    timing = time_edge_score(65536)
    h_check = check_hdrf_score((1, 64, 65536, 65537), (2, 32, 200))
    h_timing = time_hdrf_score(65536)
    h_micro = time_hdrf_score(64)
    a_check = check_augru(AUGRU_CHECK)
    a_timing = time_augru(512)
    a_bulk = time_augru(BULK_BATCH, reps=3, profile=False)
    a_one = time_augru(1)
    f_check = check_flash_attention(FLASH_CHECK)
    f_main = check_flash_attention(FLASH_MAIN, model_layout=True)
    f_timing = time_flash_attention(PREFILL_SEQ)
    f_err = max(f_check["max_abs_err"], f_main["max_abs_err"],
                f_timing["max_abs_err"])
    s_check = check_spmm(SPMM_CHECK)
    b_check = check_embedding_bag(BAG_CHECK)
    emit({"phase": "kernels", "edge_score": {**check, **timing},
          "hdrf_score": {**h_check, "chunk": h_timing,
                         "micro_batch": h_micro},
          "augru": {**a_check, "serve_p99": a_timing, "serve_bulk": a_bulk,
                    "retrieval": a_one},
          "flash_attention": {**f_check, "prefill_layer_float32": f_main,
                              "prefill_layer": f_timing},
          "spmm": s_check, "embedding_bag": b_check})

    rs = recsys_serve()
    emit({"phase": "recsys_serve", **rs})
    emit({"phase": "recsys_retrieval", **recsys_retrieval()})
    emit({"phase": "recsys_card_vs_cpu", **recsys_card_vs_cpu()})
    lp = lm_prefill()
    emit({"phase": "lm_prefill", **lp})
    emit({"phase": "lm_serve", **lm_serve()})
    emit({"phase": "lm_card_vs_cpu", **lm_card_vs_cpu()})

    with tempfile.TemporaryDirectory() as tmp:
        # the partitioning paths run below their earlier slices' scales
        # (2PS-HDRF and the hashes at RMAT-20, 2PS-L at 19, the HDRF
        # baselines at 16) so that the whole run, the DIEN and LM phases
        # included, takes about half its time limit
        mp = main_path(min(args.scale, 19), tmp)
        emit({"phase": "main_path", **mp})
        emit({"phase": "hosted", **hosted_path(min(args.scale, 18), tmp)})
        hp = two_ps_hdrf_path(args.scale, tmp)
        emit({"phase": "two_ps_hdrf", **hp})
        emit({"phase": "hdrf_baselines",
              **hdrf_baselines(min(args.scale, 16), tmp)})
        emit({"phase": "hash", **hash_paths(args.scale, tmp)})
        ga = gnn_aggregate(min(args.scale, 20), tmp)
        emit({"phase": "gnn_aggregate", **ga})
    bp = bag_pool()
    emit({"phase": "bag_pool", **bp})
    emit({"phase": "ops_card_vs_cpu", **ops_card_vs_cpu(min(args.scale, 16))})
    emit({"phase": "card_vs_cpu",
          **card_vs_cpu(min(args.scale, 16), busy_edges=1 << 18),
          "hdrf_family": [card_vs_cpu(min(args.scale, 14), name,
                                      busy_edges=1 << 15)
                          for name in ("2ps-hdrf", "hdrf", "greedy")]})
    emit({"phase": "least_loaded_rounds",
          **least_loaded_rounds(min(args.scale, 16))})

    gin = ga["gin_spmm"]
    bulk = bp[f"{BULK_BATCH}_sum"]
    paths = {"edge_score": mp["edge_score_launches"],
             "hdrf_score": hp["launches"]["hdrf_score"],
             "augru": rs["augru_launches"],
             "flash_attention": lp["flash_attention_launches"],
             "spmm": ga["spmm_launches"],
             "embedding_bag": bp["embedding_bag_launches"]}
    for name, n in paths.items():
        if n == 0:
            raise AssertionError(f"the path launched no {name} kernel")
    emit({"kernels": [{
        "name": "edge_score", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_score/csrc/edge_score.cu",
        "replaces": "src/repro/kernels/edge_score/kernel.py:103",
        "launches": paths["edge_score"], "max_abs_err": check["max_abs_err"],
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}, {
        "name": "hdrf_score", "route": "cuda",
        "source": "src/repro_torch/kernels/hdrf_score/csrc/hdrf_score.cu",
        "replaces": "src/repro/kernels/hdrf_score/kernel.py:72",
        "launches": paths["hdrf_score"],
        "max_abs_err": h_check["max_abs_err"],
        "ms": h_timing["ms"], "plain_ms": h_timing["plain_ms"],
        "bound_ms": h_timing["bound_ms"], "bound_by": h_timing["bound_by"],
        "library_ms": None}, {
        "name": "augru", "route": "cuda",
        "source": "src/repro_torch/kernels/augru/csrc/augru.cu",
        "replaces": "src/repro/kernels/augru/kernel.py:53",
        "launches": paths["augru"], "max_abs_err": a_check["max_abs_err"],
        "ms": a_timing["ms"], "plain_ms": a_timing["plain_ms"],
        "bound_ms": a_timing["bound_ms"], "bound_by": a_timing["bound_by"],
        "library_ms": a_timing["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "launches": paths["flash_attention"], "max_abs_err": f_err,
        "ms": f_timing["ms"], "plain_ms": f_timing["plain_ms"],
        "bound_ms": f_timing["bound_ms"], "bound_by": f_timing["bound_by"],
        "library_ms": f_timing["library_ms"]}, {
        "name": "spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/spmm/csrc/spmm.cu",
        "replaces": "src/repro/kernels/spmm/kernel.py:52",
        "launches": paths["spmm"],
        "max_abs_err": max(s_check["max_abs_err"], gin["max_abs_err"],
                           ga["gated_segment_sum"]["max_abs_err"]),
        "ms": gin["ms"], "plain_ms": gin["plain_ms"],
        "bound_ms": gin["bound_ms"], "bound_by": gin["bound_by"],
        "gathered_bound_ms": gin["gathered_bound_ms"],
        "library_ms": gin["library_ms"]}, {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:37",
        "launches": paths["embedding_bag"],
        "max_abs_err": max([b_check["max_abs_err"]]
                           + [r["max_abs_err"] for r in bp.values()
                              if isinstance(r, dict)]),
        "ms": bulk["ms"], "plain_ms": bulk["plain_ms"],
        "bound_ms": bulk["bound_ms"], "bound_by": bulk["bound_by"],
        "gathered_bound_ms": bulk["gathered_bound_ms"],
        "library_ms": bulk["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
