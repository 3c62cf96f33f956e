#!/usr/bin/env python3
"""Drive the PyTorch port's partitioning (every registered algorithm), DIEN
serving, LM serving (dense and MoE), GNN aggregation, GNN models and
serving, embedding pooling and training (LM, DIEN, GNN, partitioned GNN,
the train CLI) paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the root of a checkout

Phases, one JSON line each (any failure raises and exits non-zero):

1. env        the card (nvidia-smi name and power limit), torch and CUDA.
2. build      every kernel (``edge_score``, ``hdrf_score``, ``augru`` and
              its backward, ``flash_attention`` and its backward,
              ``spmm``, ``embedding_bag``), compiled
              from ``src/`` with one nvcc per source, all started together;
              each compiled function's registers and spills (ptxas), by
              template instantiation.
3. kernels    each kernel against its plain torch version on the card, at
              the paths' shapes plus ragged, zero-padded and tied rows,
              flat and host-aware (``edge_score``'s two entries: the flag
              entry on gathered operands, and ``edge_score_choose_bits``,
              which reads the packed bit matrices and the cluster tables
              itself, at k = 1, 2, 31, 32, 33, 64 and 200 and E = 1, 64,
              65,536 and 65,537, flat and with 2, 4 and 8 hosts at
              dcn_penalty 0.5 and 1.0 and 40 hosts (two words a host row),
              int32 and int64 edges, views off the paired load's
              alignment, ragged valid, duplicates, self-loops, edges
              inside a cluster or a partition and exact ties: chosen,
              todo and hi equal, best bit-equal; 2PS-L's choice timed at
              65,536 edges on tables of RMAT-19's size by CUDA-graph
              replays beside the previous composition (gathers, bitops.get
              and the flag kernel), the flag kernel alone and the plain
              version, flat and with 4 hosts, and at 64 edges and on
              RMAT-19's ragged last chunk, its outputs held to the plain
              version's there too; and at buffered re-streaming's
              sub-batch (1,024 edges, k = 32, RMAT-18-sized tables,
              131,072-row window tables, stale ``v2c`` outside the
              window), full and with 300 valid rows, held the same way
              and timed beside its plain version; ``augru``: att == 1 and random
              on each route, small (U in registers), large
              (register-tiled outer products) and general (the previous
              design, H above 108),
              at the routes' edges, T = 1 and H = 37 on both register
              routes, within 1e-5, each case's route reported, two
              launches bit-equal and the previous design within 1e-5 of
              the new one at the serve shapes;
              ``flash_attention``: the reference test's cases,
              starcoder2-3b's heads at 4,096 tokens (bf16 also in the
              model's layout), decode and chunked prefill, the bf16
              kernel's edges (D = 16, 32, 80, 256 and an odd 33, ragged
              query runs, non-causal 8:1 GQA), and the prefill layer (1,
              24/2, 32,768, 128) in the model's layout in both dtypes,
              within 2e-5 in float32 and 2e-2 in bf16, each bf16 element
              also within ``ops.bf16_output_bound`` (2^-8 plain(q, k, |v|)
              + 2^-7 |plain| + 1e-5: P is rounded to bf16 on the tensor
              cores), timed beside the previous design (the SIMT kernel
              in bf16) and SDPA's flash backend; ``spmm`` and
              ``segment_sum_tiles``, each on both routes (edges bound in
              destination order with ``with_edges``, and the previous route
              through ``perm``), the route of each call counted:
              the reference test's cases weighted and not, no edges,
              isolated nodes, wrapped and clamped src, int64 indices, bf16
              rows and hubs above the split length, with and without the
              split, the bound route's load widths (D = 4, 63, 64, 65, 70,
              bf16 at 64) and a view one element off the 16 bytes, its two
              launches bit-equal; ``embedding_bag``: the reference test's
              cases, no weights, an all-zero bag in ``mean``, wrapped
              and clamped indices, int64 indices, a bf16 table and an
              empty bag, then each load width of its plan (D = 1, 3, 18,
              32, 64, 65, bf16 at 18, 64 and 65, views off the 16 bytes),
              L = 0, 1, 100 and 257 and B = 1, 512 and 65,536, two
              launches bit-equal; both
              within 1e-5 of each element's absolute sum plus 1e-6);
              ``hdrf_score``'s two entries (``hdrf_choose`` on flags,
              ``hdrf_choose_bits`` on the packed bit matrix) at k = 1, 2,
              7, 31, 32, 33, 48, 64 and 200 and E = 1, 64, 65,536 and
              65,537, flat and with 4 hosts (k = 48: groups of 12 bits
              that straddle a word), HDRF and Greedy, equal sizes (ties to
              partition 0), chosen equal and best bit-equal, each timed
              by CUDA-graph replays beside the previous design (the bits
              entry beside the previous gather + ``host_any`` + kernel),
              at every lane count per edge;
              device and CUDA-event timings; ``augru`` at 1, 512 and
              65,536 rows beside the previous design and cuDNN's GRU (at
              65,536 rows as equal sub-batches, in a process of its own),
              back to back between CUDA events (cuDNN also as CUDA-graph
              replays; at 65,536 rows, and both register routes at 8 to
              64 rows per SM, only with ``--previous-designs``).
              The backward kernels against their plain backwards, two
              launches bit-equal: ``flash_attention_backward`` (the CPU
              tests' cases, D 256 and 33, starcoder2-3b's heads at 4,096
              tokens in the model's layout; float32 within 1e-4 of each
              gradient's largest magnitude, bf16 elementwise within
              ``ops.bf16_gradient_bound``), ``augru_backward`` (T = 1 and
              100, H 24 to 1,000, 512 and 65,536 rows, the tile route's
              edge on this card, att == 1, ragged last tiles, the tile
              route forced at H 1, 37, 105, 128 and 512 rows and the rows
              route forced at 65,536; within 1e-5, each case's route
              reported), and
              ``spmm``'s backward (the reversed edges' bound route after a
              bound and a perm forward, D 64 and 70, weighted or not,
              wrapped and clamped src; within ``SUM_TOL``); timed beside
              SDPA's flash backward at (1, 24/2, 4,096, 128) bf16 (the
              tensor-core route, its kernels' device times from one
              profiled call, and with ``--previous-designs`` the previous
              SIMT design on the same inputs) and cuDNN's GRU backward at
              512 and 65,536 rows; ``augru_backward``'s op split into the
              kernel alone and ``du``'s product (with ``--previous-designs``
              the previous design, the rows route, on the same inputs, and
              both routes at 4 to 64 rows per SM and the tile route at 1 to
              6 row groups a tile).
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
              argmax); and, recorded but not gated, the bf16 model's 30
              layers on (1, 2,048) through the kernel and through the
              previous design, each against the plain attention.
9a. moe_serve  olmoe-1b-7b (16 layers, 64 experts top-8) and
              qwen2-moe-a2.7b (24 layers, 60 experts top-4 + 4 shared) at
              full width and depth in bf16, random weights drawn on the
              card, one model on the card at a time.  First
              ``flash_attention`` at their prefill layer ((1, 16/16,
              32,768, 128) causal bf16, v strided as in the model) held to
              the plain attention and timed beside it, its bound and SDPA.
              ``make_lm_prefill_step`` on (1, 32,768) tokens (the grouped
              dispatch, 32 groups of 1,024: C = 160 and 86), a warm-up and
              two calls, bit-equal logits, exactly one ``flash_attention``
              launch per layer and call, peak memory, one profiled call's
              device ms by kernel class (by name: ``flash_attention``,
              GEMMs, ``searchsorted``, sorts, gathers, the rest), and the
              first MoE layer alone (ms between CUDA events, its kernel
              classes, the expert GEMMs alone); ``python -m
              repro_torch.launch.serve --arch ARCH --full --requests 4
              --max-new 16`` (the global route, C = 1; no kernel launch;
              ms per decode step); olmoe's ``decode_step`` at decode_32k's
              batch of 128 (the grouped route, 4 tokens a group) on a
              64-position cache.  Then card against CPU in float32 (TF32
              off) at full width with 2 layers of each model on (1, 512)
              (grouped) and (1, 500) (global) tokens: each layer's
              ``_moe_apply`` on the same input on both devices (a routing
              flip allowed only at a near-tie, the CPU's k-th and
              (k+1)-th probabilities within 1e-6, and reported; then the
              card dispatches the CPU's experts, and every group's
              outputs are within 1e-3 of its largest magnitude; aux
              within 1e-5), the last logits within 1e-3 of
              their largest magnitude with the same argmax; and one AdamW
              step of olmoe (2 layers, float32) on (1, 512), the loss and
              every gradient within 1e-3 of its leaf's largest magnitude.
9b. lm_train  starcoder2-3b at full width and depth (bf16, 30 layers,
              ``remat="full"``) through ``make_lm_train_step`` on
              train_4k's 4,096 tokens, batch cut from 256 to 4 (the
              config's 4 microbatches of 1): a warm-up and 3 timed steps,
              each exactly 240 ``flash_attention`` forwards and 120
              backwards; step ms, tokens/s, peak memory; card against CPU
              in float32 on 2 layers and (1, 512) tokens (loss and every
              gradient within 1e-3 of the largest magnitude).
9c. recsys_train  DIEN at full width on train_batch's 65,536 rows: a
              warm-up and 3 steps, each exactly 2 ``augru`` forwards and 2
              backwards; card against CPU at 512 rows within 1e-4.
10. main_path  2PS-L through the port's partitioning CLI on an RMAT-19
              stream (the user's entry point, through
              ``MemmapEdgeStream``), k=32: one ``edge_score`` launch per
              scoring chunk, all through ``edge_score_choose_bits``.
11. hosted     the host-aware 2PS-L path (RMAT-18, 4 host groups,
              dcn_penalty 1.0), its launches checked the same way.
12. two_ps_hdrf  2PS-HDRF through the CLI at RMAT-18: one
              ``hdrf_score`` launch per scoring chunk, all through
              ``hdrf_choose_bits``, no ``edge_score``.
13. hdrf_baselines  HDRF, Greedy and host-aware HDRF through the CLI at
              RMAT-15: one ``hdrf_score`` launch per non-empty 64-edge
              micro-batch, all through ``hdrf_choose_bits``; with
              ``--previous-designs`` each run again with the previous
              composition of the choice, byte-equal, its wall beside; the
              device operations per
              micro-batch of both, profiled over one 4,096-edge chunk.
14. hash      DBH, Grid and Random through the CLI at RMAT-20.
15. hep       HEP through the CLI at RMAT-19, at the default budget (every
              vertex pinned) and at 131,072 bytes (32,768 rows: the
              in-memory and the hash path both run): no kernel launch.
16. buffered  buffered re-streaming through the CLI at RMAT-18 with the
              spec's own 16,384-edge chunks and 65,536-edge windows: one
              ``edge_score`` launch per non-empty 1,024-edge scoring
              sub-batch, all through ``edge_score_choose_bits``; the device
              operations of one window, profiled.
17. artifact  host-aware 2PS-L through the CLI at RMAT-18 (4 host groups,
              dcn_penalty 1.0) with ``--artifact-dir --local-graphs
              --plan-json --trace``: one ``edge_score`` launch per scoring
              chunk, all through ``edge_score_choose_bits``; the partition,
              halo planning, host planning and local graphs timed apart
              (the trace's spans); the artifact loaded with verification,
              its halo and host plans equal array for array to a fresh
              ``plan_halo_exchange_stream`` and ``host_plan_from_halo``,
              every local graph's ids the plan's ``vmap_global[p]``, and
              one flipped byte of ``halo_plan.npz`` refused (then put
              back: ``gnn_serve`` serves the artifact).
18. resume    the crash drill through the CLI, in processes of their own
              (``--partition-counted``): 2PS-L at RMAT-16 (three chunks a
              pass), HDRF and buffered at RMAT-14; a clean run,
              ``--checkpoint-every 2`` with
              ``REPRO_CRASH_AFTER_CHECKPOINTS=2`` (exit 137), ``--resume``:
              the clean run's sha256, and the resumed process's
              ``edge_score`` / ``hdrf_score`` launches those of the units
              at and after the checkpoint's cursor; ``--io-retries 2`` on a
              healthy stream changes nothing.
19. profile   2PS-L at RMAT-14 with ``--torch-profile DIR --trace PATH`` in
              a fresh process (beside the drill's): the span trace
              validates, and the profiler's trace holds one
              ``edge_score_bits_kernel`` record per counted launch.
20. shard     sharded 2PS-L (``repro_torch.shard``) in 16,384-edge chunks:
              (1) at RMAT-15 through the distributed CLI's emulated backend
              (worker threads, one card) at W = 1 (byte-equal to the
              sequential partition CLI run), 4 and 2: one ``edge_score``
              launch per scoring chunk summed over the workers, all through
              the bits entry; (2) ``run_spec_sharded`` at W = 3 at RMAT-14,
              card against CPU byte-equal (RF and every rank's slice
              sha256 too) for 2PS-L, hosted 2PS-L (4 hosts), HDRF with
              ``use_cap``, buffered and HEP at 131,072 bytes, the
              launches those of the sequential geometry; (3-5) at RMAT-15,
              two ranks in processes of their own (``--dist-counted``),
              all at once: the fs backend, the torch backend (gloo on
              localhost), the fs parent mode (``python -m
              repro_torch.launch.dist_partition``, ``--checkpoint-every
              1``) and the crash drill (rank 1 exits 137 after its first
              round checkpoint while rank 0 waits, then resumes): every
              stitched ``assignment.bin`` the emulated W = 2 run's sha256,
              each rank's launches its dealt scoring chunks.
21. gnn_aggregate  one GIN layer's neighbour sum at ogb_products' scale:
              4 relabelled copies of the RMAT-20 graph (~2.58M nodes,
              ~64.3M edges), ``prepare_tiles`` on the host, src and the
              edge mask bound once (``with_edges``, ``bind_s``),
              ``spmm(h, src, edge_mask, prep)`` at gin-tu's D = 64 (a
              warm-up and 5 calls, each on the bound route) and
              ``segment_sum_tiles`` of (E, 70) messages (a warm-up and 2
              calls, on the previous route), exactly one ``spmm`` launch per
              call; the outputs against the plain versions, timed by CUDA
              events beside the previous route (``previous_ms``), cuSPARSE's
              SpMM and without the hub split; the messages' sum also timed
              and checked on the bound route.
              The same phase then runs gin-tu's whole forward at full
              width (``config_for_shape("ogb_products")``: d_in 100, 5
              layers with BN) through ``gin_apply`` on that graph and
              prep: a warm-up and 2 calls, each 5 ``spmm`` launches on the
              bound route and the readout's on perm; card against CPU on
              4 copies of RMAT-14 within ``GNN_TOL``.
21a. gnn_train  gin-tu at full width on ``gnn_aggregate``'s graph: the
              batch prepared once in both directions (the reverse's host
              seconds), 3 AdamW steps, each exactly 5 ``spmm`` forwards and
              5 backwards on the bound route and the readout's forward on
              perm, run twice from the same state with bit-equal
              parameters; the backward ``spmm`` timed beside cuSPARSE's
              transposed SpMM; card against CPU on 4 RMAT-14 copies; one
              step each of GatedGCN, EGNN (``full_graph_sm``) and NequIP
              (``molecule``), every segment sum's backward a gather (33, 10
              and 16 ``spmm`` launches a step), card against CPU (1e-4).
21b. partitioned_train  gin-tu at full width (no batch norm) trained
              over the ``artifact`` phase's k = 32 partitions in one
              process on the card (``dist.make_partitioned_gin_step`` on
              a ``launch.mesh.make_host_mesh``): the host-grouped plan
              on a (4, 8) mesh and the flat plan capped at quantile 0.9
              (the overflow lane), 3 AdamW steps each, twice from the
              same state with bit-equal parameters, exactly
              ``dist.partitioned_gnn.step_spmm_launches`` ``spmm``
              launches a step (all on the bound route), the first loss
              and gradients within 1e-4 of a dense plain-torch GIN, one
              step profiled; GatedGCN and EGNN at full width, two steps
              each at RMAT-16 (exact launches, peak memory); card
              against CPU for gin-tu at RMAT-14 and GatedGCN and EGNN at
              RMAT-12 (gin-tu's and GatedGCN's features scaled so their
              first logits peak at 4; EGNN's float64 recheck as in
              ``gnn_train``), and the ranks route
              on 2 and 4 gloo ranks at RMAT-14 within 1e-5 of one
              process, every rank identical.
22. gnn_serve  ``serve_gnn`` on the ``artifact`` phase's artifact (its
              local graphs), 32 requests of 4 roots after a warm-up
              request: full fan-out cached and uncached, ``--fanout 15
              10``, 2 and 5 injected fetch faults, the CLI with ``--json``
              and the cached run on the CPU; exactly (32 + 1) x
              len(fanouts) ``spmm`` launches a call, all on the bound
              route; cached == uncached and recovered == fault-free logits
              bit for bit; card against CPU the report's counters equal
              and the logits within ``GNN_TOL``; p50/p99, hit rate and the
              spans (sampler, features, forward).
23. gnn_models  GatedGCN and EGNN at full width on ``full_graph_sm``
              (``full_graph_batch``: 2,708 nodes, d_in 1,433) and NequIP
              on ``molecule`` (``molecule_batch``: 128 x 30 atoms), each
              through its entry: every segment sum one ``spmm`` launch on
              perm (33, 10 and 16 a forward), timed by CUDA events, card
              against CPU within ``GNN_TOL``.
22a. train_cli  ``python -m repro_torch.launch.train`` on the card:
              gin-tu ``--full``, 12 steps, a failure injected at 7,
              checkpoints every 5 (``restarts=1``, 154 ``spmm`` launches,
              the losses bit-equal to a clean run's in a process of its
              own through ``-m``); DIEN 6 steps then 10 (``resuming from
              checkpoint step 6``, 2 + 2 ``augru`` launches a step);
              starcoder2-3b's smoke config.
24. bag_pool  ``embedding_bag`` over DIEN's 2,097,152 x 18 item table with
              ``InteractionStream`` histories (seq 100, ``hist_mask`` as
              the weights) at 512 and 65,536 bags, ``sum`` and ``mean``: a
              warm-up and 3 calls each, exactly one launch per call; timed
              by CUDA-graph replays beside the previous design and by
              events beside ``F.embedding_bag``; bounds on the touched
              rows, a row per lookup and the sectors each row spans.
25. ops_card_vs_cpu  ``spmm`` at D = 64 on a relabelled RMAT-16 graph and
              ``embedding_bag`` at 512 bags, on the card and on the CPU
              through the same op, within the kernels' tolerance.
26. card_vs_cpu  the same runs on the card and on the CPU: byte-equal
              (2PS-L at RMAT-16; 2PS-HDRF, HDRF, Greedy, HEP at the
              default budget, 131,072 and 8,192 bytes, and buffered at
              RMAT-14);
              the card's busy share profiled over the first 2^18 (2PS-L)
              or 2^15 edges (the card's activity alone); and at RMAT-14
              host-aware 2PS-L's artifact
              (``--artifact-dir --local-graphs``: every sidecar byte-equal,
              the manifests equal but for timings, stall report and
              route) and a checkpoint written on the card, equal to the
              CPU's and resumed on the CPU to the same bytes (and the
              CPU's on the card).

Every path phase resets every kernel's launch counter just before it and
checks the counts just after.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout
of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --previous-designs

runs the whole script and also the earlier redesigns' before/after
measurements the default run leaves out (the HDRF baselines again with
the previous composition, the previous flash design's prefill time, the
bf16 model's logits through it, cuDNN's GRU at 65,536 rows, the augru
route edges, and augru's previous backward and its route edges).

    python3 chip_smoke.py --scoring-compare

runs only the 2PS-L scoring redesign's before/after comparisons and does
nothing else:
``least_loaded_rounds`` (the overflow tail as shipped, one ``.any()`` host
sync, against its k+1 rounds run unconditionally) and ``twopsl_scoring``
(2PS-L's scoring pass through ``edge_score_choose_bits`` and with the
previous composition swapped in, new, previous, previous, new, byte-equal,
flat and with 4 hosts, and the device operations of one scoring chunk of
each), both at RMAT-16.

    python3 chip_smoke.py --spmm-tune   # the spmm bound route's shapes

rebuilds ``spmm.cu`` at each launch shape of ``SPMM_TUNE`` and times it on
``gnn_aggregate``'s graph (one JSON line each), and does nothing else.

    python3 chip_smoke.py --resume-alone

runs the ``resume`` phase's drill with one process at a time, nothing
beside it (its save, restore and start-up times), and does nothing else.

    python3 chip_smoke.py --moe-only

builds ``flash_attention`` and its backward and runs ``moe_serve``, and
does nothing else.

    python3 chip_smoke.py --partitioned-only

builds ``edge_score`` and ``spmm``, makes the ``artifact`` phase's RMAT-18
artifact and runs ``partitioned_train`` on it, and does nothing else.

    python3 chip_smoke.py --partition-counted ARGS...
    python3 chip_smoke.py --dist-counted ARGS...

runs the port's partition CLI (or its distributed CLI, one rank) on
``ARGS`` with the launch counters reset and prints its report and
launches as one JSON line (the crash drills' and the ``shard`` phase's
processes).
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
import threading
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


def ptxas_report(log: str) -> list:
    """Each compiled kernel's registers and spills from nvcc's ``-Xptxas
    -v`` output, by function (template instantiations demangled by
    ``c++filt`` where the toolkit's host tools have it)."""
    import re
    import shutil
    if shutil.which("c++filt"):
        log = subprocess.run(["c++filt"], input=log, capture_output=True,
                             text=True, check=True).stdout
    out, name = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for", 1)[1].strip()
            name = name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            out.append({"function": name})
        elif name and "spill stores" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[-1].update(stack=nums[0], spill_stores=nums[1],
                           spill_loads=nums[2])
        elif name and "Used" in ln and "registers" in ln:
            out[-1]["registers"] = int(re.search(r"Used (\d+) registers",
                                                 ln).group(1))
            name = None
    return out


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


# ---------------------------------------------------------------------------
# edge_score's bits entry: 2PS-L's whole choice from the tables themselves
# ---------------------------------------------------------------------------

#: k and E of the bits entry's checks (k = 33, 64, 200: two to seven words
#: a row); (hosts, dcn_penalty) flat and host-aware (40 hosts: two words a
#: host row)
TWOPSL_KS = (1, 2, 31, 32, 33, 64, 200)
TWOPSL_ES = (1, 64, 65536, 65537)
TWOPSL_HOSTS = ((0, 0.0), (2, 0.5), (2, 1.0), (4, 0.5), (4, 1.0), (8, 0.5),
                (8, 1.0), (40, 1.0))
#: RMAT-19 at edge factor 16 and 65,536-edge chunks: 2^19 vertices, and a
#: last chunk of 7,968,852 - 121 * 65,536 valid rows
RMAT19_V = 1 << 19
RMAT19_LAST_CHUNK = 38_996


def _random_words(rng, V: int, n: int) -> np.ndarray:
    """A (V, ceil(n/32)) packed bit matrix, a quarter of the n bits set."""
    W = -(-n // 32)
    words = (rng.integers(0, 1 << 32, (V, W), dtype=np.uint64)
             & rng.integers(0, 1 << 32, (V, W), dtype=np.uint64))
    if n % 32:
        words[:, -1] &= (1 << (n % 32)) - 1
    return words.astype(np.uint32)


def twopsl_inputs(E: int, k: int, seed: int, hosts: int = 0,
                  V: int | None = None, idx: str = "int64",
                  misaligned: bool = False, n_valid: int | None = None):
    """The bits entry's operands as the engine holds them, on the card:
    packed ``bits`` (V, ceil(k/32)) and ``hbits`` (V, ceil(H/32)), degrees
    ``d`` and clusters ``v2c`` (V,), V/4 clusters' ``vol`` and ``c2p``,
    ``host_of`` (contiguous host groups), and a chunk of E edges with the
    engine's zero-padded tail (``valid`` False from ``n_valid``, E - E/10 by
    default).  The live edges hold self-loops, edges inside one cluster and
    between two clusters of one partition (both skipped), duplicates, and
    exact ties: endpoints with empty rows, equal degrees and clusters of
    equal volume.  ``misaligned`` hands the edges as a view one id past an
    aligned base.  Returns (tensors by name, the tie edges on two
    partitions)."""
    import torch
    rng = np.random.default_rng(seed)
    V = V or (4096 if E <= 4096 else 65536)
    C = V // 4
    v2c = rng.integers(0, C, V).astype(np.int32)
    vol = rng.integers(1, 200_000, C).astype(np.int32)
    c2p = rng.integers(0, k, C).astype(np.int32)
    d = rng.integers(1, 5000, V).astype(np.int32)
    H = max(hosts, 1)
    bits, hbits = _random_words(rng, V, k), _random_words(rng, V, H)
    host_of = (np.arange(k) * H // k).astype(np.int32)
    ties = rng.choice(V, V // 16, replace=False)
    bits[ties], hbits[ties], d[ties] = 0, 0, 777
    vol[v2c[ties]] = 1000
    e = rng.integers(0, V, (E, 2))
    r = rng.random(E)
    e[r < 0.05, 1] = e[r < 0.05, 0]                        # self-loops
    first_c = np.full(C, -1)
    first_c[v2c[::-1]] = np.arange(V)[::-1]
    part = c2p[v2c]
    first_p = np.zeros(k, np.int64)
    first_p[part[::-1]] = np.arange(V)[::-1]
    m = (r >= 0.05) & (r < 0.10)                           # one cluster
    e[m, 1] = first_c[v2c[e[m, 0]]]
    m = (r >= 0.10) & (r < 0.15)                           # one partition
    e[m, 1] = first_p[part[e[m, 0]]]
    m = (r >= 0.15) & (r < 0.30)                           # exact ties
    e[m] = rng.choice(ties, (int(m.sum()), 2))
    dup = E // 50
    e[E // 2:E // 2 + dup] = e[:dup]                       # duplicates
    m[E // 2:E // 2 + dup] = r[:dup] >= 0.15
    m[E // 2:E // 2 + dup] &= r[:dup] < 0.30
    live = E - E // 10 if n_valid is None else n_valid
    e[live:] = 0
    valid = np.arange(E) < live
    pu, pv = part[e[:, 0]], part[e[:, 1]]
    tie = np.nonzero(m & valid & (pu != pv))[0]
    t = {name: torch.from_numpy(a).cuda() for name, a in (
        ("bits", bits.view(np.int32)), ("d", d), ("vol", vol),
        ("v2c", v2c), ("c2p", c2p), ("valid", valid),
        ("hbits", hbits.view(np.int32)), ("host_of", host_of))}
    dt = getattr(torch, idx)
    flat = torch.zeros(2 * E + 1, dtype=dt, device="cuda")
    off = int(misaligned)
    flat[off:off + 2 * E] = torch.from_numpy(e.reshape(-1)).to(dt)
    t["edges"] = flat[off:off + 2 * E].view(E, 2)
    return t, tie


def _bits_args(t: dict, hosts: int, pen: float):
    """(positional, keyword) arguments of ``edge_score_choose_bits``."""
    args = [t[n] for n in ("bits", "d", "vol", "v2c", "c2p", "edges",
                           "valid")]
    kw = (dict(hbits=t["hbits"], host_of=t["host_of"], dcn_penalty=pen)
          if hosts else {})
    return args, kw


def check_twopsl_bits(sizes, ks, hostings) -> dict:
    """The bits entry (``edge_score_choose_bits``) against its plain
    version on the card: ``chosen``, ``todo`` and ``hi`` equal, ``best``
    bit-equal, every tie edge on pu; every third case with int32
    endpoints, every fourth an edges view off the paired load's
    alignment; each case's endpoint load (paired or not) noted."""
    import torch
    from repro_torch.kernels.edge_score import (edge_score_choose_bits,
                                                edge_score_choose_bits_ref)
    cases, routes, ties, max_err = 0, {}, 0, 0.0
    for E in sizes:
        for k in ks:
            for hosts, pen in hostings:
                i = cases
                t, tie = twopsl_inputs(
                    E, k, seed=E * 7 + k + hosts, hosts=hosts,
                    idx="int32" if i % 3 == 0 else "int64",
                    misaligned=i % 4 == 1)
                args, kw = _bits_args(t, hosts, pen)
                got = edge_score_choose_bits(*args, **kw)
                want = edge_score_choose_bits_ref(*args, **kw)
                torch.cuda.synchronize()
                c_k, b_k, todo_k, hi_k = got
                mism = {"chosen": int((c_k != want[0]).sum()),
                        "best_bits": int((b_k.view(torch.int32)
                                          != want[1].view(torch.int32))
                                         .sum()),
                        "todo": int((todo_k != want[2]).sum()),
                        "hi": int((hi_k != want[3]).sum())}
                pu = t["c2p"][t["v2c"][t["edges"][:, 0].long()]]
                tie_t = torch.from_numpy(tie).cuda()
                ties_to_pu = bool((c_k[tie_t] == pu[tie_t]).all())
                max_err = max(max_err,
                              float((b_k - want[1]).abs().max()))
                item = t["edges"].element_size()
                route = ("paired" if t["edges"].data_ptr() % (2 * item) == 0
                         else "unpaired")
                routes[route] = routes.get(route, 0) + 1
                cases += 1
                ties += len(tie)
                if any(mism.values()) or not ties_to_pu:
                    raise AssertionError(
                        f"edge_score_choose_bits disagrees: E={E} k={k} "
                        f"hosts={hosts} pen={pen} "
                        f"idx={t['edges'].dtype} {route}: {mism}, ties to pu: "
                        f"{ties_to_pu}")
    return {"tolerance": "exact: chosen, todo and hi equal, best "
                         "bit-equal",
            "cases": cases, "cases_by_route": routes, "tie_edges": ties,
            "mismatches": 0, "max_abs_err": max_err}


def previous_twopsl_choose(bits, d, vol, v2c, c2p, edges, valid, *,
                           hbits=None, host_of=None, dcn_penalty=0.0):
    """2PS-L's choice as the slices before composed it (a comparison, never
    on the port's path, so not counted): the per-edge gathers of ``v2c``,
    ``c2p``, ``d`` and ``vol`` and four ``bitops.get`` calls (eight hosted,
    with ``host_of``), the skip test, the flag kernel through
    ``kernel.launch``, and ``hi`` as the admission tail made it."""
    import torch
    from repro_torch.core import bitops
    from repro_torch.kernels.edge_score import kernel
    u, v = edges[:, 0], edges[:, 1]
    cu, cv = v2c[u], v2c[v]
    pu, pv = c2p[cu], c2p[cv]
    todo = valid & ~((cu == cv) | (pu == pv))
    du, dv = d[u], d[v]
    hflags = None
    if dcn_penalty:
        hu, hv = host_of[pu], host_of[pv]
        hflags = (bitops.get(hbits, u, hu), bitops.get(hbits, v, hu),
                  bitops.get(hbits, u, hv), bitops.get(hbits, v, hv))
    flags = (bitops.get(bits, u, pu), bitops.get(bits, v, pu),
             bitops.get(bits, u, pv), bitops.get(bits, v, pv))
    E = edges.shape[0]
    chosen = torch.empty(E, dtype=torch.int32, device=edges.device)
    best = torch.empty(E, dtype=torch.float32, device=edges.device)
    kernel.launch((du, dv, vol[cu], vol[cv], pu, pv), flags, hflags,
                  float(dcn_penalty), chosen, best)
    return chosen, best, todo, torch.where(du >= dv, u, v)


def twopsl_bits_bound(t: dict, hosted: bool) -> dict:
    """Bounds of the bits entry on this run's chunk: the edges, valid and
    the four outputs once, each touched vertex's ``v2c``, ``d`` and words
    once, each touched cluster's ``c2p`` and ``vol`` once (and, hosted, the
    host rows and ``host_of``) (``bound_ms``); and at sector granularity,
    every per-edge read of a table as the 32-byte sector it touches
    (``sector_bound_ms``)."""
    import torch
    edges = t["edges"]
    E, item = edges.shape[0], edges.element_size()
    W, HW = t["bits"].shape[1], t["hbits"].shape[1] if hosted else 0
    verts = torch.unique(edges)
    clusters = torch.unique(t["v2c"][verts.long()])
    flat = E * (2 * item + 1 + 4 + 4 + 1 + item)
    touched = (verts.numel() * (4 + 4 + 4 * W + 4 * HW)
               + clusters.numel() * 8 + (4 * t["host_of"].numel()
                                         if hosted else 0))
    # a sector per endpoint's v2c and d, per cluster's c2p and vol, per
    # (endpoint, candidate) word (per endpoint with one word a row), and
    # hosted per candidate's host_of and (endpoint, host) word
    rows, host_rows = 2 if W == 1 else 4, 2 if HW == 1 else 4
    sectors = 4 + 4 + rows + ((2 + host_rows) if hosted else 0)
    ops = E * (30 if hosted else 24)
    return {**bound(flat + touched, ops),
            "sector_bound_ms": bound(flat + E * 32 * sectors, ops)[
                "bound_ms"],
            "touched_vertices": int(verts.numel()),
            "touched_clusters": int(clusters.numel())}


def _same_choice(got, want, what: str) -> None:
    """Raise unless the bits entry's (chosen, best, todo, hi) equal the
    plain version's, best bit for bit."""
    import torch
    torch.cuda.synchronize()
    c, b, todo, hi = got
    if not (torch.equal(c, want[0]) and torch.equal(todo, want[2])
            and torch.equal(hi, want[3])
            and torch.equal(b.view(torch.int32), want[1].view(torch.int32))):
        raise AssertionError(f"edge_score_choose_bits disagrees with its "
                             f"plain version on the timed inputs ({what})")


def time_edge_score(E: int = 65536, k: int = 32, hosts: int = 4) -> dict:
    """2PS-L's choice at (E, k) on tables of RMAT-19's size (2^19
    vertices, 2^17 clusters, random), device time per call by CUDA-graph
    replays (``graph_ms``): the bits entry (one launch) beside the previous
    composition (gathers, ``bitops.get`` and the flag kernel), the flag
    kernel alone on the gathered operands, and the plain version, flat and
    with ``hosts`` hosts; the bits entry and the previous composition also
    at 64 edges and on the ragged last chunk of RMAT-19; the host's time
    per call between CUDA events (``call_ms``); and the flag kernel's
    device time summed by torch.profiler (``profiler_ms``, the source of
    the earlier records).  The bits entry's outputs on the timed inputs are
    held to the plain version's (chosen, todo and hi equal, best
    bit-equal)."""
    from repro_torch.core import bitops
    from repro_torch.kernels.edge_score import (edge_score_choose,
                                                edge_score_choose_bits,
                                                edge_score_choose_bits_ref)
    res = {"E": E, "k": k, "V": RMAT19_V, "hosts": hosts,
           "ms_source": "CUDA events over CUDA-graph replays of 50 calls"}
    for name, h, pen in (("", 0, 0.0), ("hosted_", hosts, 1.0)):
        t, _ = twopsl_inputs(E, k, seed=7, hosts=h, V=RMAT19_V)
        args, kw = _bits_args(t, h, pen)
        u, v = t["edges"][:, 0], t["edges"][:, 1]
        cu, cv = t["v2c"][u], t["v2c"][v]
        pu, pv = t["c2p"][cu], t["c2p"][cv]
        gathered = [t["d"][u], t["d"][v], t["vol"][cu], t["vol"][cv],
                    *(bitops.get(t["bits"], x, p)
                      for x, p in ((u, pu), (v, pu), (u, pv), (v, pv))),
                    pu, pv]
        if h:
            hu, hv = t["host_of"][pu], t["host_of"][pv]
            gathered += [bitops.get(t["hbits"], x, p)
                         for x, p in ((u, hu), (v, hu), (u, hv), (v, hv))]
        new = (lambda a=args, k_=kw: edge_score_choose_bits(*a, **k_))
        prev = (lambda a=args, k_=kw: previous_twopsl_choose(*a, **k_))
        flags = (lambda g=gathered, p_=pen: edge_score_choose(
            *g, dcn_penalty=p_))
        res.update({
            f"{name}ms": graph_ms(new), f"{name}previous_ms": graph_ms(prev),
            f"{name}flags_ms": graph_ms(flags),
            f"{name}plain_ms": graph_ms(
                lambda a=args, k_=kw: edge_score_choose_bits_ref(*a, **k_),
                calls=10)})
        res[f"{name}speedup"] = res[f"{name}previous_ms"] / res[f"{name}ms"]
        b = twopsl_bits_bound(t, bool(h))
        res.update({f"{name}bound_ms": b["bound_ms"],
                    f"{name}bound_by": b["bound_by"],
                    f"{name}sector_bound_ms": b["sector_bound_ms"],
                    f"{name}touched_vertices": b["touched_vertices"],
                    f"{name}touched_clusters": b["touched_clusters"]})
        _same_choice(new(), edge_score_choose_bits_ref(*args, **kw),
                     f"{name}E={E}")
        if h:
            res["call_ms"] = cuda_time_ms(new, 200, 20)
            res["previous_call_ms"] = cuda_time_ms(prev, 200, 20)
            res["profiler_ms"] = {"bits": device_ms_per_call(new),
                                  "flags": device_ms_per_call(flags)}
            res["flags_bound_ms"] = bound(E * 36, E * 22)["bound_ms"]
    for name, n, live in (("e64_", 64, None),
                          ("last_chunk_", E, RMAT19_LAST_CHUNK)):
        t, _ = twopsl_inputs(n, k, seed=8, V=RMAT19_V, n_valid=live)
        args, _ = _bits_args(t, 0, 0.0)
        _same_choice(edge_score_choose_bits(*args),
                     edge_score_choose_bits_ref(*args), f"{name}E={n}")
        res[f"{name}ms"] = graph_ms(
            lambda a=args: edge_score_choose_bits(*a))
        res[f"{name}previous_ms"] = graph_ms(
            lambda a=args: previous_twopsl_choose(*a))
    res["checked"] = "exact: chosen, todo and hi equal, best bit-equal"
    res["library_ms"] = None
    return res


# ---------------------------------------------------------------------------
# edge_score's bits entry at buffered re-streaming's sub-batch shape
# ---------------------------------------------------------------------------

#: max id + 1 of rmat_graph(18, edge_factor=16, seed=0), the buffered
#: path's graph
RMAT18_V = 173_847
#: the buffered spec's window (4 chunks of 16,384 edges) and sub-batch
BUFFERED_WINDOW = 1 << 16
BUFFERED_SUB = 1024
#: vertices and clusters of one 65,536-edge window of that graph
#: (``window_clusters`` on its first window: 37,581 and 15,742)
BUFFERED_LOCAL, BUFFERED_CLUSTERS = 37_581, 15_742


def buffered_inputs(n_valid: int, seed: int, k: int = 32) -> dict:
    """The bits entry's operands as buffered re-streaming hands them over
    for one sub-batch, on the card: ``bits``, ``d`` and ``v2c`` of
    RMAT-18's |V|; the window tables ``c2p`` and ``vol`` of 2 x 65,536 rows,
    live for the window's clusters and zero past them, as the engine pads
    them; ``v2c`` holding the window's labels on its own vertices and stale
    labels of earlier windows everywhere else; 1,024 int64 edges over the
    window's vertices (self-loops, edges inside one cluster, duplicates)
    with the engine's zero-padded tail from ``n_valid``."""
    import torch
    rng = np.random.default_rng(seed)
    V, cpad, E = RMAT18_V, 2 * BUFFERED_WINDOW, BUFFERED_SUB
    C = BUFFERED_CLUSTERS
    window = rng.choice(V, BUFFERED_LOCAL, replace=False)
    labels = rng.integers(0, C, BUFFERED_LOCAL)
    v2c = rng.integers(0, cpad, V).astype(np.int32)        # stale labels
    v2c[window] = labels
    c2p = np.zeros(cpad, np.int32)
    c2p[:C] = rng.integers(0, k, C)
    vol = np.zeros(cpad, np.int32)
    vol[:C] = rng.integers(1, 2 * BUFFERED_WINDOW // k, C)
    d = rng.integers(1, 5000, V).astype(np.int32)
    bits = _random_words(rng, V, k)
    e = window[rng.integers(0, BUFFERED_LOCAL, (E, 2))]
    r = rng.random(E)
    e[r < 0.05, 1] = e[r < 0.05, 0]                        # self-loops
    first = np.full(C, -1, np.int64)
    first[labels[::-1]] = window[::-1]
    m = (r >= 0.05) & (r < 0.15)                           # one cluster
    e[m, 1] = first[v2c[e[m, 0]]]
    e[E // 2:E // 2 + E // 50] = e[:E // 50]               # duplicates
    e[n_valid:] = 0
    t = {name: torch.from_numpy(a).cuda() for name, a in (
        ("bits", bits.view(np.int32)), ("d", d), ("vol", vol),
        ("v2c", v2c), ("c2p", c2p), ("valid", np.arange(E) < n_valid),
        ("edges", e.astype(np.int64)))}
    return t


def time_edge_score_buffered(k: int = 32) -> dict:
    """``edge_score_choose_bits`` at buffered's sub-batch (1,024 edges,
    k = 32, RMAT-18-sized bits/d/v2c, 131,072-row window tables, stale
    ``v2c`` outside the window), full and with 300 valid rows (a ragged
    last sub-batch): chosen, todo and hi equal to the plain version's and
    best bit-equal; device time by CUDA-graph replays (``graph_ms``), the
    plain version's beside, and the bound on this run's inputs."""
    from repro_torch.kernels.edge_score import (edge_score_choose_bits,
                                                edge_score_choose_bits_ref)
    out = {"E": BUFFERED_SUB, "k": k, "V": RMAT18_V,
           "window_rows": 2 * BUFFERED_WINDOW,
           "checked": "exact: chosen, todo and hi equal, best bit-equal",
           "ms_source": "CUDA events over CUDA-graph replays of 50 calls"}
    for name, live in (("", BUFFERED_SUB), ("ragged_", 300)):
        t = buffered_inputs(live, seed=21 + live, k=k)
        args, _ = _bits_args(t, 0, 0.0)
        _same_choice(edge_score_choose_bits(*args),
                     edge_score_choose_bits_ref(*args),
                     f"buffered sub-batch, {live} valid rows")
        b = twopsl_bits_bound(t, False)
        out.update({
            f"{name}valid_rows": live,
            f"{name}ms": graph_ms(lambda a=args: edge_score_choose_bits(*a)),
            f"{name}plain_ms": graph_ms(
                lambda a=args: edge_score_choose_bits_ref(*a), calls=10),
            f"{name}bound_ms": b["bound_ms"], f"{name}bound_by": b["bound_by"],
            f"{name}sector_bound_ms": b["sector_bound_ms"]})
    return out


# ---------------------------------------------------------------------------
# hdrf_score inputs: random rows, a zero-padded tail, all-zero flag rows
# ---------------------------------------------------------------------------

HDRF_LAM = 1.1
#: k checked on the card: one partition, the thread route's edges (31-33,
#: 64), host groups of 12 bits that straddle a word (48 with 4 hosts), the
#: warp route (200)
HDRF_KS = (1, 2, 7, 31, 32, 33, 48, 64, 200)
HDRF_ES = (1, 64, 65536, 65537)
#: k at the edge of c_bal in shared memory (the largest in it, and the
#: first 48 KB of c_bal, which is past it), checked at 64 edges
HDRF_WIDE_KS = (12160, 12288)
#: host groups of the host-aware cases, where they divide k
HDRF_HOSTS = 4


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


def hdrf_bits_inputs(E: int, k: int, seed: int, equal_sizes: bool, device,
                     idx: str = "int64"):
    """The bits entry's operands as the chunk functions hold them: a
    packed (V, ceil(k/32)) int32 bit matrix (a third of the bits set, a
    tenth of the rows empty), int32 degrees, endpoints ``uv`` = [u...,
    v...] with the engine's zero-padded tail, and sizes.  A tenth of the
    live edges join two empty rows: under ``equal_sizes`` they tie on every
    partition and must pick 0.  Returns (bits, d, uv, sizes) and the tie
    edges."""
    import torch
    rng = np.random.default_rng(seed)
    V = 4096 if E <= 4096 else 65536
    W = -(-k // 32)
    flags = rng.random((V, W * 32)) < 0.3
    flags[:, k:] = False
    empty = rng.choice(V, size=V // 10, replace=False)
    flags[empty] = False
    words = (flags.reshape(V, W, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    d = rng.integers(1, 5000, V).astype(np.int32)
    uv = rng.integers(0, V, (2, E))
    sizes = (np.full(k, 1000, np.int32) if equal_sizes
             else rng.integers(0, 100_000, k).astype(np.int32))
    live = E - E // 10
    tie = rng.choice(live, size=live // 10, replace=False) if live else []
    uv[:, tie] = rng.choice(empty, size=(2, len(tie)))
    uv[:, live:] = 0
    t = [torch.from_numpy(a).to(device) for a in
         (words.view(np.int32), d, uv.reshape(-1).astype(idx), sizes)]
    return t, np.asarray(tie, np.int64)


def _exact(c_k, b_k, c_p, b_p) -> tuple[int, int]:
    """(chosen mismatches, best bit mismatches) of two results."""
    import torch
    return (int((c_k != c_p).sum()),
            int((b_k.view(torch.int32) != b_p.view(torch.int32)).sum()))


def hdrf_cases(sizes, ks):
    """(E, k, degree_weighted, dcn_penalty, hosts, equal_sizes): flat and
    with ``HDRF_HOSTS`` host groups where they divide k, HDRF and Greedy,
    random and equal sizes."""
    for E in sizes:
        for k in ks:
            for dw in (True, False):
                for pen, hosts in ((0.0, 0), (0.7, HDRF_HOSTS)):
                    if hosts and k % hosts:
                        continue
                    for eq in (False, True):
                        yield E, k, dw, pen, hosts, eq


def check_hdrf_score(sizes, ks) -> dict:
    """The flag entry (``hdrf_choose``) against its plain version on the
    card (and the plain version on the card against the CPU), flat and
    host-aware, HDRF and Greedy, random and equal partition sizes: chosen
    equal, best bit-equal."""
    import torch
    from repro_torch.kernels.hdrf_score import hdrf_choose, hdrf_choose_ref
    cases, max_err = [], 0.0
    for E, k, dw, pen, hosts, eq in hdrf_cases(sizes, ks):
        args, host, tie = hdrf_inputs(E, k, seed=E + k, hosts=hosts,
                                      equal_sizes=eq, device="cuda")
        kw = dict(lam=HDRF_LAM, dcn_penalty=pen, degree_weighted=dw)
        c_k, b_k = hdrf_choose(*args, *host, **kw)
        c_p, b_p = hdrf_choose_ref(*args, *host, **kw)
        cpu = [a.cpu() for a in args + host]
        c_c, b_c = hdrf_choose_ref(*cpu, **kw)
        torch.cuda.synchronize()
        c_k, b_k, c_p, b_p = (x.cpu() for x in (c_k, b_k, c_p, b_p))
        mism, bits_diff = _exact(c_k, b_k, c_p, b_p)
        cpu_diff = sum(_exact(c_p, b_p, c_c, b_c))
        ties_to_0 = (not eq) or bool((c_k[tie] == 0).all())
        err = float((b_k - b_p).abs().max()) if E else 0.0
        max_err = max(max_err, err)
        cases.append({
            "E": E, "k": k, "degree_weighted": dw, "dcn_penalty": pen,
            "equal_sizes": eq, "chosen_mismatches": mism,
            "best_bit_mismatches": bits_diff,
            "plain_card_vs_cpu_mismatches": cpu_diff,
            "tie_rows": len(tie) if eq else 0,
            "ties_to_partition_0": ties_to_0})
        if mism or bits_diff or cpu_diff or not ties_to_0:
            raise AssertionError(f"hdrf_score disagrees: {cases[-1]}")
    return {"tolerance": "exact: chosen equal, best bit-equal",
            "cases": len(cases),
            "tie_rows": sum(c["tie_rows"] for c in cases),
            "chosen_mismatches": 0, "best_bit_mismatches": 0,
            "max_abs_err": max_err}


def check_hdrf_bits(sizes, ks) -> dict:
    """The bits entry (``hdrf_choose_bits``) against its plain version on
    the card, in the same cases as the flag entry (every third case with
    int32 endpoints), each case's route noted: chosen equal, best
    bit-equal, the tie edges on partition 0 under equal sizes."""
    import torch
    from repro_torch.kernels.hdrf_score import (hdrf_choose_bits,
                                                hdrf_choose_bits_ref, kernel)
    cases, routes, max_err = 0, {}, 0.0
    for i, (E, k, dw, pen, hosts, eq) in enumerate(hdrf_cases(sizes, ks)):
        args, tie = hdrf_bits_inputs(E, k, seed=E * 7 + k, equal_sizes=eq,
                                     device="cuda",
                                     idx="int32" if i % 3 == 0 else "int64")
        kw = dict(k=k, lam=HDRF_LAM, num_hosts=hosts, dcn_penalty=pen,
                  degree_weighted=dw)
        c_k, b_k = hdrf_choose_bits(*args, **kw)
        c_p, b_p = hdrf_choose_bits_ref(*args, **kw)
        torch.cuda.synchronize()
        mism, bits_diff = _exact(c_k, b_k, c_p, b_p)
        ties_to_0 = (not eq) or bool((c_k.cpu()[tie] == 0).all())
        max_err = max(max_err, float((b_k - b_p).abs().max()))
        route = kernel.plan(E, k, kernel.sm_count(0)).route
        routes[route] = routes.get(route, 0) + 1
        cases += 1
        if mism or bits_diff or not ties_to_0:
            raise AssertionError(
                f"hdrf_choose_bits disagrees: E={E} k={k} dw={dw} "
                f"pen={pen} equal_sizes={eq} route={route}: {mism} chosen, "
                f"{bits_diff} best mismatches, ties to 0: {ties_to_0}")
    return {"tolerance": "exact: chosen equal, best bit-equal",
            "cases": cases, "cases_by_route": routes,
            "chosen_mismatches": 0, "best_bit_mismatches": 0,
            "max_abs_err": max_err}


def graph_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph after a warm-up, its replays timed back to back between CUDA
    events, which leaves out the host's launch cost (longer than a short
    kernel)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    ms = batched_ms(g.replay, reps, 1) / calls
    del g
    return ms


_PARTS: dict = {}


def previous_choose_bits(bits, d, uv, sizes, *, k, lam, num_hosts=0,
                         dcn_penalty=0.0, degree_weighted=True):
    """The chunk functions' choice as the previous slice composed it (a
    comparison, never on the port's path, so not counted): the (2E, k)
    flags gathered with ``bitops.get`` (``parts`` made once per k), the
    degrees ``d[uv]``, ``host_any`` when hosted, then the previous kernel
    on the flag entry's arguments."""
    import torch
    from repro_torch.core import bitops
    from repro_torch.core.scoring import host_any
    from repro_torch.kernels.hdrf_score import kernel
    E = uv.shape[0] // 2
    key = (k, str(uv.device))
    if key not in _PARTS:
        _PARTS[key] = torch.arange(k, device=uv.device)
    rep = bitops.get(bits, uv[:, None], _PARTS[key][None, :])
    d_uv = d[uv]
    hosted = bool(dcn_penalty) and num_hosts > 1
    h = host_any(rep, num_hosts) if hosted else None
    chosen = torch.empty(E, dtype=torch.int32, device=uv.device)
    best = torch.empty(E, dtype=torch.float32, device=uv.device)
    kernel.launch_previous(
        d_uv[:E], d_uv[E:], rep[:E], rep[E:], sizes,
        h[:E] if hosted else None, h[E:] if hosted else None, lam=lam,
        dcn_penalty=float(dcn_penalty) if hosted else 0.0,
        degree_weighted=degree_weighted, chosen=chosen, best=best)
    return chosen, best


def hdrf_bits_bound(bits, uv, k: int) -> dict:
    """Bounds of the bits entry on this run's endpoints: each touched
    vertex's words and degree read once, the endpoints, sizes and outputs
    (``bound_ms``); and at sector granularity, each endpoint's degree and
    words as the 32-byte sectors they touch (``sector_bound_ms``)."""
    import torch
    E = uv.shape[0] // 2
    W = bits.shape[1]
    touched = int(torch.unique(uv).numel())
    flat = uv.numel() * uv.element_size() + 4 * k + 8 * E
    sectors = 2 * E * 32 * (1 + -(-4 * W // 32))
    ops = E * (5 + 3 * k)
    return {**bound(flat + touched * (4 * W + 4), ops),
            "sector_bound_ms": bound(flat + sectors, ops)["bound_ms"],
            "touched_vertices": touched}


def time_hdrf_score(E: int, k: int = 32, lanes=(1, 2, 4, 8, 16, 32)) -> dict:
    """Both entries at (E, k) beside the previous design, device time per
    call by CUDA-graph replays (``graph_ms``): the flag entry's kernel
    against the previous kernel; the bits entry's whole choice (one
    launch) against the previous composition (gather, ``host_any`` and the
    previous kernel), flat and with 4 hosts; each plain version; each lane
    count forced (``lanes_ms``); the device time of the same calls summed
    by torch.profiler (``profiler_ms``, the source of the earlier records);
    and the host's time per call between CUDA events (``call_ms``)."""
    import torch
    from repro_torch.kernels.hdrf_score import (hdrf_choose, hdrf_choose_bits,
                                                hdrf_choose_bits_ref,
                                                hdrf_choose_ref, kernel)
    args, _, _ = hdrf_inputs(E, k, seed=7, hosts=0, equal_sizes=False,
                             device="cuda")
    bargs, _ = hdrf_bits_inputs(E, k, seed=7, equal_sizes=False,
                                device="cuda")
    out = [torch.empty(E, dtype=torch.int32, device="cuda"),
           torch.empty(E, device="cuda")]
    kw = dict(lam=HDRF_LAM, dcn_penalty=0.0, degree_weighted=True)

    def previous():
        kernel.launch_previous(*args, None, None, **kw, chosen=out[0],
                               best=out[1])

    def bits(hosts=0):
        return lambda: hdrf_choose_bits(*bargs, k=k, lam=HDRF_LAM,
                                        num_hosts=hosts,
                                        dcn_penalty=0.7 if hosts else 0.0)

    def bits_previous(hosts=0):
        return lambda: previous_choose_bits(*bargs, k=k, lam=HDRF_LAM,
                                            num_hosts=hosts,
                                            dcn_penalty=0.7 if hosts else 0.0)

    sms = kernel.sm_count(0)
    vec = kernel.flag_vec(k, args[2].data_ptr() | args[3].data_ptr())
    forced = {}
    for n in lanes:
        pf = kernel.plan(E, k, sms, vec, lanes=n)
        pb = kernel.plan(E, k, sms, lanes=n)
        forced[n] = {
            "flags": graph_ms(lambda: kernel.launch_flags(
                *args, None, None, **kw, chosen=out[0], best=out[1],
                use_plan=pf)),
            "bits": graph_ms(lambda: kernel.launch_bits(
                *bargs, k=k, lam=HDRF_LAM, dcn_penalty=0.0, group=k,
                degree_weighted=True, chosen=out[0], best=out[1],
                use_plan=pb))}
    res = {"E": E, "k": k, "plan": vars(kernel.plan(E, k, sms)),
           "flags_plan": vars(kernel.plan(E, k, sms, vec)),
           "ms_source": "CUDA events over CUDA-graph replays of 50 calls",
           "flags_ms": graph_ms(lambda: hdrf_choose(*args, lam=HDRF_LAM)),
           "flags_previous_ms": graph_ms(previous),
           "flags_plain_ms": graph_ms(
               lambda: hdrf_choose_ref(*args, lam=HDRF_LAM), calls=10),
           "bits_ms": graph_ms(bits()),
           "bits_previous_ms": graph_ms(bits_previous()),
           "bits_plain_ms": graph_ms(lambda: hdrf_choose_bits_ref(
               *bargs, k=k, lam=HDRF_LAM), calls=10),
           "bits_hosted_ms": graph_ms(bits(HDRF_HOSTS)),
           "bits_hosted_previous_ms": graph_ms(bits_previous(HDRF_HOSTS)),
           "lanes_ms": forced,
           "profiler_ms": {
               "flags": device_ms_per_call(
                   lambda: hdrf_choose(*args, lam=HDRF_LAM)),
               "flags_previous": device_ms_per_call(previous),
               "bits": device_ms_per_call(bits()),
               "bits_previous": device_ms_per_call(bits_previous())},
           "call_ms": cuda_time_ms(bits(), 200, 20),
           "previous_call_ms": cuda_time_ms(bits_previous(), 200, 20),
           "flags_bound_ms": bound(E * (4 + 4 + 2 * k + 4 + 4) + 4 * k,
                                   E * (5 + 3 * k))["bound_ms"],
           **hdrf_bits_bound(bargs[0], bargs[2], k), "library_ms": None}
    res["bits_speedup"] = res["bits_previous_ms"] / res["bits_ms"]
    return res


# ---------------------------------------------------------------------------
# augru inputs: the reference test's distributions, att == 1 or random
# ---------------------------------------------------------------------------

AUGRU_TOL = 1e-5
#: (B, T, H) checked on the card: the reference test's shapes; the serve
#: paths'; the small route's edges at DIEN's H (one row, and B around
#: one, two and four rows per SM on 132 SMs), T = 1 and an H that is not a
#: multiple of 4 on it; an H whose U (3H^2 float32, 307 KB) does not fit in
#: shared memory, so the general route reads it from global memory, and
#: one whose recurrent state does not fit either, so it lives in global
#: scratch.  ``augru_check_shapes`` adds the large route's edges on this
#: card.
AUGRU_CHECK = ((1, 1, 1), (4, 7, 16), (33, 50, 108), (8, 100, 128),
               (512, 100, 108), (65_536, 100, 108), (5, 9, 160),
               (2, 4, 3000), (1, 100, 108), (2, 100, 108), (131, 100, 108),
               (132, 100, 108), (133, 100, 108), (511, 100, 108),
               (513, 100, 108), (3, 1, 108), (7, 20, 37))
#: (route, T == 1, H % 4 != 0) that the checked shapes must reach: T = 1
#: and an H off a multiple of 4 (the large route's scalar variant,
#: ``tile::augru_kernel<false>``) on both register routes
AUGRU_EDGES = (("small", True, False), ("small", False, True),
               ("large", True, False), ("large", False, True))
#: the serve and retrieval shapes, where the previous design is also held
#: to the new one
AUGRU_SERVE = ((1, 100, 108), (512, 100, 108), (65_536, 100, 108))


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


def augru_check_shapes() -> tuple:
    """``AUGRU_CHECK`` and the large route's edges on this card: the first
    B that ``kernel.plan`` sends there at H = 108 and the B just below it,
    and that B at T = 1 and at H = 37."""
    from repro_torch.kernels.augru import kernel
    sms, smem = kernel.device_limits(0)
    first = next(B for B in range(1, 64 * sms)
                 if kernel.plan(B, 108, sms, smem).route == "large")
    return AUGRU_CHECK + ((first - 1, 100, 108), (first, 100, 108),
                          (first, 1, 108), (first, 5, 37))


def check_augru(shapes) -> dict:
    """The CUDA kernel against its plain version on the card, att == 1 (the
    GRU stage) and random att: every state within ``AUGRU_TOL``, each
    case's route reported; a second launch on the same inputs bit-equal to
    the first; on ``AUGRU_SERVE`` the previous design within
    ``AUGRU_TOL`` of the new one."""
    import torch
    from repro_torch.kernels.augru import augru, augru_ref, kernel
    cases, max_err = [], 0.0
    for B, T, H in shapes:
        for ones in (True, False):
            args = augru_inputs(B, T, H, seed=B + T + H, ones=ones,
                                device="cuda")
            got = augru(*args)
            again = augru(*args)
            want = augru_ref(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            case = {"B": B, "T": T, "H": H, "att": "ones" if ones
                    else "random", "route": kernel.plan_for(got).route,
                    "max_abs_err": err, "bit_equal": torch.equal(got, again),
                    "u_bytes": 3 * H * H * 4}
            if (B, T, H) in AUGRU_SERVE:
                prev = torch.empty_like(got)
                kernel.launch_previous(*args, out=prev)
                torch.cuda.synchronize()
                case["previous_max_abs_diff"] = float(
                    (prev - got).abs().max())
                del prev
            cases.append(case)
            if not (err <= AUGRU_TOL and case["bit_equal"]
                    and case.get("previous_max_abs_diff", 0.0)
                    <= AUGRU_TOL):
                raise AssertionError(f"augru disagrees: {case}")
            del args, got, again, want
    torch.cuda.empty_cache()
    reached = {(c["route"], c["T"] == 1, c["H"] % 4 != 0) for c in cases}
    missing = [e for e in AUGRU_EDGES if e not in reached]
    if missing:
        raise AssertionError(f"augru: no checked shape reached {missing}")
    return {"tolerance": f"max |kernel - plain| <= {AUGRU_TOL}; two "
                         f"launches bit-equal; max |previous - kernel| <= "
                         f"{AUGRU_TOL} on the serve shapes",
            "cases": cases, "max_abs_err": max_err}


def gru_library_ms(B: int, T: int = 100, e: int = 18, H: int = 108,
                   reps: int = 20, split: int = 1,
                   graph: bool = False) -> float:
    """cuDNN's GRU (``torch.nn.GRU``, float32 without TF32) on (B, T, e):
    the dense 18 -> 324 and the GRU recurrence of DIEN's att == 1 stage in
    one library call, or in ``split`` calls on equal sub-batches, timed
    together back to back between CUDA events (``batched_ms``).  With
    ``graph``, the calls are captured in a CUDA graph and its replays
    timed, which leaves out the host's time per call: at one row the host
    takes longer than the device.  Its z gate is the complement of AUGRU's,
    so it is a yardstick of speed only, never of parity."""
    import torch
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gru = torch.nn.GRU(e, H, batch_first=True).cuda()
        x = torch.randn(B, T, e, device="cuda")
        parts = x.chunk(split)
        with torch.no_grad():
            if not graph:
                return batched_ms(lambda: [gru(p) for p in parts], reps,
                                  max(1, reps // 5))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for p in parts:
                    gru(p)
            torch.cuda.current_stream().wait_stream(side)
            g, calls = torch.cuda.CUDAGraph(), min(reps, 20)
            with torch.cuda.graph(g):
                for _ in range(calls):
                    for p in parts:
                        gru(p)
            return batched_ms(g.replay, 5, 1) / calls
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


#: torch.nn.GRU's cuDNN call faults (an illegal memory access, in a
#: process of its own) at batch 65,536 of (100, 18) on the card, and runs
#: at 32,768: above this batch the library is timed as the sum of equal
#: sub-batches (``gru_split_library``)
GRU_MAX_BATCH = 32_768
#: sub-batch counts tried above ``GRU_MAX_BATCH``, the first that runs kept
GRU_SPLITS = (2, 4, 8)


def gru_split_library(B: int, reps: int = 5) -> dict:
    """cuDNN's GRU at batch ``B`` as ``n`` calls of ``B // n`` rows, timed
    together, for the first ``n`` of ``GRU_SPLITS`` that runs; each try in a
    process of its own (``--gru-library``), since a fault ends the process's
    CUDA context.  The error text of each split that faults."""
    errors = {}
    for n in GRU_SPLITS:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--gru-library",
             str(B), str(n), str(reps)], capture_output=True, text=True,
            timeout=600)
        if proc.returncode == 0:
            ms = json.loads(proc.stdout.strip().splitlines()[-1])["ms"]
            return {"library_ms": ms, "library_split_errors": errors,
                    "library": f"torch.nn.GRU(18, 108), cuDNN, float32, as "
                               f"{n} calls of {B // n} rows on (., 100, 18), "
                               f"timed together (one call of {B} faults)"}
        tail = (proc.stderr or proc.stdout).strip().splitlines()
        errors[n] = tail[-1] if tail else f"exit {proc.returncode}"
    return {"library_ms": None, "library_split_errors": errors,
            "library": f"none: cuDNN's GRU faults at batch {B} split into "
                       f"{GRU_SPLITS} equal sub-batches"}


def time_augru(B: int, T: int = 100, H: int = 108, reps: int = 50,
               library: bool = True) -> dict:
    """The kernel (by ``kernel.launch``, the route ``ops.augru`` takes),
    the previous design (``kernel.launch_previous``), the plain version and
    cuDNN's GRU at (B, T, H), each as ``reps`` back-to-back calls between
    CUDA events (``batched_ms``) in this run, cuDNN also as CUDA-graph
    replays (``library_ms`` up to ``GRU_MAX_BATCH``: the device's time
    alone); per step (ms / T) beside each.  ``op_call_ms``: one
    ``ops.augru`` call between events, the host's checks and launch
    included.  ``library=False`` leaves cuDNN out (above ``GRU_MAX_BATCH``
    its split takes a process of its own per try)."""
    import torch
    from repro_torch.kernels.augru import augru, augru_ref, kernel
    args = augru_inputs(B, T, H, seed=7, ones=False, device="cuda")
    out = torch.empty((B, T, H), device="cuda")
    warm = max(1, reps // 10)
    ms = batched_ms(lambda: kernel.launch(*args, out=out), reps, warm)
    previous_ms = batched_ms(lambda: kernel.launch_previous(*args, out=out),
                             reps, warm)
    plain_ms = batched_ms(lambda: augru_ref(*args), max(2, reps // 10), 1)
    op_call_ms = cuda_time_ms(lambda: augru(*args), max(5, reps // 2), 2)
    # bytes: x_gates, u, att, h0 read once, the states written once;
    # operations: the products hU = h @ U, 2*H*3H per (row, step) (the
    # gates add ~1% and are not counted, so the bound stays a lower one)
    nbytes = 4 * (B * T * 3 * H + 3 * H * H + B * T + B * H + B * T * H)
    res = {"B": B, "T": T, "H": H, "route": kernel.plan_for(out).route,
           "ms": ms, "us_per_step": ms / T * 1e3,
           "previous_ms": previous_ms,
           "previous_us_per_step": previous_ms / T * 1e3,
           "speedup_over_previous": previous_ms / ms,
           "plain_ms": plain_ms, "op_call_ms": op_call_ms,
           "ms_source": "cuda_events (batched_ms)",
           **bound(nbytes, 2 * B * T * H * 3 * H)}
    del args, out
    torch.cuda.empty_cache()
    if not library:
        return {**res, "library_ms": None}
    res.update({"library_ms": gru_library_ms(B, T, reps=reps, graph=True),
                "library_batched_ms": gru_library_ms(B, T, reps=reps),
                "library": "torch.nn.GRU(18, 108) on (B, 100, 18), cuDNN, "
                           "float32 (the att == 1 stage with its input "
                           "dense), replays of a CUDA graph of the calls "
                           "(library_batched_ms: back to back)"}
               if B <= GRU_MAX_BATCH else gru_split_library(B, reps))
    if res["library_ms"] is not None:
        res["library_us_per_step"] = res["library_ms"] / T * 1e3
        res["library_over_kernel"] = res["library_ms"] / ms
    return res


def time_augru_edge(rows_per_sm=(8, 16, 32, 48, 56, 64), T: int = 100, H: int = 108,
                    reps: int = 10) -> dict:
    """Both register routes at B = ``rows_per_sm`` x the card's SMs, where
    ``kernel.plan`` switches from the small route (R = 4 over several tiles
    a block) to the large one at ``kernel.LARGE_ROWS_PER_SM``: each timed
    back to back between CUDA events (``batched_ms``) in this run, beside
    the route the plan picks."""
    import torch
    from repro_torch.kernels.augru import kernel
    sms, smem = kernel.device_limits(0)
    res = {"sms": sms, "large_rows_per_sm": kernel.LARGE_ROWS_PER_SM}
    for n in rows_per_sm:
        B = n * sms
        args = augru_inputs(B, T, H, seed=11, ones=False, device="cuda")
        out = torch.empty((B, T, H), device="cuda")
        plans = {"small": kernel.small_plan(B, H, 4, sms),
                 "large": kernel.tile_plan(B, H, sms, smem)}
        res[str(n)] = {"B": B, "plan": kernel.plan_for(out).route, **{
            f"{name}_ms": batched_ms(lambda p=p: kernel.launch(
                *args, out=out, use_plan=p), reps, 2)
            for name, p in plans.items()}}
        del args, out
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# flash_attention inputs: the reference test's cases and the LM's shapes
# ---------------------------------------------------------------------------

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: (B, Hq, Hkv, Sq, Skv, D, causal, dtype) checked on the card: the
#: reference test's seven cases, starcoder2-3b's heads (24 over 2) causal at
#: 4,096 tokens in both dtypes, one decode step against a 32,768-key cache,
#: a chunked prefill, the largest head dim and a ragged one, non-causal;
#: then the tensor-core kernel's edges in bf16: D = 16, 32 and 80 (zero-
#: padded to 64 and 128) and 256, an odd D (33: element staging), query
#: runs that are not a multiple of the 128-row tile, non-causal 8:1 GQA,
#: decode and chunked prefill at small D
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
    (1, 2, 2, 100, 100, 16, True, "bfloat16"),
    (2, 4, 2, 256, 256, 32, True, "bfloat16"),
    (1, 4, 1, 65, 65, 80, False, "bfloat16"),
    (1, 4, 2, 300, 300, 256, True, "bfloat16"),
    (1, 4, 2, 130, 130, 33, True, "bfloat16"),
    (1, 8, 1, 1000, 1000, 128, False, "bfloat16"),
    (1, 4, 2, 1, 512, 64, True, "bfloat16"),
    (1, 2, 1, 130, 390, 32, True, "bfloat16"),
)
#: starcoder2-3b's prefill heads at 4,096 tokens in bf16 in the model's
#: layout (v a strided view)
FLASH_MODEL = ((1, 24, 2, 4096, 4096, 128, True, "bfloat16"),)
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


#: the bf16 elementwise bound, ``ops.bf16_output_bound`` (its docstring
#: derives it): 2^-8 plain(q, k, |v|) for the kernel's bf16 rounding of P,
#: 2^-7 |plain| for one rounding of the output, 1e-5 of float32 slack
BF16_BOUND = ("|kernel - plain| <= 2^-8 plain_attention(q, k, |v|) + 2^-7 "
              "|plain| + 1e-5 elementwise")


def flash_agree(got, want, dtype: str, args, causal: bool = True) -> dict:
    """max |kernel - plain| against the reference test's tolerance of the
    dtype; for bf16 also every element against ``BF16_BOUND`` on the
    operands ``args`` (q, k, v), which, unlike the reference's absolute
    2e-2, is smaller than the outputs themselves (~0.009 at 32,768 keys).
    For the record, bf16 also reports the largest excess over the one-
    rounding bound 2^-7 |plain| + 1e-5 that held before P was rounded to
    bf16."""
    from repro_torch.kernels.flash_attention import ops
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    err = float(diff.max())
    line = {"max_abs_err": err, "max_abs_out": float(want.abs().max())}
    ok = err <= FLASH_TOL[dtype]
    if dtype == "bfloat16":
        bound = ops.bf16_output_bound(*args, causal=causal)
        excess = float((diff / bound).max())
        del bound
        line["max_err_over_elementwise_bound"] = excess
        line["max_err_over_one_rounding_bound"] = float(
            (diff / (ops.BF16_OUT_REL * want.abs() + ops.BF16_ABS)).max())
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
                    **flash_agree(got, want, dtype, args, causal)})
        max_err = max(max_err, out[-1]["max_abs_err"])
        if not out[-1]["ok"]:
            raise AssertionError(f"flash_attention disagrees: {out[-1]}")
        del args, got, want
    torch.cuda.empty_cache()
    return {"tolerance": f"max |kernel - plain| <= {FLASH_TOL}; bf16 also "
                         f"{BF16_BOUND}",
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


def previous_attention(q, k, v, *, causal: bool = True):
    """The previous bf16 design (the SIMT kernel) on the op's arguments, to
    time it beside the tensor-core kernel; no launch counter counts it."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernel.launch_previous(q, k, v, out=out, causal=causal,
                           scale=1.0 / (q.shape[-1] ** 0.5))
    return out


def time_flash_attention(S: int, Hq: int = 24, Hkv: int = 2,
                         D: int = 128, previous: bool = False) -> dict:
    """One causal bf16 prefill layer of (1, Hq, S, D) in the model's layout
    (``flash_inputs(model_layout=True)``): the kernel's output held to its
    plain version's by ``flash_agree``, then the kernel, the previous design
    (the SIMT kernel's bf16 instantiation), the plain version and SDPA
    (flash backend, GQA, causal; a yardstick of speed only, never on the
    port's path) timed between CUDA events on the same inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import plain_attention
    q, k, v = flash_inputs(1, Hq, Hkv, S, S, D, "bfloat16", seed=7,
                           device="cuda", model_layout=True)
    agree = flash_agree(flash_attention(q, k, v), plain_attention(q, k, v),
                        "bfloat16", (q, k, v))
    if not agree["ok"]:
        raise AssertionError(f"flash_attention disagrees at the prefill "
                             f"shape: {agree}")
    ms = cuda_time_ms(lambda: flash_attention(q, k, v), reps=10, warmup=2)
    previous_ms = (cuda_time_ms(lambda: previous_attention(q, k, v), reps=2,
                                warmup=1) if previous else None)
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
            "previous_ms": previous_ms, "speedup_over_previous":
            previous_ms and previous_ms / ms, "plain_ms": plain_ms,
            "ms_source": "cuda_events", "tflop_per_s": ops / ms / 1e9,
            "previous_tflop_per_s": previous_ms and ops / previous_ms / 1e9,
            "library_tflop_per_s": ops / lib_ms / 1e9,
            **bound(nbytes, ops, BF16_OPS_PER_S), "library_ms": lib_ms,
            "library": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True), flash backend"}


# ---------------------------------------------------------------------------
# spmm and embedding_bag inputs: the reference test's cases and the edges
# ---------------------------------------------------------------------------

#: every element within SUM_REL of the absolute sum of its terms (sum_p
#: |w(p) R[g(p), :]|, or of the bag's) plus SUM_ABS: the kernel and the plain
#: version add in other orders; a bf16 output also within one bf16 rounding
#: of the plain one (BF16_REL |plain|: both round the same float32 result
#: once, so they differ by at most one unit in the last of bf16's 8
#: significant bits)
SUM_REL, SUM_ABS, BF16_REL = 1e-5, 1e-6, 2.0 ** -7
SUM_TOL = (f"|kernel - plain| <= {SUM_REL} * sum |w R| + {SUM_ABS} per "
           f"element (+ {BF16_REL} |plain| for a bf16 output)")
#: (V, E, D, options) checked on the card, each weighted and unweighted, on
#: both routes: the reference test's six cases, no edges, nodes with no
#: in-edge, negative and out-of-range src, int64 indices, bf16 rows, hubs
#: above the split length (one of exactly 1,025 edges, one at a D of two
#: column passes), a wide D; the bound route's load widths (D = 4 and 64 in
#: 16 bytes, 70 in 8, 63 and 65 one element, bf16 at 64) and a view whose
#: base is one element off the 16 bytes; the GNN models' message widths
#: (EGNN's degree and readout sums at D = 1, its coordinates at 3,
#: NequIP's vector and matrix messages at 3C = 96 and 9C = 288, with hubs,
#: and D = 1 and 3 with no edges)
SPMM_CHECK = (
    (50, 300, 16, {}), (300, 2000, 70, {}), (1000, 5000, 128, {}),
    (257, 1, 5, {}), (128, 128, 128, {}), (5, 40, 200, {}),
    (10, 0, 16, {}), (1000, 300, 32, {"isolated": True}),
    (50, 300, 16, {"bad_src": True}), (300, 2000, 70, {"idx": "int64"}),
    (300, 2000, 70, {"dtype": "bfloat16"}),
    (1000, 5000, 128, {"dtype": "bfloat16", "idx": "int64"}),
    (100, 6000, 64, {"hub": 5000}), (200, 3000, 70, {"hub": 1025}),
    (64, 3000, 300, {"hub": 2100, "idx": "int64", "bad_src": True}),
    (40, 600, 520, {}), (300, 4000, 63, {}), (300, 4000, 65, {}),
    (300, 4000, 4, {"hub": 1500}), (300, 4000, 64, {"offset": 1}),
    (300, 4000, 64, {"dtype": "bfloat16", "hub": 1500}),
    (300, 4000, 1, {}), (300, 4000, 1, {"hub": 2500}),
    (300, 4000, 3, {"hub": 1500}), (300, 4000, 96, {}),
    (300, 4000, 288, {"hub": 1100}), (10, 0, 1, {}), (10, 0, 3, {}))
#: (V, D, B, L, mode, options): the reference test's four cases, no
#: weights, a bag whose weights are all 0 (mean), negative and
#: out-of-range indices, int64 indices, a bf16 table, an empty bag, then
#: the kernel's load widths, bag lengths and warps per bag
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
    (100, 16, 4, 0, "mean", {}),
    # each load width of kernel.plan: D = 1, 3 (4 bytes), 18 (8), 32 and
    # 64 (16), 65 (4, three column passes), bf16 at 18 (4) and 64 (16), a
    # view one element off the 16 bytes (4), bf16 at an odd D (2); L = 0,
    # 1, 100 and 257; B = 1 (8 warps a bag), 512 (8) and 65,536 (1)
    (1000, 1, 512, 100, "sum", {}), (1000, 3, 512, 100, "mean", {}),
    (1000, 18, 512, 100, "sum", {}), (1000, 32, 512, 100, "mean", {}),
    (1000, 64, 512, 100, "sum", {}), (1000, 65, 512, 100, "mean", {}),
    (1000, 18, 512, 100, "sum", {"dtype": "bfloat16"}),
    (1000, 64, 512, 100, "mean", {"dtype": "bfloat16"}),
    (1000, 65, 512, 100, "sum", {"dtype": "bfloat16"}),
    (1000, 64, 512, 100, "sum", {"offset": 1}),
    (1000, 18, 512, 100, "mean", {"offset": 1, "dtype": "bfloat16"}),
    (1000, 18, 512, 0, "sum", {}), (1000, 18, 512, 1, "mean", {}),
    (1000, 18, 1, 257, "sum", {}), (1000, 64, 1, 257, "mean",
                                    {"dtype": "bfloat16", "idx": "int64"}),
    (100_000, 18, 65_536, 100, "sum", {}),
    (100_000, 18, 65_536, 100, "mean", {"idx": "int64", "bad_idx": True}))


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
                isolated=False, bad_src=False, offset=0):
    """x ~ N(0, 1), w ~ N(0, 1), src and dst uniform (the reference test's
    draws), on the card; ``hub`` edges all into node V // 2, ``isolated``
    leaves three quarters of the nodes without an in-edge, ``bad_src``
    makes every 7th src negative and every 7th out of range, ``offset``
    makes x a view that starts that many elements into a buffer."""
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
    x = rng.standard_normal(V * D + offset).astype(np.float32)
    x = torch.from_numpy(x).to("cuda", getattr(torch, dtype))[offset:]
    return (x.view(V, D),
            torch.from_numpy(src).to("cuda", getattr(torch, idx)),
            torch.from_numpy(w).cuda(), torch.from_numpy(dst).cuda(),
            prepare_tiles(dst, V).to("cuda"))


def spmm_route(fn, route: str, what: str):
    """``fn()`` (one ``spmm`` launch) with the counters reset just before:
    it must have taken ``route``.  Returns its output."""
    from repro_torch.kernels import spmm
    spmm.launches.reset()
    out = fn()
    by = dict(spmm.launches.by_route)
    if by != {**dict.fromkeys(by, 0), route: 1}:
        raise AssertionError(f"{what}: launches by route {by}, expected "
                             f"one on {route}")
    return out


def segment_sum_bound(messages, prep):
    """``segment_sum_tiles``' sum through the bound route's kernel, with
    ``perm`` as the row ids: a comparison, never on the port's path (the
    op takes the previous route), so its launch is not counted."""
    import torch
    from repro_torch.kernels.spmm import kernel
    out = torch.empty((prep.num_nodes, messages.shape[1]),
                      dtype=messages.dtype, device=messages.device)
    kernel.launch_bound(messages, prep.perm, None, prep, blocks=prep.blocks,
                        out=out)
    return out


def check_spmm(cases) -> dict:
    """``spmm`` (weighted and not, on both routes: the edges bound with
    ``with_edges`` and gathered through ``perm``) and ``segment_sum_tiles``
    (and its sum through the bound route's kernel) against ``spmm_ref`` /
    ``segment_sum_ref`` on the card, each element by ``sum_agree``; hub
    cases also with the split off; the bound route's two launches
    bit-equal."""
    import torch
    from repro_torch.kernels import wrap_clamp_index
    from repro_torch.kernels.spmm import (kernel, segment_sum_ref,
                                          segment_sum_tiles, spmm, spmm_ref)
    out, max_err = [], 0.0
    for i, (V, E, D, opt) in enumerate(cases):
        x, src, w, dst, prep = spmm_inputs(V, E, D, seed=i, **opt)
        case = {"V": V, "E": E, "D": D, **opt,
                "plan": vars(kernel.plan_for(x))}
        preps = {"split": prep}
        if prep.n_chunks:
            preps["no_split"] = prep.with_split(None)
        for name, pr in preps.items():
            for wt in (w, None):
                bound = pr.with_edges(src, wt, num_rows=V)
                want = spmm_ref(x, src, dst, wt, V)
                scale = spmm_ref(x.float().abs(), src, dst,
                                 None if wt is None else wt.abs(), V)
                for route, p in (("perm", pr), ("bound", bound)):
                    got = spmm_route(lambda: spmm(x, src, wt, p), route,
                                     f"spmm {case}")
                    line = {"op": "spmm", **case, "route": route,
                            "weighted": wt is not None, "prep": name,
                            "hub_chunks": pr.n_chunks,
                            **sum_agree(got, want, scale)}
                    if route == "bound":
                        line["bit_equal"] = bool(torch.equal(
                            got, spmm(x, src, wt, p)))
                        line["ok"] = line["ok"] and line["bit_equal"]
                    out.append(line)
            msg = x[wrap_clamp_index(src, V)] * w[:, None].to(x.dtype)
            want = segment_sum_ref(msg, dst, V)
            scale = segment_sum_ref(msg.float().abs(), dst, V)
            for route, got in (
                    ("perm", spmm_route(lambda: segment_sum_tiles(msg, pr),
                                        "perm", f"segment_sum_tiles {case}")),
                    ("bound", segment_sum_bound(msg, pr))):
                out.append({"op": "segment_sum_tiles", **case,
                            "route": route, "prep": name,
                            **sum_agree(got, want, scale)})
    for line in out:
        max_err = max(max_err, line["max_abs_err"])
        if not line["ok"]:
            raise AssertionError(f"spmm disagrees: {line}")
    ratios = {dt: [c["max_err_over_bound"] for c in out
                   if c.get("dtype", "float32") == dt]
              for dt in ("float32", "bfloat16")}
    return {"tolerance": SUM_TOL, "cases": len(out),
            "bound_cases_bit_equal": sum("bit_equal" in c for c in out),
            "max_err_over_bound": {dt: max(r) for dt, r in ratios.items()},
            "max_abs_err": max_err}


def check_embedding_bag(cases) -> dict:
    """``embedding_bag`` through the CUDA kernel against
    ``embedding_bag_ref`` on the card, each element by ``sum_agree``
    (the bag's absolute sum divided, for ``mean``, as the output is); two
    launches bit-equal; each case's load plan."""
    import torch
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref, kernel)
    out, max_err = [], 0.0
    for i, (V, D, B, L, mode, opt) in enumerate(cases):
        rng = np.random.default_rng(i)
        off = opt.get("offset", 0)
        t = rng.standard_normal(V * D + off).astype(np.float32)
        idx = rng.integers(0, V, (B, L))
        w = rng.random((B, L)).astype(np.float32)
        if opt.get("bad_idx"):
            idx[:, ::3] = -rng.integers(1, 2 * V + 1, idx[:, ::3].shape)
            idx[:, 1::3] = V + rng.integers(0, 2 * V, idx[:, 1::3].shape)
        if opt.get("zero_bag"):
            w[1] = 0.0
        t = torch.from_numpy(t).to(
            "cuda", getattr(torch, opt.get("dtype", "float32")))[off:]
        t = t.view(V, D)
        idx = torch.from_numpy(idx).to("cuda",
                                       getattr(torch, opt.get("idx", "int32")))
        w = None if opt.get("unweighted") else torch.from_numpy(w).cuda()
        got = embedding_bag(t, idx, w, mode=mode)
        again = embedding_bag(t, idx, w, mode=mode)
        want = embedding_bag_ref(t, idx, w, mode=mode)
        scale = embedding_bag_ref(t.float().abs(), idx,
                                  None if w is None else w.abs(), mode=mode)
        torch.cuda.synchronize()
        p = kernel.plan(D, t.element_size(), t.data_ptr())
        out.append({"V": V, "D": D, "B": B, "L": L, "mode": mode, **opt,
                    "vec_bytes": p.vec_bytes, "lanes": p.lanes,
                    "bit_equal": bool(torch.equal(got, again)),
                    **sum_agree(got, want, scale)})
        max_err = max(max_err, out[-1]["max_abs_err"])
        if not (out[-1]["ok"] and out[-1]["bit_equal"]):
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
#: the CUDA functions of ``flash_attention.cu`` (tensor-core and SIMT), as
#: the profiler names them
FLASH_KERNEL_NAMES = ("flash_tc_kernel", "flash_attention_kernel")


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
                   if any(f in name for f in FLASH_KERNEL_NAMES))
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


def lm_serve(requests: int = 4, max_new: int = 16, prompt_len: int = 16,
             arch: str = LM_ARCH) -> dict:
    """``main(--arch ARCH --full --requests 4 --max-new 16)`` (starcoder2-3b
    by default): decode takes the plain GQA attention, as the reference's
    does, so no kernel launches."""
    report, counts, wall = counted(lambda: run_lm_serve(
        ["--arch", arch, "--full", "--requests", str(requests),
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
                                                  prompt_len + max_new,
                                                  arch)}


def decode_profile(requests: int, max_len: int, arch: str = LM_ARCH,
                   params=None) -> dict:
    """One full-width decode step of ``arch`` (position ``max_len // 2`` of
    a cache of ``max_len``) timed between CUDA events, and its kernels
    profiled; on ``params``, or on weights drawn from seed 0."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_lm_decode_step
    from repro_torch.models.transformer import init_cache
    cfg = get_arch(arch).make_config()
    if params is None:
        params = lm_params(cfg, seed=0)
    cache = init_cache(cfg, requests, max_len, device="cuda")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (requests, 1))
    batch = {"cache": cache, "pos": max_len // 2,
             "tokens": torch.from_numpy(tokens).cuda()}
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


@contextlib.contextmanager
def model_attention(fn):
    """The LM's prefill attention swapped for ``fn`` inside the block."""
    import repro_torch.models.transformer as T
    saved = T.flash_attention
    T.flash_attention = fn
    try:
        yield
    finally:
        T.flash_attention = saved


def lm_bf16_vs_plain(long: int = 2048) -> dict:
    """starcoder2-3b at full width and depth in bf16 on (1, ``long``): the
    last logits through the kernel and through the previous design, each
    against the plain attention's (max |a - b| over max |b|, the argmax).
    Recorded, not gated: bf16 P moves the logits by design, and the gate
    is the op-level bound (``flash_agree``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import plain_attention
    from repro_torch.launch.steps import make_lm_prefill_step
    cfg = get_arch(LM_ARCH).make_config()
    params = lm_params(cfg, seed=3)
    step = make_lm_prefill_step(cfg)
    tokens = lm_tokens(cfg, long, seed=3)
    kernel, counts, _ = counted(lambda: step(params, {"tokens": tokens}))
    expect_launches(counts, {"flash_attention": cfg.n_layers},
                    "30-layer bf16 prefill")
    runs = {}
    for name, fn in (("plain", plain_attention),
                     ("previous", previous_attention)):
        with model_attention(fn):
            runs[name], counts, _ = counted(
                lambda: step(params, {"tokens": tokens}))
        expect_launches(counts, {}, f"30-layer bf16 prefill, {name}")
    del params
    torch.cuda.empty_cache()
    line = {"dtype": "bfloat16", "layers": cfg.n_layers, "shape": [1, long],
            "gated": False}
    for name, logits in (("kernel_vs_plain", kernel),
                         ("previous_vs_plain", runs["previous"])):
        agree = logits_agree(logits, runs["plain"])
        del agree["ok"]
        line[name] = agree
    return line


def lm_card_vs_cpu(short: int = 512, long: int = 2048,
                   previous: bool = False) -> dict:
    """starcoder2-3b's widths in float32 (TF32 off): 2 layers on (1,
    ``short``) on the card and on the CPU; all 30 layers on (1, ``long``)
    on the card through the kernel and through the plain attention.  Then,
    with ``previous`` (``--previous-designs``), recorded beside them, the
    bf16 model's logits (``lm_bf16_vs_plain``)."""
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
    with model_attention(plain_attention):
        plain, counts, _ = counted(lambda: step(params, {"tokens": tokens}))
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
    return {**line, "bf16": lm_bf16_vs_plain(long) if previous else None}


# ---------------------------------------------------------------------------
# the MoE LMs (olmoe-1b-7b, qwen2-moe-a2.7b): prefill, serving, card vs CPU
# ---------------------------------------------------------------------------

MOE_ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
#: decode_32k's batch (configs/base.py LM_SHAPES) on a short cache
MOE_DECODE_BATCH, MOE_DECODE_CACHE = 128, 64
#: card against CPU (float32): (1, 512) takes the grouped route at G = 32,
#: (1, 500) the global one
MOE_CHECK_SEQS = (512, 500)
#: a routing flip is allowed only where the CPU's k-th and (k+1)-th
#: probabilities are this close; the aux loss's tolerance
MOE_TIE, MOE_AUX_TOL = 1e-6, 1e-5


@contextlib.contextmanager
def moe_wrapped(wrap, name: str = "_moe_apply"):
    """The model's function ``name`` replaced by ``wrap(inner)`` inside the
    block."""
    import repro_torch.models.transformer as T
    inner = getattr(T, name)
    setattr(T, name, wrap(inner))
    try:
        yield
    finally:
        setattr(T, name, inner)


def routed_as(experts):
    """A wrapper for ``moe_route`` (``moe_wrapped(.., "moe_route")``) that
    keeps the router's probabilities but takes ``experts`` (N, k, another
    device's choice) as the top k, their probabilities renormalised as the
    router renormalises its own."""
    import torch

    def wrap(inner):
        def route(cfg, p, x):
            probs, _, _ = inner(cfg, p, x)
            top_e = experts.to(x.device).reshape(*x.shape[:-1], -1)
            top_p = probs.gather(-1, top_e)
            return probs, top_p / torch.clamp(
                top_p.sum(-1, keepdim=True), min=1e-9), top_e
        return route
    return wrap


#: the MoE prefill's kernel classes, matched in this order on the lower-
#: cased kernel name before its template arguments (the first match wins;
#: ``searchsorted`` before ``sort``, whose name it holds); a class by name
#: reads no profiler attribution of kernels to the operations that
#: launched them.  ``other``: every other kernel (elementwise passes,
#: reductions, softmax, norms, copies)
MOE_KERNEL_CLASSES = (
    ("flash_attention", tuple(n.lower() for n in FLASH_KERNEL_NAMES)),
    ("gemm", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "splitkreduce")),
    ("searchsorted", ("searchsorted",)),
    ("sort", ("sort",)),
    ("gather", ("index_elementwise", "indexselect", "index_put", "gather",
                "scatter")),
)


def kernel_classes(by_name: dict) -> dict:
    """Device ms of ``profile_kernels``'s ``{name: [us, count]}`` summed
    by ``MOE_KERNEL_CLASSES``, the rest as ``other``."""
    out = dict.fromkeys([c for c, _ in MOE_KERNEL_CLASSES] + ["other"], 0.0)
    for name, (us, _) in by_name.items():
        head = name.split("<", 1)[0].lower()
        cls = next((c for c, keys in MOE_KERNEL_CLASSES
                    if any(k in head for k in keys)), "other")
        out[cls] += us / 1e3
    return out


def moe_split(fn, call_ms: float) -> tuple[dict, object]:
    """One profiled call of ``fn`` (a prefill step; the card's activity
    only, ``profile_kernels``): the device time of its kernels, their busy
    share of ``call_ms``, the top kernels and the device ms by
    ``kernel_classes``; and the first MoE layer's input, recorded in that
    call (for ``moe_layer_split``)."""
    xs = []

    def first_input(inner):
        def apply(c, p, x):
            if not xs:
                xs.append(x)
            return inner(c, p, x)
        return apply

    with moe_wrapped(first_input):
        by_name, wall_us = profile_kernels(fn)
    busy = sum(us for us, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    if not busy:
        return {"device_ms": "not measured"}, xs[0]
    return {"device_ms": busy / 1e3, "device_busy_share": busy / 1e3 / call_ms,
            "profiled_wall_ms": wall_us / 1e3,
            "kernels": sum(n for _, n in by_name.values()),
            "by_class_ms": kernel_classes(by_name),
            "top_kernels_ms": {k[:80]: us / 1e3 for k, (us, _) in ranked}}, \
        xs[0]


def moe_layer_split(cfg, params, x) -> dict:
    """The first MoE layer alone (``_moe_apply``) on its prefill input ``x``
    (N, d): ms a call between CUDA events; one profiled call's device ms by
    ``kernel_classes`` (``gemm``: the router, the experts and the shared
    experts); the expert GEMMs alone, the up (and gate) and down
    ``torch.bmm`` on buffers of the layer's (E, G C, d) and (E, G C, f)
    shapes between CUDA events; ``dispatch_ms`` the layer's device ms
    outside the GEMM class: the sorts, ``searchsorted``, gathers and
    elementwise passes (softmax, masks, the experts' and shared experts'
    activation, the combine's multiply and sum)."""
    import torch
    import repro_torch.models.transformer as T
    m, (N, d) = cfg.moe, x.shape
    lp = T.layer_params(params, 0)
    G = T._moe_groups(m, N)
    rows = G * T.moe_capacity(m, N // G)
    with torch.no_grad():
        layer_ms = cuda_time_ms(lambda: T._moe_apply(cfg, lp, x), reps=5,
                                warmup=1)
        by_name, _ = profile_kernels(lambda: T._moe_apply(cfg, lp, x))
        g = torch.Generator(device=x.device).manual_seed(0)
        buf = torch.randn((m.num_experts, rows, d), generator=g,
                          device=x.device).to(x.dtype)
        h = torch.randn((m.num_experts, rows, m.d_ff_expert), generator=g,
                        device=x.device).to(x.dtype)
        ex = lp["experts"]
        expert_ms = sum(cuda_time_ms(lambda a=a, w=w: torch.bmm(a, w),
                                     reps=5, warmup=1)
                        for a, w in [(buf, ex["up"]), (h, ex["down"])]
                        + ([(buf, ex["gate"])] if cfg.gated_mlp else []))
        del buf, h
    classes = kernel_classes(by_name)
    device_ms = sum(classes.values())
    return {"tokens": N, "dispatch_groups": G, "buffer_rows": rows,
            "ms": layer_ms, "device_ms": device_ms, "by_class_ms": classes,
            "expert_gemm_ms": expert_ms,
            "dispatch_ms": device_ms - classes["gemm"],
            "kernels": sum(n for _, n in by_name.values())}


def prefill_logits(step, params, tokens, n_layers: int) -> tuple:
    """One prefill call ending in a synchronize, every counter reset just
    before and read just after (exactly one ``flash_attention`` launch per
    layer): (its logits, finite and of shape (B, vocab), its wall s)."""
    import torch
    logits, counts, wall = counted(lambda: (
        step(params, {"tokens": tokens}), torch.cuda.synchronize())[0])
    expect_launches(counts, {"flash_attention": n_layers},
                    f"MoE prefill of {tuple(tokens.shape)} (one "
                    f"flash_attention per layer)")
    if (logits.shape != (tokens.shape[0], params["embed"]["table"].shape[0])
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError("MoE prefill logits not finite or misshapen")
    return logits, wall


def moe_prefill(arch: str, seq: int = PREFILL_SEQ) -> dict:
    """``make_lm_prefill_step`` on ``arch`` at full width and depth (bf16,
    random weights drawn on the card): one warm-up and two timed calls on
    (1, ``seq``), bit-equal logits, exactly one ``flash_attention`` launch
    per layer and call, the peak memory, one profiled call split by
    ``moe_split`` and its first MoE layer alone by ``moe_layer_split``;
    for olmoe also one ``decode_step`` at decode_32k's
    batch of 128 (the grouped route, 4 tokens a group) on a 64-position
    cache.  The weights are freed before it returns."""
    import torch
    import repro_torch.models.transformer as T
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_lm_prefill_step
    cfg = get_arch(arch).make_config()
    t0 = time.perf_counter()
    params = lm_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = make_lm_prefill_step(cfg)
    tokens = lm_tokens(cfg, seq, seed=0)
    _, warm = prefill_logits(step, params, tokens, cfg.n_layers)
    torch.cuda.reset_peak_memory_stats()
    first, wall_a = prefill_logits(step, params, tokens, cfg.n_layers)
    second, wall_b = prefill_logits(step, params, tokens, cfg.n_layers)
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(first, second):
        raise AssertionError(f"{arch}: two prefill calls' logits differ")
    launches = 3 * cfg.n_layers
    call_ms = (wall_a + wall_b) / 2 * 1e3
    split, x = moe_split(lambda: step(params, {"tokens": tokens}), call_ms)
    split["moe_layer"] = moe_layer_split(cfg, params, x)
    del x
    m = cfg.moe
    G = T._moe_groups(m, seq)
    line = {"config": f"configs/{arch.replace('-', '_').replace('.', '_')}"
                      f".py::full ({cfg.n_layers} layers, d_model "
                      f"{cfg.d_model}, {m.num_experts} experts top-"
                      f"{m.top_k}, {m.num_shared} shared, bf16, random "
                      f"weights, seed 0)",
            "parameters": cfg.num_params(), "init_s": init_s,
            "shape": [1, seq], "dispatch_groups": G,
            "capacity": T.moe_capacity(m, seq // G),
            "cut": "batch 1 of prefill_32k's 32 (one card)",
            "warmup_wall_s": warm, "call_wall_s": [wall_a, wall_b],
            "ms_per_call": call_ms, "tokens_per_s": seq / call_ms * 1e3,
            "peak_device_bytes": peak, "bit_equal_calls": True,
            "flash_attention_launches": launches,
            "flash_attention_launches_per_call": cfg.n_layers,
            "profile": split}
    del first, second
    if arch == "olmoe-1b-7b":
        G = T._moe_groups(m, MOE_DECODE_BATCH)
        line["decode_step_128"] = {
            "batch": MOE_DECODE_BATCH, "cache": MOE_DECODE_CACHE,
            "dispatch_groups": G,
            "capacity": T.moe_capacity(m, MOE_DECODE_BATCH // G),
            **decode_profile(MOE_DECODE_BATCH, MOE_DECODE_CACHE, arch,
                             params)}
    del params
    torch.cuda.empty_cache()
    return line


def moe_serve_cli(arch: str, requests: int = 4, max_new: int = 16) -> dict:
    """The serving CLI's decode of ``arch`` (``lm_serve``): the global
    route at C = 1 for 4 requests, no kernel launch."""
    import repro_torch.models.transformer as T
    from repro_torch.configs import get_arch
    m = get_arch(arch).make_config().moe
    G = T._moe_groups(m, requests)
    return {"dispatch_groups": G,
            "capacity": T.moe_capacity(m, requests // G),
            **lm_serve(requests, max_new, arch=arch)}


def moe_layer_agree(cfg, lp_card, lp_cpu, x) -> dict:
    """One MoE layer's ``_moe_apply`` on the card and on the CPU on the
    same float32 input ``x`` (N, d).  The chosen experts: a flip allowed
    only where the CPU's k-th and (k+1)-th probabilities are within
    ``MOE_TIE``, each reported with its gap.  Then the card dispatches the
    CPU's experts (``routed_as``; its own probabilities), so that every
    dispatch group's outputs are compared whatever flipped: within 1e-3
    of the group's largest magnitude, the aux within ``MOE_AUX_TOL``."""
    import torch
    import repro_torch.models.transformer as T
    m, (N, _) = cfg.moe, x.shape
    probs, _, e_cpu = T.moe_route(cfg, lp_cpu, x)
    _, _, e_card = T.moe_route(cfg, lp_card, x.cuda())
    same = (e_cpu.sort(-1).values == e_card.cpu().sort(-1).values).all(-1)
    top = probs.sort(-1, descending=True).values
    gaps = (top[:, m.top_k - 1] - top[:, m.top_k]).double()
    flips = [{"token": int(t), "gap": float(gaps[t])}
             for t in torch.nonzero(~same).flatten()]
    if any(f["gap"] > MOE_TIE for f in flips):
        raise AssertionError(f"routing flips away from a near-tie: {flips}")
    out_cpu, aux_cpu = T._moe_apply(cfg, lp_cpu, x)
    with moe_wrapped(routed_as(e_cpu), "moe_route"):
        out_card, aux_card = T._moe_apply(cfg, lp_card, x.cuda())
    G = T._moe_groups(m, N)
    a = out_card.cpu().double().view(G, N // G, -1)
    b = out_cpu.double().view(G, N // G, -1)
    worst = float(((a - b).abs().amax((1, 2))
                   / b.abs().amax((1, 2)).clamp(min=1e-30)).max())
    aux_err = abs(float(aux_card) - float(aux_cpu))
    line = {"tokens": N, "dispatch_groups": G,
            "capacity": T.moe_capacity(m, N // G), "flips": flips,
            "card_routed_as": "the CPU's experts", "groups_checked": G,
            "min_gap": float(gaps.min()),
            "max_err_share": worst, "aux_abs_err": aux_err}
    if worst > LM_TRAIN_TOL or aux_err > MOE_AUX_TOL:
        raise AssertionError(f"MoE layer card vs cpu: {line}")
    return line


def moe_card_vs_cpu(arch: str) -> dict:
    """``arch`` at full width with 2 layers in float32 (TF32 off), the
    weights drawn on the card and copied to the CPU, on (1, 512) (grouped)
    and (1, 500) (global) tokens: each layer's ``_moe_apply`` on the same
    input on both devices (the CPU's, recorded in its forward) through
    ``moe_layer_agree``; the whole model's last logits within 1e-3 of their
    largest magnitude with the same argmax (``logits_agree``)."""
    import dataclasses
    import torch
    import repro_torch.models.transformer as T
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import make_lm_prefill_step
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    cfg = dataclasses.replace(get_arch(arch).make_config(), dtype="float32",
                              n_layers=2)
    card = lm_params(cfg, seed=4)
    cpu = T.params_to(card, "cpu")
    step = make_lm_prefill_step(cfg)
    runs = []
    for seq in MOE_CHECK_SEQS:
        tokens = lm_tokens(cfg, seq, seed=seq, device="cpu")
        xs = []

        def recorder(inner):
            def apply(c, p, x):
                xs.append(x.clone())
                return inner(c, p, x)
            return apply

        t0 = time.perf_counter()
        with moe_wrapped(recorder):
            on_cpu = step(cpu, {"tokens": tokens})
        cpu_s = time.perf_counter() - t0
        on_card, counts, _ = counted(lambda: step(card,
                                                  {"tokens": tokens.cuda()}))
        expect_launches(counts, {"flash_attention": cfg.n_layers},
                        f"2-layer float32 {arch} prefill")
        whole = logits_agree(on_card, on_cpu)
        if not whole["ok"]:
            raise AssertionError(f"{arch} card vs cpu logits: {whole}")
        with torch.no_grad():
            layers = [moe_layer_agree(cfg, T.layer_params(card, i),
                                      T.layer_params(cpu, i), x)
                      for i, x in enumerate(xs)]
        runs.append({"shape": [1, seq], "cpu_s": cpu_s, "layers": layers,
                     "last_logits": whole})
    del card, cpu
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": 2, "dtype": "float32",
            "tolerance": "outputs 1e-3 of each group's largest magnitude "
                         f"where no flip; flips only at gaps <= {MOE_TIE}; "
                         f"aux {MOE_AUX_TOL}; last logits 1e-3 of their "
                         "largest, same argmax", "runs": runs}


def moe_train_card_vs_cpu(seq: int = 512) -> dict:
    """One AdamW step of ``make_lm_train_step`` on olmoe-1b-7b at full
    width with 2 layers in float32 (``remat="full"``) on (1, ``seq``), from
    the same state on the card and on the CPU: the loss and every gradient
    (the first moments, (1 - b1) times the clipped gradient) within 1e-3
    of their leaf's largest magnitude (``grads_agree``); exactly 2
    ``flash_attention`` forwards (the forward and the recomputation) and 1
    backward per layer."""
    import dataclasses
    import torch
    import repro_torch.models.transformer as T
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps as S
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves
    cfg = dataclasses.replace(get_arch("olmoe-1b-7b").make_config(),
                              dtype="float32", n_layers=2)
    params = lm_params(cfg, seed=6)
    state = {"params": params, "opt": adamw_init(params)}
    cpu_state = T.params_to(state, "cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (1, seq + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    step = S.make_lm_train_step(cfg)
    t0 = time.perf_counter()
    _, m_cpu = step(cpu_state, batch)
    cpu_s = time.perf_counter() - t0
    (_, m_card), counts, wall = counted(lambda: step(
        state, {k: v.cuda() for k, v in batch.items()}))
    expect_launches(counts, {"flash_attention": 2 * cfg.n_layers,
                             "flash_attention_backward": cfg.n_layers},
                    "2-layer float32 olmoe train step")
    agree = grads_agree((m_card["loss"], tree_leaves(state["opt"]["m"])),
                        (m_cpu["loss"], tree_leaves(cpu_state["opt"]["m"])),
                        LM_TRAIN_TOL)
    line = {"arch": "olmoe-1b-7b", "layers": 2, "dtype": "float32",
            "shape": [1, seq], "cpu_s": cpu_s, "card_s": wall,
            "loss": float(m_cpu["loss"]),
            "grad_norm": [float(m_card["grad_norm"]),
                          float(m_cpu["grad_norm"])],
            "launches": {k: v for k, v in counts.items() if v}, **agree}
    del state, cpu_state
    torch.cuda.empty_cache()
    return line


def moe_serve() -> dict:
    """The ``moe_serve`` phase: ``flash_attention`` held to its plain
    version and timed at the MoE models' prefill layer ((1, 16/16, 32,768,
    128) causal bf16, v strided as in the model: ``time_flash_attention``),
    each MoE LM's prefill and serving CLI at full size (one model on the
    card at a time), then the float32 card-vs-CPU checks and olmoe's train
    step."""
    import torch
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    heads = sorted({(c.n_heads, c.n_kv_heads, c.head_dim) for c in (
        get_arch(a).make_config() for a in MOE_ARCHS)})
    line = {"flash_attention_prefill_layer": [
        time_flash_attention(PREFILL_SEQ, Hq=Hq, Hkv=Hkv, D=D)
        for Hq, Hkv, D in heads], "flash_seconds": time.perf_counter() - t0}
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        line[arch] = {"prefill": moe_prefill(arch),
                      "serve": moe_serve_cli(arch)}
        line[arch]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    line["card_vs_cpu"] = [moe_card_vs_cpu(arch) for arch in MOE_ARCHS]
    line["train_card_vs_cpu"] = moe_train_card_vs_cpu()
    line["check_seconds"] = time.perf_counter() - t0
    line["flash_attention_launches"] = sum(
        line[a]["prefill"]["flash_attention_launches"] for a in MOE_ARCHS)
    torch.cuda.empty_cache()
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
            "embedding_bag": embedding_bag.launches,
            "flash_attention_backward": flash_attention.backward_launches,
            "augru_backward": augru.backward_launches,
            "spmm_backward": spmm.backward_launches}


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
    by_entry = expect_bits_entry(chunks, "2PS-L main path", "edge_score")
    timings = report["timings_s"]
    return {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": E, "vertices": report["vertices"], "k": k,
            "chunk_size": chunk, "graph_gen_s": gen_s, "wall_s": wall,
            "edges_per_s": E / wall, "timings_s": timings,
            "clustering_ms_per_chunk": timings["clustering"] / chunks * 1e3,
            "replication_factor": report["replication_factor"],
            "alpha_measured": report["alpha_measured"],
            "kernel_backend": report["kernel_backend"],
            "edge_score_launches": n_launch,
            "edge_score_launches_by_entry": by_entry,
            "scoring_chunks": chunks, **checks}


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
    by_entry = expect_bits_entry(chunks, "hosted 2PS-L", "edge_score")
    if not 1.0 <= report["cross_host_rf"] <= report["replication_factor"]:
        raise AssertionError("cross-host RF outside [1, RF]")
    return {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": E, "k": k, "hosts": 4, "dcn_penalty": 1.0,
            "wall_s": wall, "timings_s": report["timings_s"],
            "replication_factor": report["replication_factor"],
            "cross_host_rf": report["cross_host_rf"],
            "edge_score_launches": n_launch,
            "edge_score_launches_by_entry": by_entry,
            "scoring_chunks": chunks, **checks}


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
    by_entry = expect_bits_entry(chunks, "2PS-HDRF")
    return path_line(scale, E, k, report, wall, counts, checks,
                     hdrf_launches_by_entry=by_entry, scoring_chunks=chunks,
                     prepartition_ratio=report["prepartition_ratio"])


def expect_bits_entry(n: int, what: str, name: str = "hdrf_score") -> dict:
    """The ``name`` launches of the run just counted: all ``n`` through its
    bits entry, none through the flag entry."""
    by = dict(counters()[name].by_entry)
    if by != {"bits": n, "flags": 0}:
        raise AssertionError(f"{what}: {name} launches by entry {by}, "
                             f"expected {n} through the bits entry")
    return by


def hdrf_launches(E: int, chunk: int, sub: int = 64) -> int:
    """One launch per micro-batch that holds a valid row: the engine skips
    the all-padding micro-batches of the last chunk."""
    return sum(-(-min(chunk, E - lo) // sub) for lo in range(0, E, chunk))


def micro_batch_kernels(scale: int, k: int = 32, chunk: int = 4096) -> dict:
    """Device operations per 64-edge micro-batch of ``_hdrf_chunk`` on the
    card, as torch.profiler records them (kernels, copies and fills) over
    one chunk of the graph's first ``chunk`` edges, for HDRF flat and with
    4 hosts, through ``hdrf_choose_bits`` and through the previous
    composition (``previous_choose_bits``)."""
    import torch
    import repro_torch.core.partitioning as P
    from repro_torch.core import bitops
    from repro_torch.data import rmat_graph
    from repro_torch.kernels.hdrf_score import ops as hs_ops
    edges = rmat_graph(scale, edge_factor=16, seed=0)[:chunk]
    V = int(edges.max()) + 1
    pc = P.pad_chunk(edges, chunk, "cuda")
    out = {}
    for hosts in (0, 4):
        for name, fn in (("bits_entry", hs_ops.hdrf_choose_bits),
                         ("previous", previous_choose_bits)):
            def run():
                bits = torch.zeros((V, bitops.num_words(k)),
                                   dtype=torch.int32, device="cuda")
                sizes = torch.zeros(k, dtype=torch.int32, device="cuda")
                dpart = torch.zeros(V, dtype=torch.int32, device="cuda")
                return P._hdrf_chunk(bits, sizes, dpart, pc.edges, pc.valid,
                                     k=k, cap=chunk, lam=1.1, use_cap=False,
                                     n=chunk, num_hosts=hosts,
                                     dcn_penalty=1.0 if hosts else 0.0)
            original = hs_ops.hdrf_choose_bits
            hs_ops.hdrf_choose_bits = fn
            try:
                run()
                torch.cuda.synchronize()
                by_name, _ = profile_kernels(run)
            finally:
                hs_ops.hdrf_choose_bits = original
            n = sum(c for _, c in by_name.values())
            out[f"{name}_{'hosted' if hosts else 'flat'}"] = n / (chunk // 64)
    return {"edges": chunk, "micro_batches": chunk // 64,
            "device_ops_per_micro_batch": out}


def hdrf_baselines(scale: int, tmp: str, k: int = 32,
                   previous: bool = False) -> dict:
    """HDRF, Greedy and host-aware HDRF through the CLI, each (with
    ``previous``, ``--previous-designs``) then again with the previous
    composition of the choice (``previous_choose_bits`` in place of
    ``hdrf_choose_bits``: the gather, ``host_any`` and the previous
    kernel), byte-equal.  Each 64-edge micro-batch is a few dozen
    eager launches; at RMAT-16 that is 14,927 micro-batches per run (12-15
    s each), which is why this phase runs below the 2PS-HDRF path's
    scale, at RMAT-15 since the partitioned training phase."""
    from repro_torch.kernels.hdrf_score import ops as hs_ops
    path, E = write_graph(scale, tmp)
    chunk = 1 << 16                     # the CLI's --chunk-size default
    want = hdrf_launches(E, chunk)
    runs = {}
    for name, extra in (("hdrf", []), ("greedy", []),
                        ("hdrf_hosted", ["--hosts", "4",
                                         "--dcn-penalty", "1.0"])):
        algo = name.split("_")[0]
        argv = ["--input", path, "--k", str(k), "--algorithm", algo, *extra]
        (report, res), counts, wall = counted(lambda: run_cli(argv))
        checks = check_run(report, res, k, E)
        expect_launches(counts, {"edge_score": 0, "hdrf_score": want,
                                 "augru": 0},
                        f"{name} (one hdrf_score per non-empty 64-edge "
                        f"micro-batch)")
        by_entry = expect_bits_entry(want, name)
        runs[name] = path_line(scale, E, k, report, wall, counts, checks,
                               hdrf_launches_by_entry=by_entry,
                               micro_batches=want)
        if extra:
            runs[name]["cross_host_rf"] = report["cross_host_rf"]
        if not previous:
            continue
        original = hs_ops.hdrf_choose_bits
        hs_ops.hdrf_choose_bits = previous_choose_bits
        try:
            t0 = time.perf_counter()
            _, prev = run_cli(argv)
            runs[name]["previous_wall_s"] = time.perf_counter() - t0
        finally:
            hs_ops.hdrf_choose_bits = original
        if not np.array_equal(prev.assignment, res.assignment):
            raise AssertionError(f"{name}: the previous composition assigns "
                                 f"otherwise")
        runs[name]["wall_change"] = wall / runs[name]["previous_wall_s"] - 1
    return {"why_reduced": f"64-edge micro-batches of a few dozen eager "
                           f"launches each: {want} per run at "
                           f"RMAT-{scale}",
            **runs, "micro_batch_kernels": micro_batch_kernels(scale, k)}


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


#: HEP's small budget: 32,768 pinned rows at k = 32 (4 bytes a row), under
#: RMAT-19's 335,397 vertices, so the in-memory and the hash path both run
HEP_SMALL_BUDGET = 131_072


def hep_path(scale: int, tmp: str, k: int = 32) -> dict:
    """HEP through the CLI, at the spec's default budget (every vertex
    pinned) and at ``HEP_SMALL_BUDGET``: plain torch on the card, no kernel
    of the port launches."""
    path, E = write_graph(scale, tmp)
    runs = {}
    for name, extra in (("default_budget", []),
                        ("small_budget", ["--memory-budget-bytes",
                                          str(HEP_SMALL_BUDGET)])):
        (report, res), counts, wall = counted(lambda: run_cli(
            ["--input", path, "--k", str(k), "--algorithm", "hep", *extra]))
        checks = check_run(report, res, k, E)
        expect_launches(counts, {}, f"HEP ({name})")
        if report["hot_state_bytes"] > report["memory_budget_bytes"]:
            raise AssertionError(f"HEP ({name}): pinned rows over budget")
        runs[name] = path_line(
            scale, E, k, report, wall, counts, checks,
            memory_budget_bytes=report["memory_budget_bytes"],
            hot_vertices=report["hot_vertices"],
            hot_state_bytes=report["hot_state_bytes"],
            vertices=report["vertices"])
    small = runs["small_budget"]
    if small["hot_vertices"] >= small["vertices"]:
        raise AssertionError("HEP's small budget pins every vertex")
    return runs


def buffered_launches(E: int, window: int, sub: int) -> int:
    """One ``edge_score`` launch per scoring sub-batch that holds a valid
    row: ``ceil(n / sub)`` for each window of ``n`` edges."""
    return sum(-(-min(window, E - lo) // sub) for lo in range(0, E, window))


def buffered_path(scale: int, tmp: str, k: int = 32) -> dict:
    """Buffered re-streaming through the CLI at the spec's own geometry
    (16,384-edge chunks, 65,536-edge windows, 1,024-edge sub-batches): one
    ``edge_score_choose_bits`` launch per non-empty scoring sub-batch;
    then the device operations of one window (``buffered_window_ops``)."""
    from repro_torch.core import spec_for
    from repro_torch.core.buffered import SUB_BATCH_TARGET
    path, E = write_graph(scale, tmp)
    spec = spec_for("buffered")
    window = spec.chunk_size * spec.window_chunks
    subs = -(-window // SUB_BATCH_TARGET)
    sub = -(-window // subs)
    want = buffered_launches(E, window, sub)
    (report, res), counts, wall = counted(lambda: run_cli(
        ["--input", path, "--k", str(k), "--algorithm", "buffered",
         "--chunk-size", str(spec.chunk_size),
         "--buffer-edges", str(spec.buffer_edges)]))
    checks = check_run(report, res, k, E)
    expect_launches(counts, {"edge_score": want},
                    "buffered (one edge_score per non-empty sub-batch)")
    by_entry = expect_bits_entry(want, "buffered", "edge_score")
    if report["windows"] != -(-E // window):
        raise AssertionError(f"buffered: {report['windows']} windows")
    return path_line(scale, E, k, report, wall, counts, checks,
                     chunk_size=spec.chunk_size, buffer_edges=window,
                     windows=report["windows"], sub_batch=sub,
                     edge_score_launches=counts["edge_score"],
                     edge_score_launches_by_entry=by_entry,
                     window_ops=buffered_window_ops(path, k))


def buffered_window_ops(path: str, k: int = 32) -> dict:
    """Device operations of one 65,536-edge buffered window on the card
    (the window function: the bits rows and sizes read back, the tables
    uploaded, 64 pre-partitioning and 64 scoring sub-batches), as
    torch.profiler records them, on the graph's second window after the
    first, with the run's real state; the window's wall time unprofiled
    (``window_s``), and of it the host's ``window_clusters`` and
    ``map_window_clusters`` on the same edges."""
    import torch
    from repro_torch.core import (MemmapEdgeStream, build_partitioner,
                                  spec_for)
    from repro_torch.core import partitioning as P
    from repro_torch.core.buffered import (map_window_clusters,
                                           window_clusters)
    from repro_torch.core.engine import _Timer
    stream = MemmapEdgeStream(path)
    spec = spec_for("buffered")
    part = build_partitioner(spec, "cuda")
    st = part.init_state(stream, k, _Timer(), None)
    window = spec.chunk_size * spec.window_chunks
    it = stream.iter_chunks(window)
    pcs = [P.pad_chunk(next(it), window, "cuda") for _ in range(2)]
    st, _ = part._window_fn(st, pcs[0])
    torch.cuda.synchronize()
    by_name, wall_us = profile_kernels(lambda: part._window_fn(st, pcs[1]))
    ops = sum(c for _, c in by_name.values())
    scoring = sum(c for name, (_, c) in by_name.items()
                  if "edge_score" in name)
    t0 = time.perf_counter()
    part._window_fn(st, pcs[1])
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wc = window_clusters(pcs[1].host, k=k)
    cluster_s = time.perf_counter() - t0
    map_window_clusters(np.zeros((len(wc.vols), k), np.int64), wc.vols, k,
                        init_loads=np.zeros(k, np.int64), cap_slots=1 << 40)
    map_s = time.perf_counter() - t0 - cluster_s
    return {"window_edges": window, "sub_batches": part._subs,
            "device_ops_per_window": ops,
            "device_ops_per_sub_batch": ops / part._subs,
            "edge_score_kernels": scoring,
            "device_ms": sum(us for us, _ in by_name.values()) / 1e3,
            "profiled_wall_ms": wall_us / 1e3, "window_s": window_s,
            "window_clusters_s": cluster_s, "map_window_clusters_s": map_s,
            "window_vertices": len(wc.uniq), "window_clusters": len(wc.vols)}


# ---------------------------------------------------------------------------
# the persistence and robustness layer: the artifact, the crash drill and the
# torch.profiler hook
# ---------------------------------------------------------------------------

def trace_span_s(trace_path: str, names) -> dict:
    """Seconds of the complete spans named ``names`` in a Chrome trace the
    port's tracer wrote (``--trace``), summed by name, after checking the
    document with ``obs.validate_chrome_trace``."""
    from repro_torch import obs
    with open(trace_path) as f:
        doc = json.load(f)
    obs.validate_chrome_trace(doc)
    out = dict.fromkeys(names, 0.0)
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X" and ev["name"] in out:
            out[ev["name"]] += ev["dur"] / 1e6
    return out


def _plans_equal(a, b, what: str) -> int:
    """Every array field of two plans equal (dtype too), every scalar
    equal; returns the number of arrays compared."""
    import dataclasses
    n = 0
    for f in dataclasses.fields(a):
        if f.name == "base":
            continue
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            if va.dtype != vb.dtype or not np.array_equal(va, vb):
                raise AssertionError(f"{what}: {f.name} differs")
            n += 1
        elif va != vb:
            raise AssertionError(f"{what}: {f.name} {va} != {vb}")
    return n


def artifact_path(scale: int, tmp: str, k: int = 32, hosts: int = 4) -> dict:
    """Host-aware 2PS-L through the CLI with ``--artifact-dir --local-graphs
    --plan-json`` (and ``--trace``, which times the planning spans): one
    ``edge_score`` launch per scoring chunk; then the artifact loaded with
    verification, its halo and host plans held array for array to a fresh
    ``plan_halo_exchange_stream`` and ``host_plan_from_halo``, every local
    graph's ids to ``vmap_global[p]``, and one flipped byte of
    ``halo_plan.npz`` refused with ``ArtifactIntegrityError``."""
    from repro_torch.core import (MemmapEdgeStream, PartitionArtifact,
                                  spec_for)
    from repro_torch.dist import (host_plan_from_halo,
                                  plan_halo_exchange_stream)
    from repro_torch.robust import ArtifactIntegrityError
    path, E = write_graph(scale, tmp)
    art_dir = os.path.join(tmp, "artifact")
    plan_json = os.path.join(tmp, "plan.json")
    trace = os.path.join(tmp, "artifact_trace.json")
    chunks = -(-E // spec_for("2psl").chunk_size)
    (report, res), counts, wall = counted(lambda: run_cli(
        ["--input", path, "--k", str(k), "--hosts", str(hosts),
         "--dcn-penalty", "1.0", "--artifact-dir", art_dir,
         "--local-graphs", "--plan-json", plan_json, "--trace", trace]))
    checks = check_run(report, res, k, E)
    expect_launches(counts, {"edge_score": chunks},
                    "artifact (one edge_score per scoring chunk)")
    by_entry = expect_bits_entry(chunks, "artifact", "edge_score")
    spans = trace_span_s(trace, ("halo_plan", "host_plan", "local_graphs"))

    t0 = time.perf_counter()
    art = PartitionArtifact.load(art_dir)
    load_s = time.perf_counter() - t0
    plan, host = art.halo_plan(), art.host_halo_plan()
    t0 = time.perf_counter()
    fresh = plan_halo_exchange_stream(
        MemmapEdgeStream(path), art.assignment, art.num_vertices, k)
    fresh_plan_s = time.perf_counter() - t0
    arrays = _plans_equal(plan, fresh, "halo plan")
    arrays += _plans_equal(host, host_plan_from_halo(fresh, hosts),
                           "host plan")
    local_edges = 0
    for p in range(k):
        g = art.local_graph(p)
        want = plan.vmap_global[p]
        if not np.array_equal(g.vmap_global, want[want >= 0]):
            raise AssertionError(f"local graph {p}: ids are not "
                                 f"vmap_global[{p}]")
        local_edges += g.num_edges
    if local_edges != E:
        raise AssertionError(f"local graphs hold {local_edges} edges")
    with open(plan_json) as f:
        book = json.load(f)
    if (book["halo_plan"]["v_cap"] != plan.v_cap
            or sum(p["num_edges"] for p in book["parts"]) != E):
        raise AssertionError("--plan-json disagrees with the halo plan")
    npz = os.path.join(art_dir, "halo_plan.npz")
    with open(npz, "r+b") as f:
        f.seek(os.path.getsize(npz) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    try:
        PartitionArtifact.load(art_dir)
    except ArtifactIntegrityError:
        refused = True
    else:
        raise AssertionError("a flipped byte of halo_plan.npz loads")
    with open(npz, "r+b") as f:        # the artifact serves in gnn_serve
        f.seek(os.path.getsize(npz) // 2)
        f.write(byte)
    PartitionArtifact.load(art_dir)
    partition_s = sum(report["timings_s"].values())
    return {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": E, "vertices": report["vertices"], "k": k,
            "hosts": hosts, "dcn_penalty": 1.0, "cli_wall_s": wall,
            "partition_s": partition_s, "halo_plan_s": spans["halo_plan"],
            "host_plan_s": spans["host_plan"],
            "local_graphs_s": spans["local_graphs"],
            "save_and_rest_s": wall - partition_s - sum(spans.values()),
            "load_verified_s": load_s, "fresh_plan_s": fresh_plan_s,
            "timings_s": report["timings_s"],
            "replication_factor": report["replication_factor"],
            "cross_host_rf": report["cross_host_rf"],
            "b_cap": report["b_cap"], "v_cap": report["v_cap"],
            "host_plan": report["host_plan"],
            "local_graphs": report["local_graphs"],
            "plan_arrays_equal": arrays, "flipped_byte_refused": refused,
            "edge_score_launches": counts["edge_score"],
            "edge_score_launches_by_entry": by_entry,
            "scoring_chunks": chunks, **checks}


def partition_counted(argv) -> int:
    """``--partition-counted ARGS``: the port's CLI on ``ARGS`` in this
    process, every launch counter set to 0 just before; prints one JSON
    line with its report, the launches by kernel and by entry, and its
    wall.  The crash drill's processes (``cli_processes``)."""
    (report, res), counts, wall = counted(lambda: run_cli(argv))
    cs = counters()
    emit({"report": report, "launches": counts, "wall_s": wall,
          "by_entry": {n: dict(cs[n].by_entry)
                       for n in ("edge_score", "hdrf_score")}})
    return 0


def run_dist_cli(argv):
    """The port's distributed CLI (``repro_torch.launch.dist_partition``):
    its exit code and its JSON report (None on a rank other than 0, which
    prints none)."""
    from repro_torch.launch.dist_partition import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv + ["--json"])
    out = buf.getvalue()
    return rc, json.loads(out) if out.strip() else None


def dist_counted(argv) -> int:
    """``--dist-counted ARGS``: ``partition_counted`` for the distributed
    CLI — one rank of a sharded run in this process (the ``shard``
    phase's processes); the report is None on a rank other than 0."""
    (rc, report), counts, wall = counted(lambda: run_dist_cli(argv))
    cs = counters()
    emit({"report": report, "launches": counts, "wall_s": wall,
          "by_entry": {n: dict(cs[n].by_entry)
                       for n in ("edge_score", "hdrf_score")}})
    return rc


def start_cli_processes(jobs, tmp: str,
                        mode: str = "--partition-counted") -> list:
    """Start every job — ``(argv, extra environment)`` — as ``chip_smoke.py
    MODE ARGV`` (``--partition-counted`` or ``--dist-counted``), all at
    once, each logging to a file in ``tmp``; ``wait_cli_processes``
    collects them."""
    procs = []
    for argv, env_extra in jobs:
        fd, name = tempfile.mkstemp(suffix=".log", dir=tmp)
        log = os.fdopen(fd, "w+")
        env = dict(os.environ, **env_extra)
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, *argv],
            stdout=log, stderr=subprocess.STDOUT, text=True, env=env)
        threading.Thread(target=_note_exit, args=(proc,), daemon=True).start()
        procs.append((proc, log, t0))
    return procs


def _note_exit(proc) -> None:
    """Record when ``proc`` exits (``proc.t_end``), so that its wall is
    right however late ``wait_cli_processes`` gets to it."""
    proc.wait()
    proc.t_end = time.perf_counter()


def wait_cli_processes(procs, timeout: int = 600) -> list:
    """Wait for processes ``start_cli_processes`` started (killing any left
    on error): each one's exit code, its last JSON line (None when it
    printed none) and its wall seconds."""
    out = []
    try:
        for proc, log, t0 in procs:
            rc = proc.wait(timeout=timeout)
            wall = getattr(proc, "t_end", time.perf_counter()) - t0
            log.seek(0)
            lines = [ln for ln in log.read().splitlines()
                     if ln.startswith("{")]
            out.append({"rc": rc, "wall_s": wall,
                        "line": json.loads(lines[-1]) if lines else None,
                        "tail": lines[-1:] if rc not in (0, 137)
                        else None})
    finally:
        stop_cli_processes(procs)
    return out


def stop_cli_processes(procs) -> None:
    """Kill whichever of the processes still runs and close their logs."""
    for proc, log, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def cli_processes(jobs, tmp: str, alone: bool = False) -> list:
    """Run the jobs at once (``start_cli_processes``) and wait for all;
    with ``alone``, one after another, each process alone on the card."""
    if alone:
        return [r for job in jobs
                for r in wait_cli_processes(start_cli_processes([job], tmp))]
    return wait_cli_processes(start_cli_processes(jobs, tmp))


def _sha256(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 22), b""):
            h.update(block)
    return h.hexdigest()


def launches_per_chunk(name: str, E: int, chunk: int, window: int) -> list:
    """Each pass's launches per engine unit (chunk, or buffered's window) at
    this geometry: 2PS-L one ``edge_score`` per scoring chunk, HDRF one
    ``hdrf_score`` per non-empty 64-edge micro-batch, buffered one
    ``edge_score`` per non-empty 1,024-edge sub-batch.  The clean run's
    count checks it."""
    unit = chunk * window
    sizes = [min(unit, E - lo) for lo in range(0, E, unit)]
    if name == "2psl":
        return [[0] * len(sizes), [1] * len(sizes)]
    sub = 64 if name == "hdrf" else 1024
    return [[-(-n // sub) for n in sizes]]


#: the crash drill's runs: (algorithm, RMAT scale, kernel, extra flags).
#: Each is cut so that the drill's second checkpoint (every 2 chunks or
#: windows) lands inside the pass that launches: 2PS-L in three chunks a
#: pass, HDRF in 32,768-edge chunks, buffered in 32,768-edge windows.
DRILL = (("2psl", 16, "edge_score", None),
         ("hdrf", 14, "hdrf_score", ["--chunk-size", "32768"]),
         ("buffered", 14, "edge_score",
          ["--chunk-size", "16384", "--buffer-edges", "32768"]))


def resume_path(tmp: str, k: int = 32, alone: bool = False) -> dict:
    """The crash drill through the CLI, each algorithm of ``DRILL`` in
    processes of its own (the three at once at each step, or with
    ``alone`` one process at a time): a clean run;
    ``--checkpoint-every 2`` with ``REPRO_CRASH_AFTER_CHECKPOINTS=2``, which
    must exit 137; ``--resume``, whose ``assignment.bin`` must have the
    clean run's sha256 and whose launches must be the clean run's for the
    units at and after the checkpoint's cursor in the pass in flight, and
    all of the later passes'.  Beside them, ``--io-retries 2`` on a healthy
    stream: no retry, the same bytes."""
    from repro_torch.robust import load_engine_checkpoint
    runs = []
    for name, scale, kernel, extra in DRILL:
        path, E = write_graph(scale, tmp)
        if extra is None:       # three chunks a pass, 1,024-edge aligned
            extra = ["--chunk-size", str(1024 * -(-E // 3072))]
        base = ["--input", path, "--k", str(k), "--algorithm", name,
                *extra, "--no-plan"]
        runs.append({"name": name, "scale": scale, "kernel": kernel,
                     "E": E, "base": base, "dir": os.path.join(tmp, name)})

    def step(tag, flags, env):
        return cli_processes(
            [(r["base"] + ["--artifact-dir", f"{r['dir']}_{tag}", *flags],
              env) for r in runs], tmp, alone)

    retries_out = os.path.join(tmp, "retries.bin")
    first = cli_processes(
        [(r["base"] + ["--artifact-dir", f"{r['dir']}_clean"], {})
         for r in runs]
        + [(runs[0]["base"][:-1] + ["--out", retries_out,
                                    "--io-retries", "2"], {})], tmp, alone)
    crash = step("drill", ["--checkpoint-every", "2"],
                 {"REPRO_CRASH_AFTER_CHECKPOINTS": "2"})
    metas = [load_engine_checkpoint(
        os.path.join(f"{r['dir']}_drill", "checkpoints")).meta
        for r in runs]
    resumed = step("drill", ["--checkpoint-every", "2", "--resume"], {})
    out = {}
    for r, clean, cut, meta, res in zip(runs, first, crash, metas, resumed):
        name, kernel = r["name"], r["kernel"]
        if clean["rc"] or res["rc"]:
            raise AssertionError(f"{name}: clean {clean}, resumed {res}")
        if cut["rc"] != 137 or cut["line"] is not None:
            raise AssertionError(f"{name}: the crash run exited "
                                 f"{cut['rc']}, expected 137")
        chunk = int(r["base"][r["base"].index("--chunk-size") + 1])
        window = 1
        if "--buffer-edges" in r["base"]:
            buf = int(r["base"][r["base"].index("--buffer-edges") + 1])
            window = -(-buf // chunk)
        per = launches_per_chunk(name, r["E"], chunk, window)
        n_clean = clean["line"]["launches"][kernel]
        if n_clean != sum(map(sum, per)):
            raise AssertionError(f"{name}: clean run launched {n_clean} "
                                 f"{kernel}, expected {sum(map(sum, per))}")
        pi, nxt = int(meta["pass_index"]), int(meta["next_chunk"])
        want = sum(per[pi][nxt:]) + sum(map(sum, per[pi + 1:]))
        got = res["line"]["launches"]
        expect_launches(got, {kernel: want},
                        f"{name} resumed at pass {pi}, unit {nxt}")
        by = res["line"]["by_entry"][kernel]
        if by != {"bits": want, "flags": 0}:
            raise AssertionError(f"{name}: resumed launches by entry {by}")
        sha_clean = _sha256(os.path.join(f"{r['dir']}_clean",
                                         "assignment.bin"))
        sha_res = _sha256(os.path.join(f"{r['dir']}_drill",
                                       "assignment.bin"))
        if sha_clean != sha_res:
            raise AssertionError(f"{name}: resumed assignment differs")
        rep = res["line"]["report"]
        with open(os.path.join(f"{r['dir']}_drill", "manifest.json")) as f:
            manifest = json.load(f)
        if rep["resumes"] != 1 or manifest["extras"]["resumes"] != 1:
            raise AssertionError(f"{name}: resumes not recorded")
        saves = rep.get("checkpoints_written", 0)
        out[name] = {
            "graph": f"rmat_graph({r['scale']}, edge_factor=16, seed=0)",
            "edges": r["E"], "k": k, "flags": r["base"][6:-1],
            "cut_at": {"pass_index": pi, "next_chunk": nxt,
                       "edge_lo": int(meta["edge_lo"])},
            "clean_launches": n_clean, "resumed_launches": got[kernel],
            "resumed_launches_expected": want, "sha256": sha_clean,
            "clean_wall_s": clean["wall_s"], "crash_wall_s": cut["wall_s"],
            "resume_wall_s": res["wall_s"],
            "clean_timings_s": clean["line"]["report"]["timings_s"],
            "resumed_timings_s": rep["timings_s"],
            "resumed_checkpoints": saves,
            "checkpoint_s_per_save":
                rep["timings_s"].get("checkpoint", 0.0) / saves
                if saves else "not measured"}
    retry = first[-1]
    if retry["rc"] or retry["line"]["report"]["io_retries"] != 0:
        raise AssertionError(f"--io-retries on a healthy stream: {retry}")
    if _sha256(retries_out) != out["2psl"]["sha256"]:
        raise AssertionError("--io-retries changed the assignment")
    out["io_retries"] = {"algorithm": "2psl", "io_retries": 0,
                         "byte_equal": True, "wall_s": retry["wall_s"]}
    return out


def start_profile(tmp: str, scale: int = 14, k: int = 32) -> dict:
    """Start the ``profile`` phase's process: 2PS-L through the CLI with
    ``--torch-profile DIR --trace PATH`` in a fresh process (torch.profiler
    drops kernel records late in a long one), beside the crash drill's."""
    path, E = write_graph(scale, tmp)
    run = {"scale": scale, "k": k, "E": E,
           "prof": os.path.join(tmp, "torch_profile"),
           "trace": os.path.join(tmp, "profile_trace.json")}
    run["procs"] = start_cli_processes(
        [(["--input", path, "--k", str(k), "--torch-profile", run["prof"],
           "--trace", run["trace"]], {})], tmp)
    return run


def profile_path(run: dict) -> dict:
    """The ``profile`` phase's checks, once ``start_profile``'s process
    ends: the span trace validates, and the profiler's trace holds as many
    ``edge_score_bits_kernel`` records as the launch counter counted."""
    from repro_torch import obs
    from repro_torch.core import spec_for
    (res,) = wait_cli_processes(run["procs"])
    if res["rc"] or res["line"] is None:
        raise AssertionError(f"profiled run failed: {res}")
    chunks = -(-run["E"] // spec_for("2psl").chunk_size)
    counts = res["line"]["launches"]
    expect_launches(counts, {"edge_score": chunks}, "profiled 2PS-L")
    with open(run["trace"]) as f:
        spans = obs.validate_chrome_trace(json.load(f))
    with open(os.path.join(run["prof"], obs.TORCH_TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    recorded = sum("edge_score_bits_kernel" in e["name"] for e in kernels)
    if recorded != counts["edge_score"]:
        raise AssertionError(f"the profiler recorded {recorded} "
                             f"edge_score_bits_kernel, the counter "
                             f"{counts['edge_score']}")
    busy_us = sum(e.get("dur", 0) for e in kernels)
    wall = sum(res["line"]["report"]["timings_s"].values())
    return {"graph": f"rmat_graph({run['scale']}, edge_factor=16, seed=0)",
            "edges": run["E"], "k": run["k"],
            "process_wall_s": res["wall_s"], "run_s": wall,
            "edge_score_launches": counts["edge_score"],
            "edge_score_kernel_records": recorded,
            "kernel_records": len(kernels),
            "profiled_device_busy_share": busy_us / 1e6 / wall,
            "span_names": len(spans),
            "critical_stage": res["line"]["report"]["critical_stage"]}


# ---------------------------------------------------------------------------
# sharded partitioning (repro_torch.shard)
# ---------------------------------------------------------------------------

#: the ``shard`` phase's chunk: 64 chunks at RMAT-16, so that a round of 4
#: workers streams ~6% of the edges against its frozen base
SHARD_CHUNK = 16_384
#: the scale of the ``shard`` phase's parts 1 and 3-5 (16 until the MoE
#: phase; cut to 15, 32 chunks, to keep the whole run inside its limit)
SHARD_SCALE = 15
#: part 2's configurations, card against CPU at W = 3: (label, algorithm,
#: spec overrides); buffered keeps its own 16,384-edge chunks and
#: 65,536-edge windows
SHARD_CARD_VS_CPU = (
    ("2psl", "2psl", {"chunk_size": SHARD_CHUNK}),
    ("2psl_hosted", "2psl", {"chunk_size": SHARD_CHUNK, "host_groups": 4,
                             "dcn_penalty": 1.0}),
    ("hdrf_capped", "hdrf", {"chunk_size": SHARD_CHUNK, "use_cap": True}),
    ("buffered", "buffered", {}),
    ("hep_small", "hep", {"chunk_size": SHARD_CHUNK,
                          "memory_budget_bytes": HEP_SMALL_BUDGET}))


def check_assignment_file(path: str, k: int, E: int, alpha: float) -> dict:
    """A stitched assignment: E rows, every one in [0, k), and the largest
    part within alpha plus the quota's rounding (W-1 edges a partition a
    round, held here to 1% as the reference's sharded test holds it)."""
    from repro_torch.core import capacity
    asg = np.fromfile(path, np.int32)
    if asg.shape != (E,) or asg.min() < 0 or asg.max() >= k:
        raise AssertionError(f"{path}: rows outside [0, {k})")
    sizes = np.bincount(asg, minlength=k)
    balance = float(sizes.max() * k / E)
    if balance > alpha + 0.01:
        raise AssertionError(f"{path}: balance {balance} over {alpha}")
    return {"max_size": int(sizes.max()),
            "capacity": capacity(E, k, alpha), "balance": balance}


def shard_emulated(scale: int, tmp: str, k: int = 32) -> dict:
    """Part 1: 2PS-L at ``scale`` in 16,384-edge chunks, sequentially
    through the partition CLI and sharded through the distributed CLI's
    emulated backend (worker threads in this process, one card) at W = 1,
    4 and 2: W = 1 byte-equal to the sequential run, and every run one
    ``edge_score`` launch per scoring chunk, all through the bits entry,
    summed over its workers."""
    path, E = write_graph(scale, tmp)
    chunks = -(-E // SHARD_CHUNK)
    common = ["--input", path, "--k", str(k), "--chunk-size",
              str(SHARD_CHUNK)]
    seq_out = os.path.join(tmp, "shard_seq.bin")
    (report, _), counts, seq_wall = counted(
        lambda: run_cli(common + ["--out", seq_out]))
    expect_launches(counts, {"edge_score": chunks},
                    "sharding's sequential 2PS-L")
    seq_sha = _sha256(seq_out)
    out = {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
           "edges": E, "k": k, "chunk_size": SHARD_CHUNK,
           "scoring_chunks": chunks,
           "sequential": {"wall_s": seq_wall,
                          "timings_s": report["timings_s"],
                          "replication_factor":
                              report["replication_factor"],
                          "sha256": seq_sha}}
    for W in (1, 4, 2):
        dest = os.path.join(tmp, f"shard_w{W}.bin")
        (rc, rep), counts, wall = counted(lambda: run_dist_cli(
            common + ["--backend", "emulated", "--workers", str(W),
                      "--out", dest]))
        what = f"emulated 2PS-L at W = {W}"
        if rc:
            raise AssertionError(f"{what} exited {rc}")
        expect_launches(counts, {"edge_score": chunks}, what)
        by_entry = expect_bits_entry(chunks, what, "edge_score")
        sha = _sha256(dest)
        if W == 1 and sha != seq_sha:
            raise AssertionError("W = 1 differs from the sequential run")
        out[f"w{W}"] = {
            "wall_s": wall, "wall_over_sequential": wall / seq_wall,
            "rounds": rep["rounds"], "merge_seconds": rep["merge_seconds"],
            "merge_s_per_round_per_worker":
                rep["merge_seconds"] / (rep["rounds"] * 2) / W,
            "timings_s_rank0": rep["timings_s"],
            "replication_factor": rep["replication_factor"],
            "alpha_measured": rep["alpha_measured"],
            "edge_score_launches": counts["edge_score"],
            "edge_score_launches_by_entry": by_entry, "sha256": sha,
            **check_assignment_file(dest, k, E, 1.05)}
    return out


def shard_card_vs_cpu(scale: int, k: int = 32, shards: int = 3) -> dict:
    """Part 2: ``run_spec_sharded`` at W = ``shards`` on the card and on
    the CPU for each of ``SHARD_CARD_VS_CPU``: the assignments byte-equal,
    RF equal, every rank's slice sha256 equal; the card's launches those of
    the sequential geometry (2PS-L one ``edge_score`` per scoring chunk,
    HDRF one ``hdrf_score`` per non-empty micro-batch, buffered one
    ``edge_score`` per non-empty sub-batch, HEP none), all through the
    bits entries."""
    from repro_torch.core import InMemoryEdgeStream, spec_for
    from repro_torch.core.buffered import SUB_BATCH_TARGET
    from repro_torch.data import rmat_graph
    from repro_torch.shard import run_spec_sharded
    edges = rmat_graph(scale, edge_factor=16, seed=0)
    E = len(edges)
    out = {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
           "edges": E, "k": k, "shards": shards}
    for label, algo, overrides in SHARD_CARD_VS_CPU:
        spec = spec_for(algo, **overrides)
        if algo == "buffered":
            window = spec.chunk_size * spec.window_chunks
            sub = -(-window // -(-window // SUB_BATCH_TARGET))
            want = {"edge_score": buffered_launches(E, window, sub)}
        elif algo == "hdrf":
            want = {"hdrf_score": hdrf_launches(E, spec.chunk_size)}
        elif algo == "2psl":
            want = {"edge_score": -(-E // spec.chunk_size)}
        else:
            want = {}
        card, counts, card_wall = counted(lambda: run_spec_sharded(
            spec, InMemoryEdgeStream(edges), k, num_shards=shards,
            device="cuda"))
        expect_launches(counts, want, f"sharded {label} on the card")
        for name, n in want.items():
            expect_bits_entry(n, f"sharded {label}", name)
        t0 = time.perf_counter()
        cpu = run_spec_sharded(spec, InMemoryEdgeStream(edges), k,
                               num_shards=shards, device="cpu")
        cpu_wall = time.perf_counter() - t0
        mism = int((card.assignment != cpu.assignment).sum())
        if (mism or card.quality.replication_factor
                != cpu.quality.replication_factor
                or card.extras["shard_slices"] != cpu.extras["shard_slices"]):
            raise AssertionError(f"sharded {label}: card vs cpu, {mism} "
                                 f"assignment mismatches")
        out[label] = {"algorithm": algo, "overrides": overrides,
                      "rounds": card.extras["rounds"],
                      "card_wall_s": card_wall, "cpu_wall_s": cpu_wall,
                      "replication_factor": card.quality.replication_factor,
                      "balance": card.quality.balance,
                      "merge_seconds": card.extras["merge_seconds"],
                      "launches": counts, "assignment_mismatches": mism,
                      "slice_sha256": [sl["sha256"] for sl in
                                       card.extras["shard_slices"]]}
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_shard_processes(scale: int, tmp: str, k: int = 32) -> dict:
    """Parts 3-5, started: 2PS-L at ``scale``, two ranks on the card each,
    all at once: the fs backend with each rank a ``--dist-counted``
    process; the same with ``--backend torch`` over a gloo group on
    localhost; the fs backend's parent mode (``python -m
    repro_torch.launch.dist_partition`` spawning its ranks,
    ``--checkpoint-every 1``: the drill's clean run); and the crash drill's
    rank 0, and its rank 1 with ``REPRO_CRASH_AFTER_CHECKPOINTS=1``.
    ``finish_shard_processes`` resumes the crashed rank and checks them."""
    from repro_torch.shard import ShardLayout
    path, E = write_graph(scale, tmp)
    layout = ShardLayout(num_edges=E, eff_chunk=SHARD_CHUNK, world=2)
    run = {"scale": scale, "k": k, "E": E, "layout": layout,
           "dealt": [[layout.round_span(rnd, r)[1]
                      for rnd in range(layout.num_rounds)]
                     for r in range(2)],
           "dirs": {n: os.path.join(tmp, f"shard_{n}")
                    for n in ("fs", "torch", "clean", "drill")}}
    dirs = run["dirs"]
    base = ["--input", path, "--k", str(k), "--chunk-size",
            str(SHARD_CHUNK), "--workers", "2", "--no-plan",
            "--timeout", "300"]
    fs = [base + ["--backend", "fs", "--artifact-dir", dirs["fs"],
                  "--rank", str(r)] for r in range(2)]
    coordinator = f"tcp://127.0.0.1:{_free_port()}"
    tor = [base + ["--backend", "torch", "--coordinator", coordinator,
                   "--artifact-dir", dirs["torch"], "--rank", str(r)]
           for r in range(2)]
    run["drill"] = base + ["--backend", "fs", "--artifact-dir",
                           dirs["drill"], "--checkpoint-every", "1"]
    run["log"] = open(os.path.join(tmp, "shard_parent.log"), "w+")
    run["t0"] = time.perf_counter()
    run["parent"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dist_partition", *base,
         "--backend", "fs", "--artifact-dir", dirs["clean"],
         "--checkpoint-every", "1", "--json"],
        stdout=run["log"], stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    threading.Thread(target=_note_exit, args=(run["parent"],),
                     daemon=True).start()
    run["procs"] = start_cli_processes(
        [(a, {}) for a in fs + tor] + [(run["drill"] + ["--rank", "0"], {})],
        tmp, "--dist-counted")
    run["cut"] = start_cli_processes(
        [(run["drill"] + ["--rank", "1"],
          {"REPRO_CRASH_AFTER_CHECKPOINTS": "1"})], tmp, "--dist-counted")
    return run


def stop_shard_processes(run: dict) -> None:
    """Kill whatever ``start_shard_processes`` started that still runs."""
    if run["parent"].poll() is None:
        run["parent"].kill()
        run["parent"].wait()
    stop_cli_processes(run["procs"] + run["cut"])
    run["log"].close()


def finish_shard_processes(run: dict, emulated_sha: str) -> dict:
    """Parts 3-5, checked: the drill's rank 1 exited 137 while its rank 0
    waits; rank 1 relaunched with ``--resume`` re-joins.  Every stitched
    ``assignment.bin`` has the emulated W = 2 run's sha256, and each
    counted rank launches one ``edge_score`` per scoring chunk
    ``ShardLayout`` deals it (the resumed rank those at and after its
    cursor)."""
    from repro_torch.robust import load_engine_checkpoint
    dirs, dealt, tmp = run["dirs"], run["dealt"], os.path.dirname(
        run["dirs"]["fs"])
    try:
        (cut,) = wait_cli_processes(run["cut"])
        if cut["rc"] != 137 or cut["line"] is not None:
            raise AssertionError(f"the crashed rank exited {cut['rc']}, "
                                 f"expected 137")
        if run["procs"][-1][0].poll() is not None:
            raise AssertionError("rank 0 of the drill did not wait")
        meta = load_engine_checkpoint(os.path.join(
            dirs["drill"], "checkpoints", "rank001")).meta
        resumed = start_cli_processes(
            [(run["drill"] + ["--rank", "1", "--resume"], {})], tmp,
            "--dist-counted")
        results = wait_cli_processes(run["procs"] + resumed)
        parent_rc = run["parent"].wait(timeout=600)
        parent_wall = getattr(run["parent"], "t_end",
                              time.perf_counter()) - run["t0"]
        run["log"].seek(0)
        parent_out = run["log"].read()
    finally:
        stop_shard_processes(run)
    if parent_rc:
        raise AssertionError(f"the fs parent mode exited {parent_rc}: "
                             f"{parent_out[-2000:]}")
    for res in results:
        if res["rc"] or res["line"] is None:
            raise AssertionError(f"a shard rank failed: {res}")
    fs_r, tor_r, drill0, drill1 = (results[0:2], results[2:4], results[4],
                                   results[5])
    pi, nxt = int(meta["pass_index"]), int(meta["next_chunk"])
    # 2PS-L launches in its scoring pass (pass 1) only
    resumed_want = sum(dealt[1][nxt:]) if pi == 1 else (
        sum(dealt[1]) if pi == 0 else 0)
    for name, ranks in (("fs", fs_r), ("torch", tor_r)):
        for r, res in enumerate(ranks):
            expect_launches(res["line"]["launches"],
                            {"edge_score": sum(dealt[r])},
                            f"{name} rank {r}")
    expect_launches(drill0["line"]["launches"],
                    {"edge_score": sum(dealt[0])}, "drill rank 0")
    expect_launches(drill1["line"]["launches"],
                    {"edge_score": resumed_want},
                    f"drill rank 1 resumed at pass {pi}, round {nxt}")
    shas = {n: _sha256(os.path.join(d, "assignment.bin"))
            for n, d in dirs.items()}
    if set(shas.values()) != {emulated_sha}:
        raise AssertionError(f"sharded runs disagree: {shas}, emulated "
                             f"{emulated_sha}")
    with open(os.path.join(dirs["drill"], "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["extras"].get("resumes", 0) < 1:
        raise AssertionError("the drill's resume is not recorded")
    fs_report = fs_r[0]["line"]["report"]
    if fs_report["backend"] != "fs" or \
            tor_r[0]["line"]["report"]["backend"] != "torch":
        raise AssertionError("backend not reported")

    def rank_line(res):
        return {"wall_s": res["wall_s"], "run_s": res["line"]["wall_s"],
                "start_up_s": res["wall_s"] - res["line"]["wall_s"],
                "edge_score_launches": res["line"]["launches"]["edge_score"]}
    return {"graph": f"rmat_graph({run['scale']}, edge_factor=16, seed=0)",
            "edges": run["E"], "k": run["k"], "workers": 2,
            "rounds": run["layout"].num_rounds,
            "dealt_scoring_chunks": [sum(d) for d in dealt],
            "sha256": emulated_sha,
            "fs": [rank_line(r) for r in fs_r],
            "fs_timings_s_rank0": fs_report["timings_s"],
            "fs_merge_seconds": fs_report["merge_seconds"],
            "torch": [rank_line(r) for r in tor_r],
            "parent_mode_wall_s": parent_wall,
            "drill": {"cut_at": {"pass_index": pi, "next_round": nxt},
                      "crash_wall_s": cut["wall_s"],
                      "rank0": rank_line(drill0),
                      "rank1_resumed": rank_line(drill1),
                      "resumes": manifest["extras"]["resumes"]}}


def shard_path(tmp: str, k: int = 32, scale: int = SHARD_SCALE) -> dict:
    """The ``shard`` phase: ``shard_emulated`` at RMAT-``scale`` alone on
    the card (its walls), then the processes of parts 3-5 at the same
    scale started, ``shard_card_vs_cpu`` at RMAT-14 beside them, and the
    processes finished and checked."""
    emulated = shard_emulated(scale, tmp, k)
    run = start_shard_processes(scale, tmp, k)
    try:
        card_vs_cpu = shard_card_vs_cpu(14, k)
    except BaseException:
        stop_shard_processes(run)
        raise
    return {"emulated": emulated, "card_vs_cpu": card_vs_cpu,
            "processes": finish_shard_processes(
                run, emulated["w2"]["sha256"])}


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


def counted_calls(fn, n: int, kernel: str, what: str,
                  route: str | None = None) -> tuple:
    """``n`` calls of ``fn``, each with every counter reset just before and
    read just after (exactly one launch of ``kernel``, nothing else, and
    on ``route`` where one is named), each timed between CUDA events; (the
    last output, ms per call, launches)."""
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
        by = counters()[kernel].by_route if route else {}
        if route and by[route] != 1:
            raise AssertionError(f"{what}: launches by route {by}, "
                                 f"expected one on {route}")
        ms.append(a.elapsed_time(b))
        launches += counts[kernel]
    return out, ms, launches


def csr_library_ms(prep, col, values, n_cols: int, rows, reps: int = 5):
    """cuSPARSE's SpMM (``torch.sparse.mm`` of a CSR matrix built once from
    the prep) on the same operands: a yardstick of speed only, never on the
    port's path.  Returns (ms, its output).  The column ids take
    ``row_ptr``'s width: cuSPARSE reads both index arrays at one width,
    and with the invariants unchecked an int32 ``col`` beside the int64
    ``row_ptr`` is read past its end (an illegal address)."""
    import torch
    col = col.to(prep.row_ptr.dtype)
    a = torch.sparse_csr_tensor(prep.row_ptr, col, values,
                                size=(prep.num_nodes, n_cols),
                                check_invariants=False)
    ms = cuda_time_ms(lambda: torch.sparse.mm(a, rows), reps, 1)
    return ms, torch.sparse.mm(a, rows)


def gnn_aggregate(scale: int, tmp: str) -> dict:
    """One GIN layer's neighbour sum at ogb_products' scale: 4 relabelled
    copies of RMAT-``scale``; the graph's src and edge mask bound once
    (``with_edges``), then ``spmm(h, src, edge_mask, prep)`` at gin-tu's
    D = 64, one warm-up and one call per layer, each on the bound route,
    and ``segment_sum_tiles`` of (E, 70) messages, one warm-up and two
    calls; exactly one ``spmm`` launch per call.  Then the last outputs
    against the plain versions, and the kernel's routes, the plain
    versions and cuSPARSE timed on the same inputs by CUDA events.  Last,
    gin-tu's whole forward on the graph (``gin_tu_forward``)."""
    import torch
    from repro_torch.kernels import wrap_clamp_index
    from repro_torch.kernels.spmm import (kernel, prepare_tiles,
                                          segment_sum_ref, segment_sum_tiles,
                                          spmm, spmm_ref)
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
    t0 = time.perf_counter()
    bound_prep = prep.with_edges(src_d, mask, num_rows=N)
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    y, gin_ms, gin_n = counted_calls(
        lambda: spmm(h, src_d, mask, bound_prep), 1 + GIN_LAYERS, "spmm",
        "gin-tu neighbour sum (one spmm)", route="bound")
    gin_peak = torch.cuda.max_memory_allocated()
    gather = wrap_clamp_index(src_d, N)
    touched = int(torch.unique(gather).numel())
    # bytes: the x rows touched once (or one per edge), src, mask, perm,
    # row_ptr read once, Y written once; 2 operations per (edge, feature)
    rest = E * (4 + 4 + 4) + (N + 1) * 8 + N * GIN_D * 4
    gin_bound = bound(touched * GIN_D * 4 + rest, 2 * E * GIN_D)
    gin_gathered = bound(E * GIN_D * 4 + rest, 2 * E * GIN_D)
    # in turns: the bound route, the previous route, no split, cuSPARSE
    timing = timed(lambda: spmm(h, src_d, mask, bound_prep),
                   lambda: spmm_ref(h, src_d, dst_d, mask, N), reps=3,
                   profile=False)
    previous_ms = cuda_time_ms(lambda: spmm(h, src_d, mask, prep), 6, 1)
    previous_y = spmm_route(lambda: spmm(h, src_d, mask, prep), "perm",
                            "the previous route at the path shape")
    flat = bound_prep.with_split(None)
    flat_ms = cuda_time_ms(lambda: spmm(h, src_d, mask, flat), 3, 1)
    scale_y = spmm_ref(h.abs(), src_d, dst_d, mask, N)
    flat_agree = sum_agree(spmm_route(lambda: spmm(h, src_d, mask, flat),
                                      "bound", "the bound route unsplit"),
                           y, scale_y)
    perm = prep.perm.long()
    lib_ms, lib_y = csr_library_ms(prep, gather[perm], mask[perm], N, h)
    ms_again = cuda_time_ms(lambda: spmm(h, src_d, mask, bound_prep), 6, 1)
    want = spmm_ref(h, src_d, dst_d, mask, N)
    agree = sum_agree(y, want, scale_y)
    previous_agree = sum_agree(previous_y, want, scale_y)
    lib_err = float((lib_y - want).abs().max())
    gin_plan = vars(kernel.plan_for(h))
    if not (agree["ok"] and flat_agree["ok"] and previous_agree["ok"]):
        raise AssertionError(f"spmm disagrees at the path shape: {agree}, "
                             f"without the split: {flat_agree}, on the "
                             f"previous route: {previous_agree}")
    del h, y, want, lib_y, gather, previous_y, scale_y
    del bound_prep, flat       # the bound arrays, before the messages
    torch.cuda.empty_cache()
    gin = {"D": GIN_D, "route": "bound", "bind_s": bind_s,
           "plan": gin_plan,
           "calls_ms": gin_ms, "warmup_ms": gin_ms[0],
           "ms_per_call": float(np.median(gin_ms[1:])), "launches": gin_n,
           "launches_by_route": {"bound": gin_n},
           "peak_device_bytes": gin_peak, "touched_rows": touched,
           "gb_per_s": (touched * GIN_D * 4 + rest) / 1e6
           / float(np.median(gin_ms[1:])),
           "gathered_gb_per_s": (E * GIN_D * 4 + rest) / 1e6
           / float(np.median(gin_ms[1:])),
           **timing, "ms_again": ms_again, **gin_bound,
           "gathered_bound_ms": gin_gathered["bound_ms"],
           "previous_ms": previous_ms, "previous": previous_agree,
           "no_split_ms": flat_ms, "no_split": flat_agree, **agree,
           "library_ms": lib_ms, "library_max_abs_diff": lib_err,
           "library": "torch.sparse.mm(CSR(row_ptr, src[perm], mask[perm]), "
                      "h), cuSPARSE SpMM"}

    msgs = torch.randn((E, GATED_D), generator=g, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    y, seg_ms, seg_n = counted_calls(lambda: segment_sum_tiles(msgs, prep),
                                     3, "spmm",
                                     "GatedGCN message sum (one spmm)",
                                     route="perm")
    seg_peak = torch.cuda.max_memory_allocated()
    seg_bytes = E * GATED_D * 4 + E * 4 + (N + 1) * 8 + N * GATED_D * 4
    seg_timing = timed(lambda: segment_sum_tiles(msgs, prep),
                       lambda: segment_sum_ref(msgs, dst_d, N), reps=2,
                       profile=False)
    vec_ms = cuda_time_ms(lambda: segment_sum_bound(msgs, prep), 4, 1)
    vec_y = segment_sum_bound(msgs, prep)
    lib_ms, lib_y = csr_library_ms(prep, perm, torch.ones_like(mask), E,
                                   msgs, reps=2)
    want = segment_sum_ref(msgs, dst_d, N)
    lib_err = float((lib_y - want).abs().max())
    del lib_y
    vec_plan = vars(kernel.plan_for(msgs))
    seg_scale = segment_sum_ref(msgs.abs_(), dst_d, N)
    agree = sum_agree(y, want, seg_scale)
    vec_agree = sum_agree(vec_y, want, seg_scale)
    if not (agree["ok"] and vec_agree["ok"]):
        raise AssertionError(f"segment_sum_tiles disagrees at the path "
                             f"shape: {agree}, on the bound route: "
                             f"{vec_agree}")
    del msgs, y, want, vec_y, seg_scale
    torch.cuda.empty_cache()
    forward = gin_tu_forward(src_d, dst_d, mask, prep, N, tmp)
    train = gnn_train(src_d, dst_d, mask, N, tmp)
    seg = {"D": GATED_D, "route": "perm", "calls_ms": seg_ms,
           "warmup_ms": seg_ms[0],
           "ms_per_call": float(np.median(seg_ms[1:])), "launches": seg_n,
           "launches_by_route": {"perm": seg_n},
           "peak_device_bytes": seg_peak,
           "gb_per_s": seg_bytes / 1e6 / float(np.median(seg_ms[1:])),
           **seg_timing, **bound(seg_bytes, E * GATED_D), **agree,
           "bound_route_ms": vec_ms,
           "bound_route_plan": vec_plan,
           "bound_route": vec_agree,
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
            "gin_tu_forward": forward, "gnn_train": train,
            "spmm_launches": gin_n + seg_n,
            "launches_by_route": {"bound": gin_n, "perm": seg_n}}


# ---------------------------------------------------------------------------
# the GNN models and GNN serving: every segment sum through spmm
# ---------------------------------------------------------------------------

#: a GNN model's outputs, card against CPU: every element within this share
#: of the CPU output's largest magnitude (float32 products on cuBLAS and on
#: the CPU round differently, the segment sums add in other orders, and the
#: batch norms of the deep stacks amplify both; TF32 stays off)
GNN_TOL = 1e-4
#: gnn_aggregate's gin-tu forward held card against CPU on this RMAT scale
#: (GNN_COPIES relabelled copies)
GIN_CHECK_SCALE = 14
#: outputs held card against CPU, by model
GNN_OUTPUTS = {"gin": ("node_logits", "graph_logits"),
               "gatedgcn": ("node_logits", "graph_logits"),
               "egnn": ("node_logits", "graph_logits", "coords"),
               "nequip": ("atom_energy", "energy")}


def outputs_agree(card: dict, cpu: dict, keys) -> dict:
    """Each of ``keys`` finite, of the CPU's shape, and within ``GNN_TOL``
    of the CPU output's largest magnitude; the worst share."""
    import torch
    worst = 0.0
    for k in keys:
        a, b = card[k].float().cpu(), cpu[k].float()
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{k}: card output {tuple(a.shape)} not "
                                 f"finite or not of shape {tuple(b.shape)}")
        share = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                 1e-30)
        worst = max(worst, share)
    if worst > GNN_TOL:
        raise AssertionError(f"card against CPU: {worst} of the largest "
                             f"magnitude, above {GNN_TOL}")
    return {"max_err_share": worst, "tolerance": GNN_TOL, "ok": True}


def forward_calls(fn, n: int, by_route: dict, what: str) -> tuple:
    """``n`` calls of ``fn``, each with every counter reset just before and
    read just after: ``spmm`` launches exactly ``by_route`` by route,
    nothing else; each timed between CUDA events.  (The last output, ms
    per call, launches.)"""
    import torch
    ms, launches, out = [], 0, None
    for _ in range(n):
        out = None
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)

        def call():
            a.record()
            r = fn()
            b.record()
            b.synchronize()
            return r
        out, counts, _ = counted(call)
        expect_launches(counts, {"spmm": sum(by_route.values())}, what)
        got = dict(counters()["spmm"].by_route)
        if got != {**dict.fromkeys(got, 0), **by_route}:
            raise AssertionError(f"{what}: spmm launches by route {got}, "
                                 f"expected {by_route}")
        ms.append(a.elapsed_time(b))
        launches += counts["spmm"]
    return out, ms, launches


def gnn_card_vs_cpu(kind: str, cfg, batch: dict, n_graphs: int,
                    seed: int) -> dict:
    """``kind``'s forward through its entry on the same numpy batch and
    weights (drawn on the CPU from ``seed``) on the card and on the CPU."""
    import torch
    from repro_torch.models import gnn as G
    _, init, apply = G.GNN_MODELS[kind]
    params = init(cfg, torch.Generator().manual_seed(seed))
    cpu_b = {k: None if v is None else torch.from_numpy(v)
             for k, v in batch.items()}
    cpu = apply(cfg, params, cpu_b, n_graphs=n_graphs)
    card = apply(cfg, G.params_to(params, "cuda"),
                 {k: None if v is None else v.cuda()
                  for k, v in cpu_b.items()}, n_graphs=n_graphs)
    return outputs_agree(card, cpu, GNN_OUTPUTS[kind])


def gin_tu_forward(src, dst, mask, prep, N: int, tmp: str) -> dict:
    """gin-tu at full width (``config_for_shape("ogb_products")``: d_in
    100) through ``gin_apply`` on ``gnn_aggregate``'s graph, with BN: its
    ``GraphPrep`` made from the phase's prep (src and the edge mask bound
    once, the readout over one graph), a warm-up and 2 timed calls, each 5
    ``spmm`` launches on the bound route and the readout's on perm; the
    outputs finite and shaped; then card against CPU on
    ``GIN_CHECK_SCALE``'s copies."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn as G
    t_phase = time.perf_counter()
    cfg = get_arch("gin-tu").config_for_shape("ogb_products")
    params = G.params_to(G.gin_init(cfg, torch.Generator().manual_seed(0)),
                         "cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"nodes": torch.randn((N, cfg.d_in), generator=g, device="cuda"),
             "node_mask": torch.ones(N, device="cuda")}
    t0 = time.perf_counter()
    gp = G.GraphPrep(src=src, dst=dst, edge_mask=mask, num_nodes=N,
                     edges=prep.with_edges(src, mask, num_rows=N),
                     n_graphs=1, graphs=G.segments(np.zeros(N, np.int32),
                                                   1, "cuda"))
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    out, ms, n = forward_calls(
        lambda: G.gin_apply(cfg, params, batch, prep=gp), 3,
        {"bound": cfg.n_layers, "perm": 1},
        "gin-tu forward (5 bound spmm and the readout)")
    peak = torch.cuda.max_memory_allocated()
    for k, shape in (("node_logits", (N, cfg.n_classes)),
                     ("graph_logits", (1, cfg.n_classes))):
        if tuple(out[k].shape) != shape or not bool(
                torch.isfinite(out[k]).all()):
            raise AssertionError(f"gin-tu forward: {k} not finite or not "
                                 f"{shape}")
    del out, batch, gp
    torch.cuda.empty_cache()
    path, _ = write_graph(GIN_CHECK_SCALE, tmp)
    s, d, n_small = relabelled_copies(np.fromfile(path, np.uint32)
                                      .reshape(-1, 2), GNN_COPIES, seed=0)
    rng = np.random.default_rng(2)
    small = {"nodes": rng.standard_normal((n_small, cfg.d_in))
             .astype(np.float32),
             "edges": np.stack([s, d], 1),
             "edge_mask": (rng.random(len(s)) < 0.99).astype(np.float32),
             "node_mask": np.ones(n_small, np.float32),
             "graph_ids": np.zeros(n_small, np.int32)}
    agree = gnn_card_vs_cpu("gin", cfg, small, 1, 0)
    return {"config": vars(cfg), "seconds": time.perf_counter() - t_phase,
            "graph_prep_s": prep_s, "calls_ms": ms,
            "warmup_ms": ms[0], "ms_per_call": float(np.median(ms[1:])),
            "spmm_launches": n,
            "spmm_launches_per_call": {"bound": cfg.n_layers, "perm": 1},
            "peak_device_bytes": peak,
            "card_vs_cpu": {"graph": f"{GNN_COPIES} copies of rmat_graph("
                                     f"{GIN_CHECK_SCALE}), relabelled",
                            "nodes": n_small, "edges": len(s),
                            **agree}}


def gnn_models() -> dict:
    """GatedGCN and EGNN at full width on ``full_graph_sm`` (2,708 nodes,
    10,556 edges, d_in 1,433 by ``config_for_shape``, ``full_graph_batch``)
    and NequIP at full width on ``molecule`` (128 graphs of 30 atoms and
    64 edges, ``molecule_batch``), each through its entry on the card: a
    warm-up and 5 timed calls, every segment sum one ``spmm`` launch on
    perm (GatedGCN 2 a layer and the readout, EGNN the degrees, 2 a layer
    and the readout, NequIP 3 a layer and the readout); then card against
    CPU on the same batch and weights."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.gnn_batches import full_graph_batch, molecule_batch
    from repro_torch.models import gnn as G
    t0 = time.perf_counter()
    sm, mol = GNN_SHAPES["full_graph_sm"], GNN_SHAPES["molecule"]
    graph = full_graph_batch(sm["n_nodes"], sm["n_edges"], sm["d_feat"],
                             seed=0, with_coords=True)
    nequip = get_arch("nequip").config_for_shape("molecule")
    molecules, B = molecule_batch(mol["batch"], mol["n_nodes"],
                                  mol["n_edges"], n_species=nequip.n_species,
                                  seed=0)
    cases = {
        "gatedgcn": ("gatedgcn", "full_graph_sm", graph, 1,
                     lambda c: 2 * c.n_layers + 1),
        "egnn": ("egnn", "full_graph_sm", graph, 1,
                 lambda c: 2 * c.n_layers + 2),
        "nequip": ("nequip", "molecule", molecules, B,
                   lambda c: 3 * c.n_layers + 1)}
    out, total = {}, 0
    for kind, (arch, shape, batch, n_graphs, perm) in cases.items():
        cfg = get_arch(arch).config_for_shape(shape)
        _, init, apply = G.GNN_MODELS[kind]
        params = G.params_to(init(cfg, torch.Generator().manual_seed(0)),
                             "cuda")
        tb = {k: None if v is None else torch.from_numpy(v).cuda()
              for k, v in batch.items()}
        gp = G.graph_prep(tb, n_graphs)
        res, ms, n = forward_calls(
            lambda: apply(cfg, params, tb, n_graphs=n_graphs, prep=gp), 6,
            {"perm": perm(cfg)}, f"{kind} forward")
        total += n
        out[kind] = {"shape": shape, "config": vars(cfg),
                     "nodes": int(len(batch["node_mask"])),
                     "edges": int(len(batch["edges"])),
                     "calls_ms": ms, "ms_per_call": float(np.median(ms[1:])),
                     "spmm_launches_per_call": {"perm": perm(cfg)},
                     "card_vs_cpu": gnn_card_vs_cpu(kind, cfg, batch,
                                                    n_graphs, 0)}
    return {**out, "spmm_launches": total,
            "seconds": time.perf_counter() - t0}


#: gnn_serve's requests per call and roots per request
GNN_SERVE_REQUESTS, GNN_SERVE_ROOTS = 32, 4
#: the reference's serve_gnn report keys
GNN_REPORT_KEYS = {"mode", "artifact", "requests", "roots_per_request",
                   "fanouts", "k", "num_vertices", "num_edges", "p50_ms",
                   "p99_ms", "cache", "remote_rows_fetched",
                   "fetch_failures", "fetch_retries"}
#: the spans of a served request
GNN_SERVE_SPANS = ("serve.request", "sample.minibatch", "serve.features",
                   "serve.forward")


def serve_gnn_counted(art_dir: str, *, device: str = "cuda",
                      cli: bool = False, **kw) -> dict:
    """One ``serve_gnn`` call (or the CLI with ``--json``) under a fresh
    tracer, every counter reset just before: exactly ``(requests + 1) *
    len(fanouts)`` ``spmm`` launches on the card, all on the bound route
    (none on the CPU); its logits, report, spans and wall."""
    from repro_torch import obs
    from repro_torch.launch import serve
    fanouts = tuple(kw.get("fanouts", (-1, -1)))
    tracer = obs.Tracer()
    buf = io.StringIO()

    def call():
        with obs.use_tracer(tracer), contextlib.redirect_stdout(buf):
            if not cli:
                return serve.serve_gnn(art_dir, n_requests=GNN_SERVE_REQUESTS,
                                       roots_per=GNN_SERVE_ROOTS,
                                       device=device, **kw)
            serve.main(["--gnn-artifact", art_dir, "--requests",
                        str(GNN_SERVE_REQUESTS), "--roots-per",
                        str(GNN_SERVE_ROOTS), "--fanout",
                        *map(str, fanouts), "--json"])
            return None, json.loads(buf.getvalue().strip().splitlines()[-1])
    (logits, report), counts, wall = counted(call)
    n = (GNN_SERVE_REQUESTS + 1) * len(fanouts) if device == "cuda" else 0
    expect_launches(counts, {"spmm": n}, f"serve_gnn {kw} on {device}")
    by = dict(counters()["spmm"].by_route)
    if by != {**dict.fromkeys(by, 0), "bound": n}:
        raise AssertionError(f"serve_gnn: spmm launches by route {by}, "
                             f"expected {n} on bound")
    if set(report) != GNN_REPORT_KEYS:
        raise AssertionError(f"serve_gnn report keys {sorted(report)}")
    spans = dict.fromkeys(GNN_SERVE_SPANS, 0.0)
    for ev in tracer.events():
        if ev.get("ph") == "X" and ev["name"] in spans:
            spans[ev["name"]] += ev["dur"] / 1e6
    if logits is not None and not np.isfinite(logits).all():
        raise AssertionError("serve_gnn: logits not finite")
    return {"logits": logits, "report": report, "spans_s": spans,
            "wall_s": wall, "spmm_launches": n,
            "spmm_launches_by_route": by}


def gnn_serve(tmp: str) -> dict:
    """``serve_gnn`` on the ``artifact`` phase's RMAT-18 hosted artifact
    (local graphs built there), 32 requests of 4 roots after a warm-up
    request: full fan-out cached and uncached, ``--fanout 15 10``
    (minibatch_lg's), 2 and 5 injected fetch faults (2 recover within the
    default 2 retries, 5 serve degraded rows), the CLI with ``--json``,
    and the cached full fan-out on the CPU.  Cached == uncached and
    recovered == fault-free logits bit for bit on the card; card against
    CPU the same report counters and logits within ``GNN_TOL``."""
    art_dir = os.path.join(tmp, "artifact")
    t0 = time.perf_counter()
    runs = {"cached": serve_gnn_counted(art_dir),
            "uncached": serve_gnn_counted(art_dir, no_cache=True),
            "fanout_15_10": serve_gnn_counted(art_dir, fanouts=(15, 10)),
            "faults_2": serve_gnn_counted(art_dir, inject_fetch_faults=2),
            "faults_5": serve_gnn_counted(art_dir, inject_fetch_faults=5),
            "cli": serve_gnn_counted(art_dir, cli=True),
            "cpu": serve_gnn_counted(art_dir, device="cpu")}
    card_s = time.perf_counter() - t0
    cached = runs["cached"]
    checks = {}
    for name in ("uncached", "faults_2"):
        if not np.array_equal(runs[name]["logits"], cached["logits"]):
            raise AssertionError(f"serve_gnn {name}: logits are not the "
                                 f"cached run's, bit for bit")
        checks[f"{name}_bit_equal"] = True
    f2, f5 = runs["faults_2"]["report"], runs["faults_5"]["report"]
    if f2["fetch_failures"] != 0 or f2["fetch_retries"] != 2:
        raise AssertionError(f"2 injected faults: {f2}")
    if f5["fetch_failures"] <= 0:
        raise AssertionError(f"5 injected faults served no degraded row")
    checks["degraded_rows_at_5_faults"] = f5["fetch_failures"]
    counters_equal = ("requests", "cache", "remote_rows_fetched",
                      "fetch_failures", "fetch_retries")
    cpu = runs["cpu"]
    for k in counters_equal:
        if cpu["report"][k] != cached["report"][k]:
            raise AssertionError(f"serve_gnn card against CPU: {k} "
                                 f"{cached['report'][k]} on the card, "
                                 f"{cpu['report'][k]} on the CPU")
    share = float(np.abs(cached["logits"] - cpu["logits"]).max()
                  / np.abs(cpu["logits"]).max())
    if share > GNN_TOL:
        raise AssertionError(f"serve_gnn card against CPU: logits differ "
                             f"by {share} of the largest, above {GNN_TOL}")
    checks["card_vs_cpu"] = {"report_counters_equal": list(counters_equal),
                             "logits_max_err_share": share,
                             "tolerance": GNN_TOL}
    lines = {}
    for name, r in runs.items():
        rep = r["report"]
        req = max(r["spans_s"]["serve.request"], 1e-12)
        lines[name] = {
            "p50_ms": rep["p50_ms"], "p99_ms": rep["p99_ms"],
            "hit_rate": rep["cache"]["hit_rate"],
            "remote_rows_fetched": rep["remote_rows_fetched"],
            "fetch_failures": rep["fetch_failures"],
            "fetch_retries": rep["fetch_retries"],
            "wall_s": r["wall_s"], "spans_s": r["spans_s"],
            "span_shares": {k: v / req for k, v in r["spans_s"].items()
                            if k != "serve.request"},
            "spmm_launches": r["spmm_launches"],
            "spmm_launches_by_route": r["spmm_launches_by_route"]}
    report = cached["report"]
    return {"artifact": "the artifact phase's (k = 32, 4 hosts)",
            "num_vertices": report["num_vertices"],
            "num_edges": report["num_edges"], "k": report["k"],
            "requests": GNN_SERVE_REQUESTS,
            "roots_per_request": GNN_SERVE_ROOTS, "runs": lines,
            "checks": checks, "seconds": card_s,
            "spmm_launches": sum(r["spmm_launches"] for r in runs.values())}


#: the bound route's launch shapes --spmm-tune times, (SPMM_STEPS,
#: SPMM_WARPS, SPMM_MIN_BLOCKS): the shipped (4, 4, 8) first
SPMM_TUNE = ((4, 4, 8), (8, 8, 1), (4, 8, 1), (2, 4, 1), (2, 4, 10),
             (2, 2, 16), (1, 4, 8), (8, 4, 8))


def spmm_tune(scale: int, tmp: str) -> list:
    """The bound route rebuilt with -D overrides of its launch shape
    (``SPMM_TUNE``), each timed by CUDA events on ``gnn_aggregate``'s
    graph at D = 64 (two rounds, in turns, the previous route at both ends),
    with its registers and spills (ptxas) and its agreement with the plain
    version.  One line per shape."""
    import ctypes
    import torch
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.spmm import kernel, prepare_tiles, spmm, spmm_ref
    out_dir = os.path.join(tmp, "spmm_tune")
    os.makedirs(out_dir)
    procs = {}
    for shape in SPMM_TUNE:
        flags = [f"-D{k}={v}" for k, v in zip(
            ("SPMM_STEPS", "SPMM_WARPS", "SPMM_MIN_BLOCKS"), shape)]
        lib = os.path.join(out_dir, "spmm_%d_%d_%d.so" % shape)
        procs[shape] = (lib, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *flags, "-o",
             lib, str(kernel.SOURCE)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    shipped = kernel.library()
    libs, ptxas = {}, {}
    for shape, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {shape}:\n{log}")
        lib = ctypes.CDLL(path)
        for name in ("spmm_launch", "spmm_bound_launch"):
            getattr(lib, name).argtypes = getattr(shipped, name).argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[shape] = lib
        ptxas[shape] = [f for f in ptxas_report(log) if any(
            n in f["function"] for n in (
                "bound::spmm_kernel<float, float, int, 16, 1>",
                "bound11spmm_kernelIffiLi16ELi1E"))]
    path, _ = write_graph(scale, tmp)
    src, dst, N = relabelled_copies(np.fromfile(path, np.uint32)
                                    .reshape(-1, 2), GNN_COPIES, seed=0)
    prep = prepare_tiles(dst, N).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    src_d = torch.from_numpy(src).cuda()
    dst_d = torch.from_numpy(dst).cuda()
    h = torch.randn((N, GIN_D), generator=g, device="cuda")
    mask = (torch.rand(len(src), generator=g, device="cuda") < 0.99).float()
    bound_prep = prep.with_edges(src_d, mask, num_rows=N)
    want = spmm_ref(h, src_d, dst_d, mask, N)
    scale_y = spmm_ref(h.abs(), src_d, dst_d, mask, N)
    library = kernel.library
    ms = {shape: [] for shape in libs}
    agree = {}
    try:
        previous = [cuda_time_ms(lambda: spmm(h, src_d, mask, prep), 6, 1)]
        for order in (list(libs), list(libs)[::-1]):
            for shape in order:
                kernel.library = lambda lib=libs[shape]: lib
                ms[shape].append(cuda_time_ms(
                    lambda: spmm(h, src_d, mask, bound_prep), 6, 1))
                agree.setdefault(shape, sum_agree(
                    spmm(h, src_d, mask, bound_prep), want, scale_y))
        kernel.library = library
        previous.append(cuda_time_ms(lambda: spmm(h, src_d, mask, prep), 6,
                                     1))
    finally:
        kernel.library = library
    return [{"steps": k, "warps": w, "min_blocks": b, "ms": ms[(k, w, b)],
             "ptxas": ptxas[(k, w, b)], **agree[(k, w, b)]}
            for k, w, b in libs] + [{"previous_ms": previous}]


def sector_bytes(table, idx, block: int = 32) -> int:
    """The bytes of the ``block``-byte blocks (32: the L2's sectors) that
    the rows of ``idx`` (JAX's wrap-then-clamp rule) span in ``table``, a
    row per lookup."""
    from repro_torch.kernels import wrap_clamp_index
    row = table.shape[1] * table.element_size()
    start = (wrap_clamp_index(idx, table.shape[0]) * row
             + table.data_ptr() % block)
    return int(((start + row - 1) // block - start // block + 1).sum()
               ) * block


def bag_pool() -> dict:
    """``embedding_bag`` over DIEN's 2,097,152 x 18 float32 item table
    (seeded ``torch.Generator``), batches of ``InteractionStream`` (seq
    100, seed 0) of ``serve_p99`` (512) and ``BULK_BATCH`` rows with
    ``hist`` as the indices and ``hist_mask`` as the weights, in ``sum``
    and ``mean``: one warm-up and three calls each,
    exactly one launch per call; then the last output against the plain
    version, and the kernel and the previous design (CUDA-graph replays),
    the plain version and, for ``sum``, ``F.embedding_bag`` timed on the
    same inputs; bounds on the touched rows, on a row per lookup, and on
    the 32-byte sectors (and 64-byte blocks) each lookup's row spans."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.data import InteractionStream
    from repro_torch.kernels.embedding_bag import (embedding_bag,
                                                   embedding_bag_ref)
    from repro_torch.kernels.embedding_bag import kernel as eb_kernel
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
            prev_out = torch.empty_like(out)
            runs[f"{B}_{mode}"] = {
                "B": B, "L": L, "D": D, "mode": mode, "calls_ms": ms,
                "ms_per_call": float(np.median(ms[1:])), "launches": n,
                "touched_rows": touched, **agree,
                "ms": graph_ms(op, calls=20),
                "previous_ms": graph_ms(lambda: eb_kernel.launch_previous(
                    table, idx, w, mean=mode == "mean", out=prev_out),
                    calls=20),
                "ms_source": "CUDA events over CUDA-graph replays of 20 "
                             "calls, the previous design beside",
                "batched_ms": batched_ms(op),
                "batched_source": "CUDA events over 50 back-to-back calls "
                                  "(the host's launches included)",
                "plain_ms": batched_ms(plain),
                "plain_ms_source": "CUDA events over 50 back-to-back calls",
                **bound(touched * D * 4 + rest, 2 * B * L * D),
                "gathered_bound_ms": bound(B * L * D * 4 + rest,
                                           2 * B * L * D)["bound_ms"],
                "sector_bound_ms": bound(sector_bytes(table, idx) + rest,
                                         2 * B * L * D)["bound_ms"],
                "block64_bound_ms": bound(
                    sector_bytes(table, idx, 64) + rest,
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
    scale_cpu = spmm_ref(x.abs(), src_t, torch.from_numpy(dst), w, N)
    card_prep = prep.to("cuda")
    x_c, src_c, w_c = x.cuda(), src_t.cuda(), w.cuda()
    gnn = {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0), "
                    f"relabelled (seed 1)", "nodes": N, "edges": len(src),
           "D": GIN_D, "cpu_s": cpu_s}
    for route, p in (("perm", card_prep),
                     ("bound", card_prep.with_edges(src_c, w_c,
                                                    num_rows=N))):
        on_card, counts, _ = counted(
            lambda: spmm_route(lambda: spmm(x_c, src_c, w_c, p), route,
                               "spmm on the card").cpu())
        expect_launches(counts, {"spmm": 1}, f"spmm on the card, {route}")
        gnn[route] = sum_agree(on_card, on_cpu, scale_cpu)
    gnn["ok"] = gnn["perm"]["ok"] and gnn["bound"]["ok"]
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
    the run's wall time (us).  Only the card's activity is recorded, and
    its raw records are read: recording the host's operations too, and
    building the profiler's event tree, cost ~0.5 ms a kernel, more than
    the runs being profiled."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            entry = by_name.setdefault(e.name(), [0.0, 0])
            entry[0] += (e.end_ns() - e.start_ns()) / 1e3
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
                busy_edges: int | None = None, **overrides) -> dict:
    """The same run (``spec_for(name, **overrides)``) on the card and on
    the CPU, byte-equal; then the card's busy share in a profiled run over
    the first ``busy_edges`` edges (all when None: profiling every launch
    of a long micro-batch loop costs more than the run)."""
    from repro_torch.core import InMemoryEdgeStream, run_spec, spec_for
    from repro_torch.data import rmat_graph
    edges = rmat_graph(scale, edge_factor=16, seed=0)
    spec = spec_for(name, **overrides)
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
    return {"algorithm": name, "overrides": overrides,
            "chunk_size": spec.chunk_size,
            "busy_share_edges": len(window),
            "device_kernels_profiled": n_kernels,
            "graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": len(edges), "k": k, "assignment_mismatches": mism,
            "replication_factor": a.quality.replication_factor,
            "balance": a.quality.balance, **out,
            "device_busy_share_profiled": busy if busy is not None
            else "not measured"}


def artifact_card_vs_cpu(scale: int, k: int = 32, hosts: int = 4) -> dict:
    """Host-aware 2PS-L through the CLI with ``--artifact-dir
    --local-graphs`` on the card and on the CPU: every sidecar byte-equal,
    the manifests equal but for the timings, the stall report and the
    route; then a run checkpointing every 3 chunks on each device, their
    latest checkpoints (inside the scoring pass) equal array for array,
    and the card's resumed on the CPU and the CPU's on the card, both to
    the uninterrupted bytes."""
    from repro_torch.core import MemmapEdgeStream, run_spec, spec_for
    from repro_torch.robust import load_engine_checkpoint
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path, E = write_graph(scale, tmp)
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            run_cli(["--input", path, "--k", str(k), "--hosts", str(hosts),
                     "--dcn-penalty", "1.0", "--local-graphs",
                     "--artifact-dir", os.path.join(tmp, dev),
                     "--device", dev])
            out[f"artifact_{dev}_wall_s"] = time.perf_counter() - t0
        files = sorted(os.listdir(os.path.join(tmp, "cuda")))
        if files != sorted(os.listdir(os.path.join(tmp, "cpu"))):
            raise AssertionError("card and CPU artifacts hold other files")
        for name in files:
            if name == "manifest.json":
                continue
            if (_sha256(os.path.join(tmp, "cuda", name))
                    != _sha256(os.path.join(tmp, "cpu", name))):
                raise AssertionError(f"card vs cpu: {name} differs")
        manifests = []
        for dev in ("cuda", "cpu"):
            with open(os.path.join(tmp, dev, "manifest.json")) as f:
                m = json.load(f)
            m.pop("timings_s")
            m.pop("stall_report")
            m["extras"].pop("kernel_backend")
            manifests.append(m)
        if manifests[0] != manifests[1]:
            raise AssertionError("card vs cpu: the manifests differ")
        out["artifact_files_byte_equal"] = len(files) - 1

        # 16,384-edge chunks: at RMAT-14 fourteen a pass, so the latest
        # checkpoint (every 3) sits inside the scoring pass
        spec = spec_for("2psl", chunk_size=1 << 14, host_groups=hosts,
                        dcn_penalty=1.0)
        runs = {}
        for dev in ("cuda", "cpu"):
            runs[dev] = run_spec(
                spec, MemmapEdgeStream(path), k, device=dev,
                checkpoint_every_chunks=3,
                checkpoint_dir=os.path.join(tmp, f"ck_{dev}"))
        cks = {dev: load_engine_checkpoint(os.path.join(tmp, f"ck_{dev}"))
               for dev in runs}
        a, b = cks["cuda"], cks["cpu"]
        if a.meta != b.meta or a.meta["pass_index"] != 1:
            raise AssertionError(f"checkpoint meta {a.meta} vs {b.meta}")
        for group in ("device_state", "host_state"):
            ga, gb = getattr(a, group), getattr(b, group)
            if sorted(ga) != sorted(gb) or any(
                    ga[key].dtype != gb[key].dtype
                    or ga[key].tobytes() != gb[key].tobytes()
                    for key in ga):
                raise AssertionError(f"card vs cpu checkpoint: {group}")
        clean = runs["cpu"].assignment.tobytes()
        if runs["cuda"].assignment.tobytes() != clean:
            raise AssertionError("checkpointed card run differs")
        for src, dev in (("cuda", "cpu"), ("cpu", "cuda")):
            res = run_spec(spec, MemmapEdgeStream(path), k, device=dev,
                           resume_from=os.path.join(tmp, f"ck_{src}"))
            if res.assignment.tobytes() != clean:
                raise AssertionError(f"{src} checkpoint resumed on {dev} "
                                     f"differs")
        card = runs["cuda"]
        out.update({
            "graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
            "edges": E, "k": k, "hosts": hosts,
            "checkpoint_cut": {key: a.meta[key] for key in
                               ("pass_index", "next_chunk", "edge_lo")},
            "checkpoint_arrays_equal": len(a.device_state)
            + len(a.host_state),
            "card_checkpoints": card.extras["checkpoints_written"],
            "card_checkpoint_s_per_save":
                card.timings["checkpoint"]
                / card.extras["checkpoints_written"],
            "resumed_both_ways_byte_equal": True})
    return out


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


def chunk_device_ops(scale: int, k: int = 32, chunk: int = 1 << 16) -> dict:
    """Device operations of one 2PS-L scoring chunk (``_score_chunk``, and
    ``_score_chunk_hosted`` with 4 hosts) on the card, as torch.profiler
    records them (kernels, copies and fills), over the graph's first
    ``chunk`` edges on random tables, through ``edge_score_choose_bits``
    and through the previous composition (``previous_twopsl_choose``).
    The capacity is loose, so the least-loaded rounds never run."""
    import torch
    import repro_torch.core.partitioning as P
    from repro_torch.core import bitops
    from repro_torch.data import rmat_graph
    from repro_torch.kernels.edge_score import ops as es_ops
    edges = rmat_graph(scale, edge_factor=16, seed=0)[:chunk]
    V = int(edges.max()) + 1
    pc = P.pad_chunk(edges, chunk, "cuda")
    rng = np.random.default_rng(0)

    def table(hi, n=V):
        return torch.from_numpy(
            rng.integers(0, hi, n).astype(np.int32)).cuda()
    d, v2c, vol, c2p = table(5000), table(V // 4), table(200_000), table(k)
    host_of = torch.arange(k, dtype=torch.int32, device="cuda") // (k // 4)
    bits = torch.zeros((V, bitops.num_words(k)), dtype=torch.int32,
                       device="cuda")
    hbits = torch.zeros((V, 1), dtype=torch.int32, device="cuda")
    sizes = torch.zeros(k, dtype=torch.int32, device="cuda")
    cap = 1 << 30
    out = {}
    for hosted in (False, True):
        def run():
            if hosted:
                return P._score_chunk_hosted(
                    bits, hbits, sizes, d, vol, v2c, c2p, host_of, pc.edges,
                    pc.valid, k=k, cap=cap, dcn_penalty=1.0)
            return P._score_chunk(bits, sizes, d, vol, v2c, c2p, pc.edges,
                                  pc.valid, k=k, cap=cap)
        for name, fn in (("bits_entry", es_ops.edge_score_choose_bits),
                         ("previous", previous_twopsl_choose)):
            original = es_ops.edge_score_choose_bits
            es_ops.edge_score_choose_bits = fn
            try:
                run()
                torch.cuda.synchronize()
                by_name, _ = profile_kernels(run)
            finally:
                es_ops.edge_score_choose_bits = original
            out[f"{name}_{'hosted' if hosted else 'flat'}"] = sum(
                c for _, c in by_name.values())
    return {"edges": chunk, "device_ops_per_chunk": out,
            "fewer_flat": out["previous_flat"] - out["bits_entry_flat"],
            "fewer_hosted": out["previous_hosted"]
            - out["bits_entry_hosted"]}


def scoring_loop_s(scale: int, k: int = 32, pairs: int = 5,
                   chunk: int = 1 << 16) -> dict:
    """Host seconds of 2PS-L's scoring chunks alone: every chunk of the
    graph (uploaded once) through ``_score_chunk`` (and
    ``_score_chunk_hosted`` with 4 hosts) on random tables, ending in a
    synchronize, through ``edge_score_choose_bits`` and through the
    previous composition, ``pairs`` times in the order new, previous,
    previous, new; without the engine's stream, pipeline and writeback,
    whose spread hides a pass's difference."""
    import torch
    import repro_torch.core.partitioning as P
    from repro_torch.core import bitops
    from repro_torch.data import rmat_graph
    from repro_torch.kernels.edge_score import ops as es_ops
    edges = rmat_graph(scale, edge_factor=16, seed=0)
    V = int(edges.max()) + 1
    chunks = [P.pad_chunk(edges[lo:lo + chunk], chunk, "cuda")
              for lo in range(0, len(edges), chunk)]
    rng = np.random.default_rng(1)

    def table(hi):
        return torch.from_numpy(
            rng.integers(0, hi, V).astype(np.int32)).cuda()
    d, v2c, vol, c2p = table(5000), table(V // 4), table(200_000), table(k)
    host_of = torch.arange(k, dtype=torch.int32, device="cuda") // (k // 4)
    bits = torch.zeros((V, bitops.num_words(k)), dtype=torch.int32,
                       device="cuda")
    hbits = torch.zeros((V, 1), dtype=torch.int32, device="cuda")
    sizes = torch.zeros(k, dtype=torch.int32, device="cuda")
    cap = 1 << 30
    new = es_ops.edge_score_choose_bits
    out = {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
           "chunks": len(chunks)}
    for hosted in (False, True):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for pc in chunks:
                if hosted:
                    P._score_chunk_hosted(
                        bits, hbits, sizes, d, vol, v2c, c2p, host_of,
                        pc.edges, pc.valid, k=k, cap=cap, dcn_penalty=1.0)
                else:
                    P._score_chunk(bits, sizes, d, vol, v2c, c2p, pc.edges,
                                   pc.valid, k=k, cap=cap)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        times = {"new": [], "previous": []}
        try:
            run()                                   # warm-up
            for _ in range(pairs):
                for variant in ("new", "previous", "previous", "new"):
                    es_ops.edge_score_choose_bits = (
                        new if variant == "new" else previous_twopsl_choose)
                    times[variant].append(run())
        finally:
            es_ops.edge_score_choose_bits = new
        med = {v: float(np.median(t)) for v, t in times.items()}
        out["hosted" if hosted else "flat"] = {
            "s_new": times["new"], "s_previous": times["previous"],
            "median_change": med["new"] / med["previous"] - 1,
            "pairs": 2 * pairs,
            "pairs_new_faster": sum(a < b for a, b in zip(
                times["new"], times["previous"]))}
    return out


def twopsl_scoring(scale: int, k: int = 32) -> dict:
    """2PS-L's scoring pass (``timings_s["scoring"]``) through
    ``edge_score_choose_bits`` and with the previous composition swapped in
    (``previous_twopsl_choose``), flat and with 4 hosts (dcn_penalty 1.0),
    in the order new, previous, previous, new in one process; the
    assignments byte-equal; then the scoring chunks alone, 5 such rounds
    (``scoring_loop_s``), and the device operations per scoring chunk
    (``chunk_device_ops``)."""
    from repro_torch.core import InMemoryEdgeStream, run_spec, spec_for
    from repro_torch.data import rmat_graph
    from repro_torch.kernels.edge_score import ops as es_ops
    edges = rmat_graph(scale, edge_factor=16, seed=0)
    new = es_ops.edge_score_choose_bits
    out = {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0)",
           "edges": len(edges), "k": k}
    for name, spec in (("flat", spec_for("2psl")),
                       ("hosted", spec_for("2psl", host_groups=4,
                                           dcn_penalty=1.0))):
        times = {"new": [], "previous": []}
        walls = {"new": [], "previous": []}
        asg = {}
        try:
            for variant in ("new", "previous", "previous", "new"):
                es_ops.edge_score_choose_bits = (
                    new if variant == "new" else previous_twopsl_choose)
                t0 = time.perf_counter()
                res = run_spec(spec, InMemoryEdgeStream(edges), k,
                               device="cuda")
                walls[variant].append(time.perf_counter() - t0)
                times[variant].append(res.timings["scoring"])
                asg[variant] = res.assignment
        finally:
            es_ops.edge_score_choose_bits = new
        if not np.array_equal(asg["new"], asg["previous"]):
            raise AssertionError(f"2PS-L {name}: the previous composition "
                                 f"assigns otherwise")
        out[name] = {"scoring_s_new": times["new"],
                     "scoring_s_previous": times["previous"],
                     "scoring_change": sum(times["new"])
                     / sum(times["previous"]) - 1,
                     "wall_s_new": walls["new"],
                     "wall_s_previous": walls["previous"]}
    out["scoring_loop"] = scoring_loop_s(scale, k)
    out["chunk_device_ops"] = chunk_device_ops(scale, k)
    return out

# ---------------------------------------------------------------------------
# training: the backward kernels of flash_attention, augru and spmm
# ---------------------------------------------------------------------------

#: a float32 gradient of a backward kernel within this share of the plain
#: backward's largest magnitude, by kernel (flash attention's float32 sums
#: in another order, with the cancellation in dp - delta; augru's and
#: spmm's as their forwards'); bf16 flash gradients elementwise within
#: ``ops.bf16_gradient_bound``
GRAD_TOL = {"flash_attention": 1e-4, "augru": 1e-5}

#: flash attention's backward cases: the CPU tests' (GQA 1:1, 2:1, 12:1,
#: Sq != Skv both ways, D 16 and 128, ragged S), D 256 (bf16 on the SIMT
#: route) and an odd 33; the tensor-core route's padded and element-staged
#: widths (the LM smoke config's D 12, D 1, 64 with GQA 2:1 and B 3, 96
#: with Hq == Hkv and Sq > Skv); and starcoder2-3b's heads at 4,096 tokens
#: in the model's layout (v strided)
FLASH_BWD_CHECK = (
    (1, 2, 2, 16, 16, 16, True), (2, 4, 2, 19, 19, 16, True),
    (1, 12, 1, 33, 33, 16, True), (1, 4, 2, 5, 23, 16, True),
    (1, 4, 2, 21, 13, 16, False), (2, 4, 4, 17, 17, 16, False),
    (1, 4, 2, 37, 37, 128, True), (1, 24, 2, 9, 70, 128, True),
    (2, 8, 8, 100, 300, 256, True), (1, 4, 2, 70, 70, 33, False),
    (1, 4, 2, 64, 64, 12, True), (1, 2, 1, 130, 200, 1, True),
    (3, 6, 3, 129, 129, 64, False), (1, 4, 4, 200, 130, 96, False),
    (1, 24, 2, 4096, 4096, 128, True))
#: augru's backward cases on the planned route: the CPU tests' (T = 1 and
#: 100; H 24, 37, 112), H above what U in shared memory takes (160, 1000),
#: DIEN's serve rows and the recsys_train phase's rows
#: (``RECSYS_TRAIN_ROWS``, added there); ``augru_backward_cases`` adds the
#: tile route's edges on this card
AUGRU_BWD_CHECK = ((3, 1, 24), (2, 100, 24), (4, 7, 37), (2, 5, 112),
                   (1, 100, 37), (5, 9, 160), (2, 3, 1000), (512, 100, 108))


def grad_share(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def check_flash_backward(cases) -> dict:
    """``flash_attention_backward`` against ``gqa_attention_backward`` on the
    card, float32 and bf16, on the forward kernel's output: each float32
    gradient within ``GRAD_TOL``, each bf16 element within
    ``ops.bf16_gradient_bound`` of the plain backward evaluated in float32
    on the same bf16 operands; two launches bit-equal.  The 4,096-token case
    in the model's layout.  ``routes`` counts the calls by
    ``kernel.backward_route`` (bf16 at D <= 128 the tensor-core kernels,
    float32, and bf16 at D = 256, the SIMT ones)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        bf16_gradient_bound, flash_attention, flash_attention_backward,
        gqa_attention_backward, kernel)
    worst, worst_bf16, n, abs_err = 0.0, 0.0, 0, 0.0
    routes = {}
    for (B, Hq, Hkv, Sq, Skv, D, causal) in cases:
        for dtype in ("float32", "bfloat16"):
            q, k, v = flash_inputs(B, Hq, Hkv, Sq, Skv, D, dtype,
                                   seed=Sq + D, device="cuda",
                                   model_layout=Sq >= 4096)
            route = kernel.backward_route(q)
            routes[route] = routes.get(route, 0) + 1
            do = torch.randn(q.shape, device="cuda").to(q.dtype)
            with torch.no_grad():
                o = flash_attention(q, k, v, causal=causal)
            got = flash_attention_backward(q, k, v, o, do, causal=causal)
            again = flash_attention_backward(q, k, v, o, do, causal=causal)
            want = gqa_attention_backward(q.float(), k.float(), v.float(),
                                          o.float(), do.float(),
                                          causal=causal)
            torch.cuda.synchronize()
            for name, g, a, w in zip("qkv", got, again, want):
                what = case_str(B, Hq, Hkv, Sq, Skv, D, causal, dtype)
                if not torch.equal(g, a):
                    raise AssertionError(f"flash backward d{name}: two "
                                         f"launches differ at {what}")
                if dtype == "float32":
                    share = grad_share(g, w)
                    worst = max(worst, share)
                    abs_err = max(abs_err, float((g - w).abs().max()))
                    ok = share <= GRAD_TOL["flash_attention"]
                else:
                    ratio = float(((g.float() - w).abs()
                                   / bf16_gradient_bound(w)).max())
                    worst_bf16 = max(worst_bf16, ratio)
                    ok = ratio <= 1.0
                if not ok:
                    raise AssertionError(f"flash backward d{name} "
                                         f"disagrees at {what}")
            n += 1
            del q, k, v, do, o, got, again, want
    torch.cuda.empty_cache()
    return {"cases": n, "routes": routes, "max_abs_err": abs_err,
            "max_err_share_float32": worst,
            "max_err_over_bf16_bound": worst_bf16,
            "tolerance": f"float32 within {GRAD_TOL['flash_attention']} of "
                         f"each gradient's largest magnitude; bf16 "
                         f"elementwise within 2^-8 |plain| + 1e-4 max "
                         f"|plain| (ops.bf16_gradient_bound)",
            "bit_equal": True, "ok": True}


def case_str(*case) -> str:
    return "(" + ", ".join(map(str, case)) + ")"


def flash_backward_work(B, Hq, Hkv, Sq, Skv, D, causal, itemsize) -> tuple:
    """(bytes, operations) of one backward: q, k, v, o, do read once and
    dq, dk, dv written once; 10 D operations per visible (query, key) pair
    and head (S, dP, dV, dQ and dK, each two multiply-adds of D)."""
    nbytes, ops = flash_work(B, Hq, Hkv, Sq, Skv, D, causal, itemsize)
    nbytes = itemsize * D * (4 * B * Hq * Sq + 4 * B * Hkv * Skv)
    return nbytes, ops // 4 * 10


def previous_flash_backward(q, k, v, o, dout, *, causal: bool = True):
    """The previous bf16 backward design (the SIMT kernels) on
    ``flash_attention_backward``'s arguments, to time it beside the
    tensor-core design; no launch counter counts it."""
    import torch
    from repro_torch.kernels.flash_attention import kernel
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    kernel.launch_backward_previous(q, k, v, o, dout, dq=dq, dk=dk, dv=dv,
                                    causal=causal,
                                    scale=1.0 / (q.shape[-1] ** 0.5))
    return dq, dk, dv


def time_flash_backward(S: int = 4096, Hq: int = 24, Hkv: int = 2,
                        D: int = 128, previous: bool = False) -> dict:
    """starcoder2-3b's causal bf16 layer at ``S`` tokens in the model's
    layout: the backward kernels (their route, and the device time of each
    kernel in one profiled call), the previous design (the SIMT kernels'
    bf16 instantiation, with ``previous``), the plain backward and SDPA's
    flash backend's backward (GQA, causal; a yardstick of speed only, never
    on the port's path) timed between CUDA events on the same inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_backward, gqa_attention_backward,
        kernel)
    q, k, v = flash_inputs(1, Hq, Hkv, S, S, D, "bfloat16", seed=11,
                           device="cuda", model_layout=True)
    do = torch.randn(q.shape, device="cuda").to(q.dtype)
    with torch.no_grad():
        o = flash_attention(q, k, v)
    ms = cuda_time_ms(lambda: flash_attention_backward(q, k, v, o, do),
                      reps=10, warmup=2)
    split = kernel_breakdown(lambda: flash_attention_backward(q, k, v, o,
                                                              do), ms)
    previous_ms = (cuda_time_ms(lambda: previous_flash_backward(q, k, v, o,
                                                                do),
                                reps=3, warmup=1) if previous else None)
    plain_ms = cuda_time_ms(lambda: gqa_attention_backward(q, k, v, o, do),
                            reps=2, warmup=1)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                             enable_gqa=True)
        lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True), reps=10, warmup=2)
    nbytes, ops = flash_backward_work(1, Hq, Hkv, S, S, D, True, 2)
    route = kernel.backward_route(q)
    del q, k, v, do, o, out, ql, kl, vl
    torch.cuda.empty_cache()
    return {"shape": [1, Hq, Hkv, S, S, D], "causal": True,
            "dtype": "bfloat16", "model_layout": True, "route": route,
            "ms": ms, "kernels": split, "previous_ms": previous_ms,
            "speedup_over_previous": previous_ms and previous_ms / ms,
            "plain_ms": plain_ms, "ms_source": "cuda_events",
            "tflop_per_s": ops / ms / 1e9,
            "previous_tflop_per_s": previous_ms and ops / previous_ms / 1e9,
            "library_tflop_per_s": ops / lib_ms / 1e9,
            **bound(nbytes, ops, BF16_OPS_PER_S), "library_ms": lib_ms,
            "library": "torch.autograd.grad of torch.nn.functional."
                       "scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True), flash backend"}


def augru_backward_cases() -> tuple:
    """(B, T, H, forced route or None, att == 1) for
    ``check_augru_backward``: ``AUGRU_BWD_CHECK`` and ``RECSYS_TRAIN_ROWS``
    on the planned route with random attention, then the tile route's
    edges on this card (cheap: T of 2 or 3): the last B on the rows route
    and the first on the tile route, att == 1 there (the GRU stage), a
    ragged last tile and row group (B neither a multiple of the tile's
    rows nor of 8) at the edge and at the train rows; the tile route forced
    at H % 4 != 0 (37, 105), at H = 1, at the largest H it takes (128) and
    at DIEN's serve rows, and the rows route forced at the train rows."""
    from repro_torch.kernels.augru import kernel
    sms, _ = kernel.device_limits(0)
    first = kernel.BACKWARD_TILE_ROWS_PER_SM * sms
    return tuple((B, T, H, None, False) for B, T, H in AUGRU_BWD_CHECK
                 + ((RECSYS_TRAIN_ROWS, 100, 108),)) + (
        (first - 1, 3, 108, None, False), (first, 3, 108, None, False),
        (first, 3, 108, None, True), (first + 13, 2, 108, None, False),
        (RECSYS_TRAIN_ROWS - 5, 2, 108, None, True),
        (7, 20, 37, "tile", False), (50, 5, 105, "tile", True),
        (3, 4, 1, "tile", False), (9, 3, 128, "tile", False),
        (512, 100, 108, "tile", False),
        (RECSYS_TRAIN_ROWS, 3, 108, "rows", False))


def augru_backward_plan(route, B: int, H: int):
    """The plan of ``route`` at (B, H) on this card (None: the op's own)."""
    from repro_torch.kernels.augru import kernel
    limits = kernel.device_limits(0)
    if route is None:
        return kernel.backward_plan(B, H, *limits)
    if route == "tile":
        return kernel.backward_tile_plan(B, H, *limits)
    return kernel.backward_rows_plan(B, H, *limits)


def check_augru_backward(cases) -> dict:
    """``augru_backward`` against ``augru_backward_ref`` on the card for
    each (B, T, H, route, ones) of ``cases`` (``augru_backward_cases``):
    the planned route or the one forced (``use_plan``), random attention
    or att == 1; every gradient within ``GRAD_TOL`` of its largest
    magnitude, two launches bit-equal; each case's route reported, and
    both routes reached."""
    import torch
    from repro_torch.kernels.augru import (augru, augru_backward,
                                           augru_backward_ref)
    worst, abs_err, routes, reported = 0.0, 0.0, {}, []
    for (B, T, H, route, ones) in cases:
        p = augru_backward_plan(route, B, H)
        xg, u, att, h0 = augru_inputs(B, T, H, seed=B + H, ones=ones,
                                      device="cuda")
        do = torch.randn((B, T, H), device="cuda")
        with torch.no_grad():
            out = augru(xg, u, att, h0)
        got = augru_backward(xg, u, att, h0, out, do, use_plan=p)
        again = augru_backward(xg, u, att, h0, out, do, use_plan=p)
        want = augru_backward_ref(xg, u, att, h0, out, do)
        torch.cuda.synchronize()
        case_worst = 0.0
        for name, g, a, w in zip(("x_gates", "u", "att", "h0"), got, again,
                                 want):
            share = grad_share(g, w)
            case_worst = max(case_worst, share)
            abs_err = max(abs_err, float((g - w).abs().max()))
            if not torch.equal(g, a) or share > GRAD_TOL["augru"]:
                raise AssertionError(
                    f"augru backward d{name} at {(B, T, H)} on {p}: "
                    f"bit-equal {torch.equal(g, a)}, share {share}")
        worst = max(worst, case_worst)
        routes[p.route] = routes.get(p.route, 0) + 1
        reported.append({"shape": [B, T, H], "att_ones": ones,
                         "forced": route is not None, "route": p.route,
                         "groups": p.groups, "err_share": case_worst})
        del xg, u, att, h0, do, out, got, again, want
    torch.cuda.empty_cache()
    if set(routes) != {"tile", "rows"}:
        raise AssertionError(f"augru backward: routes reached {routes}")
    return {"cases": len(cases), "routes": routes, "by_case": reported,
            "max_abs_err": abs_err, "max_err_share": worst,
            "tolerance": f"within {GRAD_TOL['augru']} of each gradient's "
                         f"largest magnitude",
            "bit_equal": True, "ok": True}


def gru_backward_library_ms(B: int, T: int = 100, e: int = 18,
                            H: int = 108, reps: int = 5) -> float:
    """cuDNN's GRU backward (``torch.nn.GRU``, float32 without TF32) on
    (B, T, e), above ``GRU_MAX_BATCH`` rows as the sum of equal
    sub-batches of at most that many (the forward faults at 65,536): a
    yardstick of speed only, never of parity."""
    import torch
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gru = torch.nn.GRU(e, H, batch_first=True).cuda()
        split = -(-B // GRU_MAX_BATCH)
        total = 0.0
        for _ in range(split):
            x = torch.randn(B // split, T, e, device="cuda",
                            requires_grad=True)
            out, _ = gru(x)
            do = torch.randn_like(out)
            leaves = [x, *gru.parameters()]
            total += batched_ms(lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), reps, 1)
            del x, out, do, leaves
        return total
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def augru_backward_operands(B: int, T: int, H: int) -> tuple:
    """(x_gates, u, att, h0, out, dout) on the card: ``augru_inputs`` with
    random attention, the forward kernel's states and a random output
    gradient."""
    import torch
    from repro_torch.kernels.augru import augru
    xg, u, att, h0 = augru_inputs(B, T, H, seed=5, ones=False,
                                  device="cuda")
    do = torch.randn((B, T, H), device="cuda")
    with torch.no_grad():
        out = augru(xg, u, att, h0)
    return xg, u, att, h0, out, do


def augru_backward_outputs(B: int, T: int, H: int) -> dict:
    """The backward kernel's outputs, allocated on the card."""
    import torch
    return dict(dx_gates=torch.empty((B, T, 3 * H), device="cuda"),
                dhu_n=torch.empty((B, T, H), device="cuda"),
                datt=torch.empty((B, T), device="cuda"),
                dh0=torch.empty((B, H), device="cuda"))


def augru_backward_kernel_ms(args, p, reps: int) -> float:
    """The backward kernel alone on plan ``p``: ``reps`` back-to-back
    ``kernel.launch_backward`` calls between CUDA events."""
    from repro_torch.kernels.augru import kernel
    outs = augru_backward_outputs(*args[4].shape)
    return batched_ms(lambda: kernel.launch_backward(*args, **outs,
                                                     use_plan=p), reps, 1)


def time_augru_backward(B: int, T: int = 100, H: int = 108,
                        reps: int = 20, previous: bool = False) -> dict:
    """The op (the backward kernel and ``du``'s product, as autograd runs
    it), the kernel alone and ``du``'s product alone on the planned route,
    the plain backward and cuDNN's GRU backward at (B, T, H), back to back
    between CUDA events; with ``previous`` the previous design (the rows
    route, forced) on the same inputs, the op and the kernel alone, in
    turns with the planned route (planned, previous, previous, planned)."""
    import torch
    from repro_torch.kernels.augru import (augru_backward,
                                           augru_backward_ref, du_product,
                                           kernel)
    args = augru_backward_operands(B, T, H)
    plan = augru_backward_plan(None, B, H)
    res = {"shape": [B, T, H], "route": plan.route, "plan": plan._asdict()}
    res["ms"] = batched_ms(lambda: augru_backward(*args), reps, 2)
    res["kernel_ms"] = augru_backward_kernel_ms(args, plan, reps)
    outs = augru_backward_outputs(B, T, H)
    kernel.launch_backward(*args, **outs, use_plan=plan)
    res["du_ms"] = batched_ms(lambda: du_product(
        args[3], args[4], outs["dx_gates"], outs["dhu_n"]), reps, 2)
    del outs
    if previous:
        prev = augru_backward_plan("rows", B, H)
        res["previous_plan"] = prev._asdict()
        res["previous_ms"] = batched_ms(
            lambda: augru_backward(*args, use_plan=prev), reps, 1)
        res["previous_kernel_ms"] = augru_backward_kernel_ms(args, prev,
                                                             reps)
        res["ms_again"] = batched_ms(lambda: augru_backward(*args), reps, 1)
        res["speedup_over_previous"] = res["previous_ms"] / res["ms"]
    res["plain_ms"] = cuda_time_ms(lambda: augru_backward_ref(*args), 2, 1)
    del args
    torch.cuda.empty_cache()
    lib_ms = gru_backward_library_ms(B, T, H=H)
    # bytes: x_gates, out, dout, att, h0, u read once; dx_gates, dhU_n,
    # datt, dh0, du written once.  Operations: per (row, step) hU (2 H 3H)
    # and dhU U^T (2 3H H) in the kernel, du's share (2 H 3H) after it
    nbytes = 4 * (B * T * (3 * H + 2 * H + 1) + B * H + 3 * H * H
                  + B * T * (3 * H + H + 1) + B * H + 3 * H * H)
    kernel_bytes = nbytes - 4 * 3 * H * H
    kernel_bound = bound(kernel_bytes, 12 * B * T * H * H)
    return {**res, "ms_source": "cuda_events (batched_ms)",
            **bound(nbytes, 18 * B * T * H * H),
            "kernel_bound_ms": kernel_bound["bound_ms"],
            "kernel_bound_by": kernel_bound["bound_by"],
            "du_bound_ms": bound(4 * (B * T * 4 * H + 3 * H * H),
                                 6 * B * T * H * H)["bound_ms"],
            "library_ms": lib_ms,
            "library": "torch.autograd.grad of torch.nn.GRU(18, 108), "
                       "cuDNN, TF32 off"}


def time_augru_backward_edge(rows_per_sm=(4, 8, 12, 16, 24, 32, 48, 64),
                             T: int = 100, H: int = 108, reps: int = 3,
                             groups=(1, 2, 3, 4, 5, 6)) -> dict:
    """The backward kernel alone on both routes at B = ``rows_per_sm`` x
    the card's SMs, where ``kernel.backward_plan`` switches from the rows
    route to the tile route at ``kernel.BACKWARD_TILE_ROWS_PER_SM``, and the
    tile route at each count of 8-row groups a tile at
    ``RECSYS_TRAIN_ROWS``: back to back between CUDA events, beside the
    plan's choice."""
    import torch
    from repro_torch.kernels.augru import kernel
    sms, smem = kernel.device_limits(0)
    res = {"sms": sms,
           "tile_rows_per_sm": kernel.BACKWARD_TILE_ROWS_PER_SM}
    for n in rows_per_sm:
        B = n * sms
        args = augru_backward_operands(B, T, H)
        plans = {"rows": kernel.backward_rows_plan(B, H, sms, smem),
                 "tile": kernel.backward_tile_plan(B, H, sms, smem)}
        res[str(n)] = {"B": B, "plan": kernel.backward_plan(
            B, H, sms, smem).route, "tile_groups": plans["tile"].groups, **{
            f"{name}_ms": augru_backward_kernel_ms(args, p, reps)
            for name, p in plans.items()}}
        del args
    B = RECSYS_TRAIN_ROWS
    args = augru_backward_operands(B, T, H)
    chosen = kernel.backward_tile_plan(B, H, sms, smem)
    ug = -(-H // kernel.BACKWARD_TILE_UNITS)
    sweep = {}
    for g in groups:
        rows = kernel.BACKWARD_TILE_ROWS * g
        if kernel.backward_tile_smem(H, rows) > smem:
            continue
        p = kernel.BackwardPlan("tile", rows, min(sms, -(-B // rows)),
                                32 * (-(-ug * g // 32)), g)
        sweep[str(g)] = augru_backward_kernel_ms(args, p, reps)
    res["tile_groups_at_train_rows"] = {"B": B, "plan_groups": chosen.groups,
                                        "kernel_ms_by_groups": sweep}
    del args
    torch.cuda.empty_cache()
    return res


def check_spmm_backward(D: int, *, N: int = 65_536, E: int = 1 << 20) -> dict:
    """``spmm``'s backward on the card on a random graph (wrapped and
    clamped src, isolated rows), weighted and not: the forward on the bound
    route (the reverse built once, ``with_reverse``) and on perm (the
    reverse built for the call), each gradient one ``spmm`` launch on the
    bound route, held to the gradient written from its definition
    (``index_add_`` of w * G[dst] into the wrapped in-range src) within
    ``SUM_TOL``; two launches bit-equal."""
    import torch
    from repro_torch.kernels.spmm import launches, prepare_tiles, spmm
    rng = np.random.default_rng(D)
    dst = rng.integers(0, N - 100, E)
    src = rng.integers(-N - 50, N + 50, E).astype(np.int32)
    src_d = torch.from_numpy(src).cuda()
    dst_d = torch.from_numpy(dst).cuda()
    wrapped = torch.where(src_d < 0, src_d + N, src_d).long()
    keep = (wrapped >= 0) & (wrapped < N)
    host = prepare_tiles(dst, N)
    out = {}
    for weighted in (True, False):
        w = (torch.rand(E, device="cuda") if weighted else None)
        preps = {"bound": host.to("cuda").with_edges(src_d, w, num_rows=N)
                 .with_reverse(src_d),
                 "perm": host.to("cuda")}
        x = torch.randn((N, D), device="cuda", requires_grad=True)
        g = torch.randn((N, D), device="cuda")
        ww = torch.ones(E, device="cuda") if w is None else w
        sel = keep.nonzero().flatten()
        want = torch.zeros((N, D), device="cuda").index_add_(
            0, wrapped[sel], (ww[:, None] * g[dst_d])[sel])
        scale = torch.zeros((N, D), device="cuda").index_add_(
            0, wrapped[sel], (ww[:, None] * g[dst_d]).abs()[sel])
        for route, prep in preps.items():
            y = spmm(x, src_d, w, prep)
            launches.reset()
            (got,) = torch.autograd.grad(y, x, g, retain_graph=True)
            by = dict(launches.by_route)
            (again,) = torch.autograd.grad(y, x, g)
            agree = sum_agree(got, want, scale)
            if (by != {"bound": 1, "perm": 0} or not torch.equal(got, again)
                    or not agree["ok"]):
                raise AssertionError(f"spmm backward at D={D}, weighted "
                                     f"{weighted}, forward on {route}: "
                                     f"launches {by}, {agree}")
            out[f"{'weighted' if weighted else 'unweighted'}_{route}"] = agree
    return {"D": D, "nodes": N, "edges": E, "tolerance": SUM_TOL,
            "cases": out, "bit_equal": True,
            "max_abs_err": max(c["max_abs_err"] for c in out.values()),
            "ok": True}


# ---------------------------------------------------------------------------
# training: the train phases (LM, DIEN, GNN, the train CLI)
# ---------------------------------------------------------------------------

#: the LM's card-against-CPU gate: the loss and every gradient within this
#: share of the CPU's largest magnitude (as the prefill's logits)
LM_TRAIN_TOL = 1e-3
#: DIEN's and the GNNs' card-against-CPU gate, the same way
TRAIN_TOL = 1e-4
#: train_4k's sequence, its batch cut from 256 to 4: the config's 4
#: microbatches of 1
LM_TRAIN_SEQ, LM_TRAIN_BATCH = 4096, 4
#: DIEN's train rows (train_batch's 65,536, not cut: the step's peak fits)
RECSYS_TRAIN_ROWS = 65_536
#: timed steps after one warm-up
TRAIN_STEPS = 3


def loss_and_grads(loss_fn, params, batch) -> tuple:
    """(loss, gradients in ``tree_leaves`` order) of ``loss_fn(params,
    batch)`` (``training.value_and_grad``), the parameters untouched."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.training import value_and_grad
    loss, grads = value_and_grad(loss_fn, params, batch)
    return loss, tree_leaves(grads)


def leaf_shares(card, cpu) -> tuple:
    """(the loss's relative error, each gradient leaf's largest error as a
    share of its largest CPU magnitude, floored at 1e-2 of the tree's
    largest: a leaf whose gradient vanishes analytically, a bias just
    before a batch norm, holds float32 noise alone, ~1e-9 of the largest),
    card against CPU."""
    import torch
    (l_card, g_card), (l_cpu, g_cpu) = card, cpu
    loss_err = abs(float(l_card) - float(l_cpu)) / max(abs(float(l_cpu)),
                                                       1e-30)
    top = max(float(g.abs().max()) for g in g_cpu if g.numel())
    shares = []
    for a, b in zip(g_card, g_cpu):
        a = a.cpu()
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"a card gradient {tuple(a.shape)} not "
                                 f"finite or not of shape {tuple(b.shape)}")
        scale = max(float(b.abs().max()) if b.numel() else 0.0, 1e-2 * top,
                    1e-30)
        shares.append(float((a.double() - b.double()).abs().max()) / scale
                      if b.numel() else 0.0)
    return loss_err, shares


def grads_agree(card, cpu, tol: float) -> dict:
    """The loss within ``tol`` relative and every gradient leaf within
    ``tol`` of its largest magnitude (``leaf_shares``), card against
    CPU."""
    loss_err, shares = leaf_shares(card, cpu)
    line = {"loss_rel_err": loss_err, "max_grad_err_share": max(shares),
            "tolerance": tol,
            "ok": loss_err <= tol and max(shares) <= tol}
    if not line["ok"]:
        raise AssertionError(f"train card against CPU: {line}")
    return line


def train_steps(step, state, batch, n: int, expect: dict, what: str,
                by_route: dict | None = None) -> tuple:
    """``n`` train steps on ``batch``, each with every counter reset just
    before and read just after (exactly ``expect``, nothing else; ``spmm``
    by route where ``by_route`` names it), timed on the host clock to a
    synchronize; (losses, ms per step, launches summed by kernel)."""
    import torch
    losses, ms, total = [], [], {}
    for _ in range(n):
        def one():
            t0 = time.perf_counter()
            _, m = step(state, batch)
            torch.cuda.synchronize()
            return m, time.perf_counter() - t0
        (m, secs), counts, _ = counted(one)
        expect_launches(counts, expect, what)
        if by_route is not None:
            got = dict(counters()["spmm"].by_route)
            if got != by_route:
                raise AssertionError(f"{what}: spmm by route {got}, "
                                     f"expected {by_route}")
        loss = float(m["loss"])
        if not np.isfinite(loss):
            raise AssertionError(f"{what}: loss {loss}")
        losses.append(loss)
        ms.append(secs * 1e3)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return losses, ms, {k: v for k, v in total.items() if v}


def step_breakdown(fn, step_ms: float, top: int = 8) -> dict:
    """One profiled run of ``fn`` (a train step, or one microbatch's
    forward and backward): the device time its kernels took, its share of
    ``step_ms`` (the unprofiled time of the same work), the number of
    kernels and the ``top`` kernels by device time (ms)."""
    by_name, wall_us = profile_kernels(fn)
    busy = sum(us for us, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / step_ms if busy
            else "not measured",
            "profiled_wall_ms": wall_us / 1e3,
            "kernels": sum(n for _, n in by_name.values()),
            "top_kernels_ms": {k[:80]: us / 1e3 for k, (us, _) in ranked}}


def lm_train() -> dict:
    """starcoder2-3b at full width and depth (30 layers, bf16, remat
    "full") through ``make_lm_train_step`` on train_4k's 4,096 tokens, 4
    sequences as the config's 4 microbatches of 1: a warm-up and
    ``TRAIN_STEPS`` timed steps, each exactly 2 ``flash_attention``
    forwards (the forward and the recomputation) and 1 backward per layer
    and microbatch; then card against CPU in float32 on 2 layers and (1,
    512) tokens."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    spec = get_arch(LM_ARCH)
    cfg = spec.make_config()
    mb = spec.shapes["train_4k"]["microbatches"]
    t0 = time.perf_counter()
    state = S.init_state("lm", cfg, torch.Generator(device="cuda")
                         .manual_seed(0))
    init_s = time.perf_counter() - t0
    step = S.make_lm_train_step(cfg, microbatches=mb)
    raw = TokenStream(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ,
                      seed=0).next_batch()
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    forwards = 1 if cfg.remat == "none" else 2   # the recomputation
    per_step = {"flash_attention": forwards * cfg.n_layers * mb,
                "flash_attention_backward": cfg.n_layers * mb}
    torch.cuda.reset_peak_memory_stats()
    warm, warm_ms, _ = train_steps(step, state, batch, 1, per_step,
                                   "starcoder2-3b train step (warm-up)")
    losses, ms, launches = train_steps(step, state, batch, TRAIN_STEPS,
                                       per_step, "starcoder2-3b train step")
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    # one microbatch's forward and backward, profiled (a quarter step but
    # the optimizer update)
    one = {k: v[:1] for k, v in batch.items()}
    breakdown = step_breakdown(lambda: loss_and_grads(
        S.lm_loss_fn(cfg), state["params"], one),
        float(np.median(ms)) / mb)
    del state, step, batch
    torch.cuda.empty_cache()
    step_ms = float(np.median(ms))
    # card against CPU: float32, 2 layers, (1, 512)
    small = dataclasses.replace(cfg, dtype="float32", n_layers=2)
    params = T.init_params(small, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (1, 513))
    b = {"tokens": torch.from_numpy(toks[:, :-1]),
         "targets": torch.from_numpy(toks[:, 1:])}
    loss_fn = S.lm_loss_fn(small)
    t0 = time.perf_counter()
    cpu = loss_and_grads(loss_fn, params, b)
    cpu_s = time.perf_counter() - t0
    card = loss_and_grads(loss_fn, T.params_to(params, "cuda"),
                          {k: v.cuda() for k, v in b.items()})
    agree = grads_agree(card, cpu, LM_TRAIN_TOL)
    del params, card, cpu
    torch.cuda.empty_cache()
    return {"config": {"arch": LM_ARCH, "layers": cfg.n_layers,
                       "dtype": cfg.dtype, "remat": cfg.remat,
                       "parameters": n_params},
            "batch": [LM_TRAIN_BATCH, LM_TRAIN_SEQ], "microbatches": mb,
            "init_s": init_s, "warmup_ms": warm_ms[0],
            "first_loss": warm[0], "losses": losses, "step_ms": ms,
            "ms_per_step": step_ms,
            "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / step_ms * 1e3,
            "peak_device_bytes": peak, "launches": launches,
            "launches_per_step": per_step,
            "microbatch_breakdown": breakdown,
            "card_vs_cpu": {"layers": 2, "dtype": "float32",
                            "shape": [1, 512], "cpu_s": cpu_s, **agree}}


def recsys_train(rows: int = RECSYS_TRAIN_ROWS, check_rows: int = 512) -> dict:
    """DIEN at full width (2,097,152 x 18 items) through
    ``make_recsys_train_step`` on ``rows`` ``InteractionStream`` rows: a
    warm-up and ``TRAIN_STEPS`` steps, each exactly 2 ``augru`` forwards
    and 2 backwards; then card against CPU on ``check_rows`` rows."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import InteractionStream
    from repro_torch.launch import steps as S
    from repro_torch.models import recsys as R
    cfg = get_arch("dien").make_config()
    state = S.init_state("recsys", cfg, torch.Generator(device="cuda")
                         .manual_seed(0))
    step = S.make_recsys_train_step(cfg)
    stream = InteractionStream(cfg.n_items, rows, cfg.seq_len, seed=0)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in stream.next_batch().items()}
    per_step = {"augru": 2, "augru_backward": 2}
    torch.cuda.reset_peak_memory_stats()
    warm, warm_ms, _ = train_steps(step, state, batch, 1, per_step,
                                   "DIEN train step (warm-up)")
    losses, ms, launches = train_steps(step, state, batch, TRAIN_STEPS,
                                       per_step, "DIEN train step")
    peak = torch.cuda.max_memory_allocated()
    breakdown = step_breakdown(lambda: step(state, batch),
                               float(np.median(ms)))
    del state, step, batch
    torch.cuda.empty_cache()
    params = R.dien_init(cfg, torch.Generator().manual_seed(1))
    b = {k: torch.from_numpy(v) for k, v in InteractionStream(
        cfg.n_items, check_rows, cfg.seq_len, seed=1).next_batch().items()}
    loss_fn = lambda p, bb: R.dien_loss(cfg, p, bb)   # noqa: E731
    cpu = loss_and_grads(loss_fn, params, b)
    card = loss_and_grads(loss_fn, R.params_to(params, "cuda"),
                          {k: v.cuda() for k, v in b.items()})
    agree = grads_agree(card, cpu, TRAIN_TOL)
    step_ms = float(np.median(ms))
    return {"rows": rows, "warmup_ms": warm_ms[0], "first_loss": warm[0],
            "losses": losses, "step_ms": ms, "ms_per_step": step_ms,
            "rows_per_s": rows / step_ms * 1e3, "peak_device_bytes": peak,
            "step_breakdown": breakdown,
            "launches": launches, "launches_per_step": per_step,
            "card_vs_cpu": {"rows": check_rows, **agree}}


def gnn_train(src, dst, mask, N: int, tmp: str) -> dict:
    """gin-tu at full width (d_in 100) on ``gnn_aggregate``'s graph: the
    train step prepares the batch once through its ``PrepCache``
    (forward and reverse, host seconds reported), then takes
    ``TRAIN_STEPS`` AdamW steps, each exactly 5 ``spmm`` forwards and 5
    backwards on the bound route and the readout's forward on perm; the
    same steps from the same state again, bit-equal parameters.  Then the
    backward's ``spmm`` timed beside cuSPARSE's transposed SpMM, card
    against CPU on ``GIN_CHECK_SCALE``'s copies, and one train step of
    GatedGCN, EGNN and NequIP at ``gnn_models``' cells, card against
    CPU."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.spmm import spmm
    from repro_torch.launch import steps as S
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves
    t_phase = time.perf_counter()
    cfg = get_arch("gin-tu").config_for_shape("ogb_products")
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {"nodes": torch.randn((N, cfg.d_in), generator=g, device="cuda"),
             "edges": torch.stack([src, dst], 1),
             "edge_mask": mask,
             "node_mask": torch.ones(N, device="cuda"),
             "graph_ids": torch.zeros(N, dtype=torch.int32, device="cuda"),
             "labels": torch.randint(0, cfg.n_classes, (N,), generator=g,
                                     device="cuda", dtype=torch.int32)}
    step = S.make_gnn_train_step(cfg, "full")
    edges = step.prep_cache.get(batch).edges
    torch.cuda.synchronize()
    prepare_s = step.prep_cache.prepare_s[0]
    per_step = {"spmm": 2 * cfg.n_layers + 1, "spmm_backward": cfg.n_layers}
    routes = {"bound": 2 * cfg.n_layers, "perm": 1}
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        params = G.params_to(G.gin_init(cfg, torch.Generator()
                                        .manual_seed(0)), "cuda")
        state = {"params": params, "opt": adamw_init(params)}
        losses, ms, launches = train_steps(
            step, state, batch, TRAIN_STEPS, per_step,
            "gin-tu train step (5 spmm forwards, 5 backwards, the readout)",
            by_route=routes)
        if len(step.prep_cache.prepare_s) != 1:
            raise AssertionError("gin-tu: the train step prepared the batch "
                                 "again")
        runs.append((losses, ms, launches, tree_leaves(state["params"])))
    peak = torch.cuda.max_memory_allocated()
    bit_equal = all(torch.equal(a, b) for a, b in zip(runs[0][3], runs[1][3]))
    if not bit_equal or runs[0][0] != runs[1][0]:
        raise AssertionError("gin-tu: two runs from the same state differ")
    # a fourth step of the second run, profiled
    breakdown = step_breakdown(lambda: step(state, batch),
                               float(np.median(runs[0][1])))
    del runs[1], state, params
    # the backward's spmm alone, beside its plain version and cuSPARSE
    rev = edges.reverse
    grad = torch.randn((N, cfg.d_hidden), generator=g, device="cuda")
    bwd_ms = cuda_time_ms(lambda: spmm(grad, rev.src, rev.weights, rev.prep),
                          6, 1)
    rows = torch.where(src < 0, src + N, src).long()
    plain_ms = cuda_time_ms(lambda: torch.zeros_like(grad).index_add_(
        0, rows, grad[dst.long()] * mask[:, None]), 3, 1)
    lib_ms, lib_out = csr_library_ms(rev.prep, rev.prep.edges.src,
                                     rev.prep.edges.weights, N, grad, reps=3)
    got = spmm(grad, rev.src, rev.weights, rev.prep)[:N]
    lib_err = float((lib_out[:N] - got).abs().max())
    touched = int(torch.unique(dst).numel())
    rest = len(src) * (4 + 4 + 4) + (N + 1) * 8 + N * cfg.d_hidden * 4
    bwd_bound = bound(touched * cfg.d_hidden * 4 + rest,
                      2 * len(src) * cfg.d_hidden)
    del grad, lib_out, got, batch, step, edges, rev, rows
    torch.cuda.empty_cache()
    # card against CPU: one step's loss and gradients on RMAT-14 copies
    path, _ = write_graph(GIN_CHECK_SCALE, tmp)
    s, d, n_small = relabelled_copies(np.fromfile(path, np.uint32)
                                      .reshape(-1, 2), GNN_COPIES, seed=0)
    rng = np.random.default_rng(4)
    small = {"nodes": rng.standard_normal((n_small, cfg.d_in))
             .astype(np.float32),
             "edges": np.stack([s, d], 1),
             "edge_mask": (rng.random(len(s)) < 0.99).astype(np.float32),
             "node_mask": np.ones(n_small, np.float32),
             "graph_ids": np.zeros(n_small, np.int32),
             "labels": rng.integers(0, cfg.n_classes, n_small)
             .astype(np.int32)}
    gin_agree = gnn_train_card_vs_cpu("gin-tu", cfg, small, 1, "full")
    models = gnn_models_train()
    losses, ms, launches, _ = runs[0]
    return {"config": vars(cfg), "seconds": time.perf_counter() - t_phase,
            "prepare_s": prepare_s, "losses": losses, "step_ms": ms,
            "ms_per_step": float(np.median(ms)), "launches": launches,
            "launches_by_route": {k: v * TRAIN_STEPS
                                  for k, v in routes.items()},
            "launches_by_direction": {
                "forward": {"bound": cfg.n_layers * TRAIN_STEPS,
                            "perm": TRAIN_STEPS},
                "backward": {"bound": launches["spmm_backward"]}},
            "launches_per_step": routes, "peak_device_bytes": peak,
            "two_runs_bit_equal": bit_equal, "step_breakdown": breakdown,
            "backward_spmm": {"D": cfg.d_hidden, "route": "bound",
                              "ms": bwd_ms, "plain_ms": plain_ms,
                              **bwd_bound, "library_ms": lib_ms,
                              "library_max_abs_diff": lib_err,
                              "library": "torch.sparse.mm(CSR of the "
                                         "reversed edges, grad), cuSPARSE "
                                         "SpMM"},
            "card_vs_cpu": {"graph": f"{GNN_COPIES} copies of rmat_graph("
                                     f"{GIN_CHECK_SCALE}), relabelled",
                            "nodes": n_small, "edges": len(s), **gin_agree},
            "models": models,
            "spmm_launches": launches["spmm"] + models["spmm_launches"]}


def gnn_train_card_vs_cpu(arch: str, cfg, batch: dict, n_graphs: int,
                          kind: str) -> dict:
    """One train step's loss and gradients of ``arch`` on the same numpy
    batch and weights (drawn on the CPU) on the card and on the CPU, in
    float32 (``grads_agree``).  A leaf beyond the tolerance is held to it
    again with the model in float64 on both sides (the segment sums still
    float32): in GatedGCN's 16 batch-normed ReLU layers another float32
    summation order moves some weight gradients by ~1e-3 of their scale
    (on the CPU too: ``segment_sum``'s additions merely reordered move
    them up to 7.8e-4, and 2.7e-7 in float64; ``scripts/
    gnn_grad_precision.py``), so only float64 tells a wrong function from
    float32 rounding.  Each such leaf is listed with both readings."""
    import torch
    from repro_torch.launch import steps as S
    from repro_torch.models import gnn as G
    from repro_torch.optim.adamw import tree_map
    params = S.gnn_init(cfg, torch.Generator().manual_seed(0))
    loss_fn = S.gnn_loss_fn(cfg, kind, n_graphs)
    cpu_b = {k: torch.from_numpy(v) for k, v in batch.items()
             if v is not None}

    def both(p, b):
        return (loss_and_grads(loss_fn, G.params_to(p, "cuda"),
                               {k: v.cuda() for k, v in b.items()}),
                loss_and_grads(loss_fn, p, b))
    card, cpu = both(params, cpu_b)
    loss_err, shares = leaf_shares(card, cpu)
    over = [i for i, x in enumerate(shares) if x > TRAIN_TOL]
    line = {"loss_rel_err": loss_err, "max_grad_err_share": max(shares),
            "tolerance": TRAIN_TOL, "leaves": len(shares),
            "leaves_over_tolerance_in_float32": len(over)}
    ok = loss_err <= TRAIN_TOL
    if over:
        card64, cpu64 = both(
            tree_map(lambda p: p.double(), params),
            {k: v.double() if v.is_floating_point() else v
             for k, v in cpu_b.items()})
        loss64, shares64 = leaf_shares(card64, cpu64)
        line["float64"] = {
            "loss_rel_err": loss64,
            "max_grad_err_share": max(shares64),
            "rechecked": [{"leaf": i, "shape": list(cpu[1][i].shape),
                           "float32": shares[i], "float64": shares64[i]}
                          for i in over]}
        ok = ok and all(shares64[i] <= TRAIN_TOL for i in over)
    line["ok"] = ok
    if not ok:
        raise AssertionError(f"{arch} train card against CPU: {line}")
    return line


def gnn_models_train() -> dict:
    """GatedGCN and EGNN on ``full_graph_sm`` and NequIP on ``molecule``
    at full width (``gnn_models``' cells): one train step each on the
    card, exactly the forward's ``spmm`` launches on perm (every segment
    sum's backward is a gather), then card against CPU, every gradient
    leaf within ``TRAIN_TOL`` of its scale (``gnn_train_card_vs_cpu``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.data.gnn_batches import full_graph_batch, molecule_batch
    from repro_torch.launch import steps as S
    from repro_torch.models.gnn import params_to
    from repro_torch.optim import adamw_init
    sm, mol = GNN_SHAPES["full_graph_sm"], GNN_SHAPES["molecule"]
    graph = full_graph_batch(sm["n_nodes"], sm["n_edges"], sm["d_feat"],
                             seed=0, with_coords=True)
    nequip = get_arch("nequip").config_for_shape("molecule")
    molecules, B = molecule_batch(mol["batch"], mol["n_nodes"],
                                  mol["n_edges"], n_species=nequip.n_species,
                                  seed=0)
    cases = {"gatedgcn": ("full_graph_sm", graph, 1, "full",
                          lambda c: 2 * c.n_layers + 1),
             "egnn": ("full_graph_sm", graph, 1, "full",
                      lambda c: 2 * c.n_layers + 2),
             "nequip": ("molecule", molecules, B, "molecule",
                        lambda c: 3 * c.n_layers + 1)}
    out, total = {}, 0
    for arch, (shape, batch, n_graphs, kind, perm) in cases.items():
        cfg = get_arch(arch).config_for_shape(shape)
        if kind == "full":               # the graph's classes, the model's
            batch = {**batch, "labels": (batch["labels"] % cfg.n_classes)
                     .astype(np.int32)}
        params = params_to(S.init_params("gnn", cfg, torch.Generator()
                                         .manual_seed(0)), "cuda")
        state = {"params": params, "opt": adamw_init(params)}
        step = S.make_gnn_train_step(cfg, kind, n_graphs=n_graphs)
        tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()
              if v is not None}
        losses, ms, launches = train_steps(
            step, state, tb, 1, {"spmm": perm(cfg)}, f"{arch} train step",
            by_route={"bound": 0, "perm": perm(cfg)})
        total += launches["spmm"]
        out[arch] = {"shape": shape, "loss": losses[0], "step_ms": ms[0],
                     "spmm_launches_per_step": {"perm": perm(cfg)},
                     "card_vs_cpu": gnn_train_card_vs_cpu(
                         arch, cfg, batch, n_graphs, kind)}
    return {**out, "spmm_launches": total}


def run_train_cli(argv) -> tuple:
    """``repro_torch.launch.train.main(argv)`` in this process with every
    launch counter reset just before: (its printed lines, the counts)."""
    from repro_torch.launch import train as TR
    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            TR.main(argv)
    _, counts, wall = counted(run)
    return buf.getvalue().splitlines(), counts, wall


def train_cli(tmp: str) -> dict:
    """``python -m repro_torch.launch.train`` on the card: gin-tu
    ``--full`` 12 steps with a failure injected at 7 and checkpoints every
    5 (``restarts=1``; its losses from the restored step on bit-equal to a
    clean run's, the clean run in a process of its own through ``-m``),
    DIEN's resume (6 steps, then 10: ``resuming from checkpoint step 6``)
    and starcoder2-3b's smoke config, the launches of each run counted."""
    from repro_torch.configs import get_arch
    gin = ["--arch", "gin-tu", "--full", "--steps", "12",
           "--ckpt-interval", "5"]
    clean_m = os.path.join(tmp, "gin_clean.json")
    clean = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *gin,
         "--ckpt-dir", os.path.join(tmp, "gin_clean"), "--metrics-out",
         clean_m], cwd=REPO, env={**os.environ, "PYTHONPATH": os.path.join(
             REPO, "src")}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        fail_m = os.path.join(tmp, "gin_fail.json")
        lines, counts, wall = run_train_cli(
            [*gin, "--inject-failure-at", "7", "--ckpt-dir",
             os.path.join(tmp, "gin_fail"), "--metrics-out", fail_m])
        # 7 steps, the failure before step 7, 7 replayed from step 5; each
        # L forwards and L backwards on the bound route and the readout
        layers = get_arch("gin-tu").make_config().n_layers
        expect_launches(counts, {"spmm": 14 * (2 * layers + 1),
                                 "spmm_backward": 14 * layers},
                        "gin-tu CLI run")
        if "restarts=1" not in lines[-1]:
            raise AssertionError(f"gin-tu CLI: {lines[-1]}")
        out, err = clean.communicate(timeout=600)
    finally:
        if clean.poll() is None:
            clean.kill()
            clean.communicate()
    if clean.returncode != 0 or "restarts=0" not in out:
        raise AssertionError(f"gin-tu clean CLI run: {clean.returncode} "
                             f"{out[-500:]} {err[-2000:]}")
    failed = [m["loss"] for m in json.load(open(fail_m))]
    cleaned = [m["loss"] for m in json.load(open(clean_m))]
    # the failing run's steps 0-6, then 5-11 replayed from step 5's state
    if failed[:7] != cleaned[:7] or failed[7:] != cleaned[5:]:
        raise AssertionError(f"gin-tu: the restored run's losses differ "
                             f"from a clean run's: {failed} {cleaned}")
    ck = os.path.join(tmp, "dien")
    d1, c1, w1 = run_train_cli(["--arch", "dien", "--steps", "6",
                                "--ckpt-interval", "3", "--ckpt-dir", ck])
    expect_launches(c1, {"augru": 12, "augru_backward": 12}, "DIEN CLI run")
    d2, c2, w2 = run_train_cli(["--arch", "dien", "--steps", "10",
                                "--ckpt-interval", "3", "--ckpt-dir", ck])
    expect_launches(c2, {"augru": 8, "augru_backward": 8},
                    "DIEN CLI resumed run")
    if "resuming from checkpoint step 6" not in d2:
        raise AssertionError(f"DIEN CLI resume: {d2}")
    lm, c3, w3 = run_train_cli(["--arch", "starcoder2-3b", "--steps", "3",
                                "--ckpt-dir", os.path.join(tmp, "lm")])
    expect_launches(c3, {"flash_attention": 6,
                         "flash_attention_backward": 6}, "LM CLI run")
    return {"gin_tu": {"line": lines[-1], "wall_s": wall,
                       "launches": {k: counts[k]
                                    for k in ("spmm", "spmm_backward")},
                       "losses_bit_equal_to_clean_run": True,
                       "losses": failed},
            "dien": {"first": d1[-1], "resumed": d2, "wall_s": [w1, w2],
                     "launches": [{k: v for k, v in c.items() if v}
                                  for c in (c1, c2)]},
            "starcoder2_3b_smoke": {"line": lm[-1], "wall_s": w3,
                                    "launches": {k: v for k, v in c3.items()
                                                 if v}}}


# ---------------------------------------------------------------------------
# partitioned GNN training: the halo exchange on the card, and over ranks
# ---------------------------------------------------------------------------

#: the flat plan's pair-table cap (``pair_cap_quantile``): the pairs above
#: it go to the overflow lane, so that lane carries rows
PARTITIONED_QUANTILE = 0.9
#: the graph of gin-tu's card-against-CPU check and of the ranks
PARTITIONED_CHECK_SCALE = 14
#: GatedGCN's and EGNN's graph on the card: GatedGCN's 16 layers of
#: (E, 70) edge state took 7.9 GB at RMAT-14, so ~140 GB at RMAT-18 and
#: ~32 GB at 16
PARTITIONED_MODELS_SCALE = 16
#: their card-against-CPU check's graph: the CPU's float64 recheck took
#: 56 s at RMAT-14
PARTITIONED_MODELS_CHECK_SCALE = 12
#: the ranks route: (ranks, host groups) of each gloo world
PARTITIONED_WORLDS = ((2, None), (4, 2))
#: the largest |logit| of gin-tu's and GatedGCN's first forward in the
#: partitioned phase: the features are scaled to it (``feature_scale``)
LOGIT_MAX = 4.0


def partitioned_batch(plan, V: int, d_in: int, n_classes: int, seed: int,
                      device, feature_scale: float = 1.0) -> tuple:
    """The batch of a partitioned step on ``plan`` (``nodes``, ``labels``,
    ``coords``, ``loss_mask``, ``plan``): per-vertex features (normal,
    times ``feature_scale``), labels and coordinates drawn from ``seed``,
    every replica of a vertex the same rows, its loss on its master (the
    lowest partition holding it); and the per-vertex arrays with the
    covered mask, the dense reference's inputs."""
    import torch
    base = getattr(plan, "base", plan)
    vm, k = base.vmap_global, base.k
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((V, d_in), dtype=np.float32)
    feats *= np.float32(feature_scale)
    coords = rng.standard_normal((V, 3), dtype=np.float32)
    labels = rng.integers(0, n_classes, V).astype(np.int32)
    ok = vm >= 0
    parts = np.broadcast_to(np.arange(k)[:, None], vm.shape)
    master = np.full(V, k, np.int64)
    np.minimum.at(master, vm[ok], parts[ok])
    at = np.where(ok, vm, 0)
    idx = torch.from_numpy(at).to(device)
    keep = torch.from_numpy(ok).to(device)

    def rows(a):
        t = torch.from_numpy(a).to(device)[idx]
        return t * keep.reshape(keep.shape + (1,) * (t.dim() - 2)).to(
            t.dtype)
    lmask = (ok & (master[at] == parts)).astype(np.float32)
    batch = {"nodes": rows(feats), "labels": rows(labels),
             "coords": rows(coords),
             "loss_mask": torch.from_numpy(lmask).to(device),
             "plan": plan.device_arrays()}
    return batch, {"feats": feats, "labels": labels, "covered": master < k}


def dense_gin_logits(params, feats, src, dst):
    """gin-tu without batch norm over the whole graph in plain torch (a
    gather and ``index_add_`` a layer)."""
    import torch

    def dense(p, x):
        return x @ p["w"] + p["b"]
    h = dense(params["encoder"], feats)
    for lp in params["layers"]:
        agg = torch.zeros_like(h).index_add_(0, dst, h[src])
        pre = (1.0 + lp["eps"]) * h + agg
        h = torch.relu(dense(lp["mlp"]["l2"],
                             torch.relu(dense(lp["mlp"]["l1"], pre))))
    return dense(params["head"], h)


def dense_gin_loss(params, feats, src, dst, labels, covered):
    """``dense_gin_logits``' masked cross-entropy, every covered vertex
    once: the partitioned loss's dense reference."""
    import torch
    logp = torch.log_softmax(dense_gin_logits(params, feats, src, dst),
                             dim=-1)
    ll = logp.gather(1, labels[:, None].long())[:, 0]
    m = covered.float()
    return -(ll * m).sum() / m.sum()


def dense_gatedgcn_logits(params, feats, src, dst):
    """GatedGCN without batch norm over the whole graph in plain torch
    (gathers and ``index_add_``), edges starting from ones."""
    import torch

    def dense(p, x):
        return x @ p["w"] + p["b"]
    h = dense(params["encoder"], feats)
    ef = dense(params["edge_encoder"],
               torch.ones((len(src), 1), dtype=h.dtype, device=h.device))
    for lp in params["layers"]:
        e_new = (dense(lp["A"], h)[src] + dense(lp["B"], h)[dst]
                 + dense(lp["C"], ef))
        eta = torch.sigmoid(e_new)
        num = torch.zeros_like(h).index_add_(0, dst,
                                             eta * dense(lp["V"], h)[src])
        den = torch.zeros_like(h).index_add_(0, dst, eta)
        h = h + torch.relu(dense(lp["U"], h) + num / (den + 1e-6))
        ef = ef + torch.relu(e_new)
    return dense(params["head"], h)


#: the plain dense forward of each model whose features are scaled
DENSE_LOGITS = {"gin": dense_gin_logits, "gatedgcn": dense_gatedgcn_logits}


def feature_scale(model: str, cfg, V: int, edges, seed: int,
                  device) -> float:
    """The factor that brings the largest |logit| of ``model``'s dense
    forward (``DENSE_LOGITS``; weights ``init_params`` of seed 0, the
    normal features of ``seed``) to ``LOGIT_MAX``: exact after the first
    pass for gin-tu, whose network is positively homogeneous in its
    features at those weights (zero biases, eps 0, ReLU); a second pass
    brings GatedGCN, whose gates are not, close.  Unscaled, the sums over
    RMAT's hubs without batch norm give logits of ~1e6 (gin-tu, a loss of
    3.4e6 at RMAT-12) and ~1.5e3 (GatedGCN, a loss of 1,185): the softmax
    saturates, float32 rounding of the top logits moves its terms, and
    two float32 summation orders of the same function disagree by more
    than 1e-4 of a gradient leaf (gin-tu 2.5e-4, GatedGCN 2.8e-2 against
    float64 at RMAT-12 on the CPU; GatedGCN 1.4e-5 with its logits at
    18)."""
    import torch
    from repro_torch.launch import steps as S
    from repro_torch.models import gnn as G
    feats = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (V, cfg.d_in), dtype=np.float32)).to(device)
    src = torch.from_numpy(edges[:, 0].astype(np.int64)).to(device)
    dst = torch.from_numpy(edges[:, 1].astype(np.int64)).to(device)
    params = G.params_to(S.init_params("gnn", cfg, torch.Generator()
                                       .manual_seed(0)), device)
    scale = 1.0
    with torch.no_grad():
        for _ in range(2):
            top = float(DENSE_LOGITS[model](params, feats * scale, src,
                                            dst).abs().max())
            scale *= LOGIT_MAX / max(top, 1e-30)
    return scale


def event_timed(step, ms: list):
    """``step`` with each call's device time (CUDA events) appended to
    ``ms``."""
    import torch

    def timed(state, batch):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = step(state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        return out
    return timed


def partitioned_step_runs(step, init, batch, model: str, n_layers: int,
                          steps: int, what: str, runs: int = 2) -> list:
    """``runs`` runs of ``steps`` steps from the state ``init()`` makes,
    each step's launches exactly ``step_spmm_launches``; per run (losses,
    device ms by CUDA events, launches, the parameters)."""
    from repro_torch.dist.partitioned_gnn import step_spmm_launches
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves
    total, bwd, bound_n = step_spmm_launches(model, n_layers)
    out = []
    for _ in range(runs):
        params = init()
        state = {"params": params, "opt": adamw_init(params)}
        ms = []
        losses, _, launches = train_steps(
            event_timed(step, ms), state, batch, steps,
            {"spmm": total, "spmm_backward": bwd}, what,
            by_route={"bound": bound_n, "perm": total - bound_n})
        out.append((losses, ms, launches, tree_leaves(state["params"])))
    return out


def partitioned_gin_run(name: str, plan, mesh, cfg, V: int, graph,
                        dense, feature_scale: float) -> dict:
    """gin-tu's partitioned step on ``plan`` on the card: the plan prepared
    once (host seconds), ``TRAIN_STEPS`` AdamW steps twice from the same
    state (bit-equal parameters), peak memory, one profiled step
    (``step_breakdown``), and the first loss and gradients against the
    dense reference ``dense`` (loss and gradients of ``dense_gin_loss``
    at the same weights)."""
    import functools

    import torch
    from repro_torch.dist import partitioned_gnn as PG
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw_init
    step = PG.make_partitioned_gin_step(cfg, mesh, plan)
    batch, _ = partitioned_batch(plan, V, cfg.d_in, cfg.n_classes, 5,
                                 "cuda", feature_scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part = step.prepare(batch["plan"])
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0

    def init():
        return G.params_to(G.gin_init(cfg, torch.Generator()
                                      .manual_seed(0)), "cuda")
    t_runs = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    runs = partitioned_step_runs(step, init, batch, "gin", cfg.n_layers,
                                 TRAIN_STEPS, f"partitioned gin-tu ({name})")
    runs_s = time.perf_counter() - t_runs
    peak = torch.cuda.max_memory_allocated()
    (losses, ms, launches, p1), (losses2, _, _, p2) = runs
    bit_equal = all(torch.equal(a, b) for a, b in zip(p1, p2))
    if not bit_equal or losses != losses2:
        raise AssertionError(f"partitioned gin-tu ({name}): two runs from "
                             f"the same state differ")
    del runs, p1, p2
    params = init()
    state = {"params": params, "opt": adamw_init(params)}
    step(state, batch)
    breakdown = step_breakdown(lambda: step(state, batch),
                               float(np.median(ms)))
    del state, params
    loss_fn = functools.partial(PG.partitioned_gin_loss, cfg,
                                axes=mesh.axis_names, v_cap=plan.v_cap)
    ours = loss_and_grads(loss_fn, init(), {**batch, "plan": part})
    agree = grads_agree(ours, dense, TRAIN_TOL)
    if abs(losses[0] - float(dense[0])) > TRAIN_TOL * abs(float(dense[0])):
        raise AssertionError(f"partitioned gin-tu ({name}): first loss "
                             f"{losses[0]} against the dense {dense[0]}")
    return {"plan": name, "mesh": dict(zip(mesh.axis_names, mesh.shape)),
            "v_cap": plan.v_cap, "e_cap": plan.e_cap, "b_cap": plan.b_cap,
            "o_cap": plan.o_cap, "hb_cap": getattr(plan, "hb_cap", 0),
            "rows": part.rows, "edges": graph,
            "replica_slots": part.lanes.total.prep.num_nodes,
            "spmm_per_combine": part.lanes.launches, "prepare_s": prepare_s,
            "runs_s": runs_s,
            "losses": losses, "step_ms": ms,
            "ms_per_step": float(np.median(ms)), "launches": launches,
            "launches_per_step": dict(zip(
                ("spmm", "spmm_backward", "bound"),
                PG.step_spmm_launches("gin", cfg.n_layers))),
            "peak_device_bytes": peak, "two_runs_bit_equal": bit_equal,
            "step_breakdown": breakdown,
            "dense_reference": {"first_loss": losses[0],
                                "dense_loss": float(dense[0]), **agree}}


def small_partition(scale: int, tmp: str, k: int, hosts):
    """RMAT-``scale`` partitioned by 2PS-L into ``k`` on the card and
    planned with the pair tables capped at ``PARTITIONED_QUANTILE`` (host
    groups ``hosts``): (edges, V, plan)."""
    from repro_torch.core import MemmapEdgeStream, run_spec, spec_for
    from repro_torch.dist import plan_halo_exchange
    path, _ = write_graph(scale, tmp)
    edges = np.fromfile(path, np.uint32).reshape(-1, 2).astype(np.int64)
    V = int(edges.max()) + 1
    res = run_spec(spec_for("2psl"), MemmapEdgeStream(path), k)
    plan = plan_halo_exchange(edges, np.asarray(res.assignment), V, k,
                              pair_cap_quantile=PARTITIONED_QUANTILE,
                              host_groups=hosts)
    return edges, V, plan


def partitioned_model_steps(tmp: str, k: int = 32, hosts: int = 4) -> dict:
    """GatedGCN and EGNN at full width on RMAT-``PARTITIONED_MODELS_SCALE``
    partitions (k, ``hosts`` host groups, every lane active), one process
    on the card: two steps each from the same state, every step exactly
    ``step_spmm_launches``; device ms by CUDA events, peak memory."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.dist import partitioned_gnn as PG
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch import steps as S
    from repro_torch.models import gnn as G
    mesh = make_host_mesh((hosts, k // hosts), ("host", "device"))
    scale = PARTITIONED_MODELS_SCALE
    t0 = time.perf_counter()
    edges, V, plan = small_partition(scale, tmp, k, hosts)
    out = {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0): {V} "
                    f"vertices, {len(edges)} edges, 2PS-L k={k}, {hosts} "
                    f"host groups, pair_cap_quantile {PARTITIONED_QUANTILE}",
           "v_cap": plan.v_cap, "o_cap": plan.o_cap, "hb_cap": plan.hb_cap,
           "partition_s": time.perf_counter() - t0}
    for model in ("gatedgcn", "egnn"):
        t_model = time.perf_counter()
        cfg = get_arch(model).config_for_shape("ogb_products")
        fscale = (feature_scale(model, cfg, V, edges, 6, "cuda")
                  if model in DENSE_LOGITS else 1.0)
        batch, _ = partitioned_batch(plan, V, cfg.d_in, cfg.n_classes, 6,
                                     "cuda", fscale)
        step = PG.make_partitioned_gnn_step(model, cfg, mesh, plan)
        t1 = time.perf_counter()
        step.prepare(batch["plan"])
        prepare_s = time.perf_counter() - t1

        def init():
            return G.params_to(S.init_params(
                "gnn", cfg, torch.Generator().manual_seed(0)), "cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        [(losses, ms, launches, _)] = partitioned_step_runs(
            step, init, batch, model, cfg.n_layers, 2,
            f"partitioned {model} step", runs=1)
        out[model] = {"config": vars(cfg), "feature_scale": fscale,
                      "prepare_s": prepare_s, "losses": losses,
                      "step_ms": ms, "launches": launches,
                      "launches_per_step": dict(zip(
                          ("spmm", "spmm_backward", "bound"),
                          PG.step_spmm_launches(model, cfg.n_layers))),
                      "peak_device_bytes": torch.cuda.max_memory_allocated(),
                      "seconds": time.perf_counter() - t_model}
        del step, batch
        torch.cuda.empty_cache()
    return out


def partitioned_card_vs_cpu(tmp: str, k: int = 32, hosts: int = 4) -> dict:
    """On small RMAT partitions with every lane active, each model's
    partitioned loss and gradients on the card against the CPU, each leaf
    within ``TRAIN_TOL`` of its scale: gin-tu at
    ``PARTITIONED_CHECK_SCALE``, GatedGCN and EGNN at full width at
    ``PARTITIONED_MODELS_CHECK_SCALE``.  gin-tu's and GatedGCN's features
    are scaled (``feature_scale``), so float32 decides them; EGNN's leaves
    beyond the tolerance are rechecked with the model in float64 on both
    sides, as ``gnn_train_card_vs_cpu`` does."""
    import functools

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.dist import partitioned_gnn as PG
    from repro_torch.launch import steps as S
    from repro_torch.models import gnn as G
    from repro_torch.optim.adamw import tree_map
    layout = PG._AxisLayout(pair=("device",), host=("host",),
                            all=("host", "device"))
    out, parts = {}, {}
    for model, arch, scale in (
            ("gin", "gin-tu", PARTITIONED_CHECK_SCALE),
            ("gatedgcn", "gatedgcn", PARTITIONED_MODELS_CHECK_SCALE),
            ("egnn", "egnn", PARTITIONED_MODELS_CHECK_SCALE)):
        t_model = time.perf_counter()
        if scale not in parts:
            parts[scale] = small_partition(scale, tmp, k, hosts)
        edges, V, plan = parts[scale]
        cfg = get_arch(arch).config_for_shape("ogb_products")
        fscale = (feature_scale(model, cfg, V, edges, 6, "cpu")
                  if model in DENSE_LOGITS else 1.0)
        cpu_b, _ = partitioned_batch(plan, V, cfg.d_in, cfg.n_classes, 6,
                                     "cpu", fscale)
        card_b = {n: v if n == "plan" else v.cuda()
                  for n, v in cpu_b.items()}
        params = S.init_params("gnn", cfg, torch.Generator().manual_seed(0))
        loss_fn = functools.partial(PG.PARTITIONED_LOSSES[model], cfg,
                                    axes=layout, v_cap=plan.v_cap)
        line = {"graph": f"rmat_graph({scale}, edge_factor=16, seed=0), "
                         f"2PS-L k={k}, {hosts} host groups, "
                         f"pair_cap_quantile {PARTITIONED_QUANTILE}",
                "v_cap": plan.v_cap, "o_cap": plan.o_cap,
                "hb_cap": plan.hb_cap, "config": vars(cfg),
                "feature_scale": fscale}

        def both(p, cast=None):
            cb = card_b if cast is None else {
                n: v if n == "plan" or not v.is_floating_point()
                else v.to(cast) for n, v in card_b.items()}
            hb = cpu_b if cast is None else {
                n: v if n == "plan" or not v.is_floating_point()
                else v.to(cast) for n, v in cpu_b.items()}
            return (loss_and_grads(loss_fn, G.params_to(p, "cuda"), cb),
                    loss_and_grads(loss_fn, p, hb))
        card, cpu = both(params)
        loss_err, shares = leaf_shares(card, cpu)
        over = [i for i, x in enumerate(shares) if x > TRAIN_TOL]
        line.update(loss=float(cpu[0]), loss_rel_err=loss_err,
                    max_grad_err_share=max(shares), tolerance=TRAIN_TOL,
                    leaves=len(shares),
                    leaves_over_tolerance_in_float32=len(over))
        ok = loss_err <= TRAIN_TOL and not (over and model in DENSE_LOGITS)
        if over and ok:
            card64, cpu64 = both(tree_map(lambda p: p.double(), params),
                                 torch.float64)
            _, shares64 = leaf_shares(card64, cpu64)
            line["float64"] = {"rechecked": [
                {"leaf": i, "float32": shares[i], "float64": shares64[i]}
                for i in over]}
            ok = ok and all(shares64[i] <= TRAIN_TOL for i in over)
        line["ok"] = ok
        line["seconds"] = time.perf_counter() - t_model
        if not ok:
            raise AssertionError(f"partitioned {arch} card against CPU: "
                                 f"{line}")
        out[arch] = line
    return out


def partitioned_rank(rank: int, world: int, port: int, problem: str,
                     out_dir: str, threads: int) -> None:
    """One gloo rank of the ranks route (``torch.multiprocessing.spawn``):
    one gin-tu step on a ``DeviceMesh`` over the host's CPU, the loss and
    parameters saved for the parent."""
    import pickle

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.dist import make_partitioned_gin_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves
    torch.set_num_threads(threads)
    with open(problem, "rb") as f:
        cfg, plan, shape, names, batch, params = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=names)
        step = make_partitioned_gin_step(cfg, mesh, plan)
        state = {"params": params, "opt": adamw_init(params)}
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        secs = time.perf_counter() - t0
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 loss=float(metrics["loss"]), step_s=secs,
                 **{f"p{i}": p.numpy()
                    for i, p in enumerate(tree_leaves(state["params"]))})
    finally:
        dist.destroy_process_group()


def partitioned_ranks(tmp: str) -> list:
    """The ranks route at RMAT-``PARTITIONED_CHECK_SCALE``: for each
    ``PARTITIONED_WORLDS`` world, gin-tu's step on gloo ranks in
    processes of their own (the worlds at once, the host's cores shared
    out), every rank's loss and parameters within 1e-5 of the one-process
    route's on the CPU and equal across ranks."""
    import pickle

    import torch
    import torch.multiprocessing as mp
    from repro_torch.configs import get_arch
    from repro_torch.dist import make_partitioned_gin_step
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import tree_leaves
    cfg = get_arch("gin-tu").config_for_shape("ogb_products")
    threads = max(1, (os.cpu_count() or 1)
                  // sum(w for w, _ in PARTITIONED_WORLDS))
    worlds = []
    for world, hosts in PARTITIONED_WORLDS:
        t0 = time.perf_counter()
        edges, V, plan = small_partition(PARTITIONED_CHECK_SCALE, tmp,
                                         world, hosts)
        partition_s = time.perf_counter() - t0
        shape, names = ((hosts, world // hosts), ("host", "device")) \
            if hosts else ((world,), ("device",))
        batch, _ = partitioned_batch(
            plan, V, cfg.d_in, cfg.n_classes, 7, "cpu",
            feature_scale("gin", cfg, V, edges, 7, "cpu"))
        params = G.gin_init(cfg, torch.Generator().manual_seed(0))
        out_dir = tempfile.mkdtemp(dir=tmp)
        problem = os.path.join(out_dir, "problem.pkl")
        with open(problem, "wb") as f:
            pickle.dump((cfg, plan, shape, names, batch, params), f)
        ctx = mp.spawn(partitioned_rank, args=(world, _free_port(), problem,
                                               out_dir, threads),
                       nprocs=world, join=False)
        worlds.append((world, hosts, plan, shape, names, batch, params,
                       out_dir, partition_s, time.perf_counter(), ctx))
    lines = []
    for (world, hosts, plan, shape, names, batch, params, out_dir,
         partition_s, t0, ctx) in worlds:
        while not ctx.join():
            pass
        spawn_s = time.perf_counter() - t0
        step = make_partitioned_gin_step(
            cfg, make_host_mesh(shape, names, device="cpu"), plan)
        state = {"params": G.params_to(params, "cpu")}
        state["opt"] = adamw_init(state["params"])
        state, metrics = step(state, batch)
        want = [p.numpy() for p in tree_leaves(state["params"])]
        ranks = [np.load(os.path.join(out_dir, f"rank{r}.npz"))
                 for r in range(world)]
        loss_err = max(abs(float(r["loss"]) - float(metrics["loss"]))
                       for r in ranks)
        param_err = max(float(np.abs(r[f"p{i}"] - w).max())
                        for r in ranks for i, w in enumerate(want))
        identical = all(np.array_equal(r[f"p{i}"], ranks[0][f"p{i}"])
                        for r in ranks for i in range(len(want)))
        line = {"ranks": world, "hosts": hosts, "mesh": dict(zip(names,
                                                                 shape)),
                "o_cap": plan.o_cap, "loss": float(metrics["loss"]),
                "max_loss_err": loss_err, "max_param_err": param_err,
                "tolerance": 1e-5, "ranks_identical": identical,
                "threads_per_rank": threads,
                "rank_step_s": [float(r["step_s"]) for r in ranks],
                "partition_s": partition_s, "spawn_s": spawn_s}
        if loss_err > 1e-5 or param_err > 1e-5 or not identical:
            raise AssertionError(f"partitioned ranks route: {line}")
        lines.append(line)
    return lines


def partitioned_train(tmp: str, scale: int = 18) -> dict:
    """gin-tu at full width (5 layers, d 64, d_in 100, no batch norm) on
    the ``artifact`` phase's RMAT-``scale`` artifact (k = 32): on its
    host-grouped plan on a (4, 8) ``("host", "device")`` mesh and on the
    flat plan capped at ``PARTITIONED_QUANTILE`` (the overflow lane
    active), each one process on the card (``partitioned_gin_run``); then
    ``partitioned_model_steps``, ``partitioned_card_vs_cpu`` and
    ``partitioned_ranks``."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import MemmapEdgeStream, PartitionArtifact
    from repro_torch.dist import plan_halo_exchange_stream
    from repro_torch.dist.partitioned_gnn import _plan_dims
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gnn as G
    t_phase = time.perf_counter()
    cfg = get_arch("gin-tu").config_for_shape("ogb_products")
    art = PartitionArtifact.load(os.path.join(tmp, "artifact"))
    k, V = art.k, art.num_vertices
    path, E = write_graph(scale, tmp)
    host = art.host_halo_plan()
    if _plan_dims(art) != (k, host.v_cap, host.num_hosts):
        raise AssertionError("the artifact's dims are not its host plan's")
    t0 = time.perf_counter()
    flat = plan_halo_exchange_stream(MemmapEdgeStream(path), art.assignment,
                                     V, k,
                                     pair_cap_quantile=PARTITIONED_QUANTILE)
    flat_plan_s = time.perf_counter() - t0
    if not (flat.ov_idx >= 0).any():
        raise AssertionError("the capped plan has no overflow rows")
    edges = np.fromfile(path, np.uint32).reshape(-1, 2)
    fscale = feature_scale("gin", cfg, V, edges, 5, "cuda")
    _, ref = partitioned_batch(flat, V, cfg.d_in, cfg.n_classes, 5, "cpu",
                               fscale)
    dense_b = {"feats": torch.from_numpy(ref["feats"]).cuda(),
               "src": torch.from_numpy(edges[:, 0].astype(np.int64)).cuda(),
               "dst": torch.from_numpy(edges[:, 1].astype(np.int64)).cuda(),
               "labels": torch.from_numpy(ref["labels"]).cuda(),
               "covered": torch.from_numpy(ref["covered"]).cuda()}
    params = G.params_to(G.gin_init(cfg, torch.Generator().manual_seed(0)),
                         "cuda")
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(lambda p, b: dense_gin_loss(p, **b),
                                 params, dense_b)
    dense = (loss.cpu(), [g.cpu() for g in grads])
    dense_s = time.perf_counter() - t0
    del dense_b, params, grads
    graph = (f"rmat_graph({scale}, edge_factor=16, seed=0): {V} vertices, "
             f"{E} edges")
    runs = {"host_grouped": partitioned_gin_run(
                "host-grouped (4 hosts)", host,
                make_host_mesh((4, k // 4), ("host", "device")), cfg, V,
                graph, dense, fscale)}
    torch.cuda.empty_cache()
    runs["flat_capped"] = partitioned_gin_run(
        f"flat, pair_cap_quantile {PARTITIONED_QUANTILE}", flat,
        make_host_mesh((k,), ("device",)), cfg, V, graph, dense, fscale)
    del dense
    torch.cuda.empty_cache()
    models = partitioned_model_steps(tmp)
    t0 = time.perf_counter()
    check = partitioned_card_vs_cpu(tmp)
    check["seconds"] = time.perf_counter() - t0
    ranks = partitioned_ranks(tmp)
    lines = [*runs.values(), models["gatedgcn"], models["egnn"]]
    return {"config": vars(cfg), "seconds": time.perf_counter() - t_phase,
            "feature_scale": fscale, "flat_plan_s": flat_plan_s,
            "dense_reference_s": dense_s, **runs, "models": models,
            "card_vs_cpu": check, "ranks": ranks,
            "spmm_launches": sum(r["launches"].get("spmm", 0)
                                 for r in lines),
            "spmm_backward_launches": sum(
                r["launches"].get("spmm_backward", 0) for r in lines)}


#: the ``artifact`` phase's RMAT scale (at most), which
#: ``partitioned_train`` trains on
ARTIFACT_SCALE = 18


def artifact_phase(tmp: str, scale: int) -> dict:
    """The ``artifact`` phase at min(``scale``, ``ARTIFACT_SCALE``) in
    ``tmp``, emitted."""
    out = artifact_path(min(scale, ARTIFACT_SCALE), tmp)
    emit({"phase": "artifact", **out})
    return out


def partitioned_phase(tmp: str, scale: int) -> dict:
    """The ``partitioned_train`` phase on ``artifact_phase``'s artifact in
    ``tmp``, emitted."""
    out = partitioned_train(tmp, min(scale, ARTIFACT_SCALE))
    emit({"phase": "partitioned_train", **out})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20,
                    help="RMAT scale of the hash graphs (default 20); "
                         "2PS-L and HEP run at min(scale, 19), 2PS-HDRF, "
                         "the hosted 2PS-L, buffered and the artifact at "
                         "min(scale, 18), the overflow-tail comparison at "
                         "min(scale, 16) and the HDRF baselines at "
                         "min(scale, 15)")
    ap.add_argument("--spmm-tune", action="store_true",
                    help="only time the spmm bound route's launch shapes "
                         "(SPMM_TUNE) on gnn_aggregate's graph and print "
                         "one line each")
    ap.add_argument("--resume-alone", action="store_true",
                    help="only run the resume phase's crash drill with one "
                         "process on the card at a time, for its times, "
                         "and print its line")
    ap.add_argument("--scoring-compare", action="store_true",
                    help="only run the scoring redesign's before/after "
                         "comparisons, least_loaded_rounds and "
                         "twopsl_scoring (RMAT-16), and print their lines")
    ap.add_argument("--previous-designs", action="store_true",
                    help="also run the earlier redesigns' before/after "
                         "measurements the full run no longer runs: the "
                         "HDRF baselines again with the previous "
                         "composition, the previous flash design's prefill "
                         "time and the bf16 model's logits through it, "
                         "the previous flash backward's time, and augru's "
                         "previous backward (the rows route) beside the "
                         "tile route with both routes' edge")
    ap.add_argument("--moe-only", action="store_true",
                    help="only build flash_attention and its backward and "
                         "run the moe_serve phase, and print its line")
    ap.add_argument("--partitioned-only", action="store_true",
                    help="only build edge_score and spmm, make the artifact "
                         "phase's RMAT-18 artifact and run the "
                         "partitioned_train phase on it, and print its "
                         "line")
    ap.add_argument("--gru-library", nargs=3, type=int,
                    metavar=("BATCH", "SPLIT", "REPS"),
                    help="only time cuDNN's GRU at BATCH rows as SPLIT "
                         "equal calls and print {\"ms\": ...} (the "
                         "process gru_split_library starts)")
    argv = sys.argv[1:] if argv is None else argv
    counted_cli = argv[:1] in (["--partition-counted"], ["--dist-counted"])
    args = ap.parse_args([] if counted_cli else argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if counted_cli:
        sys.path.insert(0, os.path.join(REPO, "src"))
        if argv[0] == "--dist-counted":
            return dist_counted(argv[1:])
        return partition_counted(argv[1:])
    if args.gru_library:
        batch, split, reps = args.gru_library
        emit({"ms": gru_library_ms(batch, reps=reps, split=split)})
        return 0
    sys.path.insert(0, os.path.join(REPO, "src"))
    if args.resume_alone:
        print(nvidia_smi(), flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            emit({"phase": "resume", "alone": True,
                  **resume_path(tmp, alone=True)})
        return 0
    if args.scoring_compare:
        print(nvidia_smi(), flush=True)
        emit({"phase": "least_loaded_rounds",
              **least_loaded_rounds(min(args.scale, 16))})
        emit({"phase": "twopsl_scoring",
              **twopsl_scoring(min(args.scale, 16))})
        return 0
    if args.partitioned_only:
        from repro_torch.kernels import cuda_build
        from repro_torch.kernels.edge_score import kernel as es_kernel
        from repro_torch.kernels.spmm import kernel as sp_kernel
        print(nvidia_smi(), flush=True)
        cuda_build.build({es_kernel.NAME: es_kernel.SOURCE,
                          sp_kernel.NAME: sp_kernel.SOURCE})
        with tempfile.TemporaryDirectory() as tmp:
            artifact_phase(tmp, args.scale)
            partitioned_phase(tmp, args.scale)
        return 0
    if args.moe_only:
        from repro_torch.kernels import cuda_build
        from repro_torch.kernels.flash_attention import kernel as fa_kernel
        print(nvidia_smi(), flush=True)
        cuda_build.build({fa_kernel.NAME: fa_kernel.SOURCE,
                          fa_kernel.BACKWARD_NAME: fa_kernel.BACKWARD_SOURCE})
        emit({"phase": "moe_serve", **moe_serve()})
        return 0
    if args.spmm_tune:
        print(nvidia_smi(), flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            for line in spmm_tune(min(args.scale, 20), tmp):
                emit(line)
        return 0
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
                      ag_kernel.BACKWARD_NAME: ag_kernel.BACKWARD_SOURCE,
                      fa_kernel.NAME: fa_kernel.SOURCE,
                      fa_kernel.BACKWARD_NAME: fa_kernel.BACKWARD_SOURCE,
                      sp_kernel.NAME: sp_kernel.SOURCE,
                      eb_kernel.NAME: eb_kernel.SOURCE})
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"seconds": i["seconds"],
                          "ptxas": ptxas_report(i["log"])}
                      for n, i in cuda_build.build_info.items()}})

    check = check_edge_score((1, 1000, 65536, 65537), (0.0, 0.5, 1.0))
    e_bits = check_twopsl_bits(TWOPSL_ES, TWOPSL_KS, TWOPSL_HOSTS)
    timing = time_edge_score(65536)
    b_timing = time_edge_score_buffered()
    h_check = check_hdrf_score(HDRF_ES, HDRF_KS)
    h_bits = check_hdrf_bits(HDRF_ES, HDRF_KS)
    h_wide = {"flags": check_hdrf_score((64,), HDRF_WIDE_KS),
              "bits": check_hdrf_bits((64,), HDRF_WIDE_KS)}
    h_timing = time_hdrf_score(65536)
    h_micro = time_hdrf_score(64)
    a_check = check_augru(augru_check_shapes())
    a_one = time_augru(1, reps=200)
    a_timing = time_augru(512, reps=200)
    a_bulk = time_augru(BULK_BATCH, reps=5, library=args.previous_designs)
    a_edge = time_augru_edge() if args.previous_designs else None
    f_check = check_flash_attention(FLASH_CHECK)
    f_model = check_flash_attention(FLASH_MODEL, model_layout=True)
    f_main = check_flash_attention(FLASH_MAIN, model_layout=True)
    f_timing = time_flash_attention(PREFILL_SEQ,
                                    previous=args.previous_designs)
    f_err = max(f_check["max_abs_err"], f_model["max_abs_err"],
                f_main["max_abs_err"], f_timing["max_abs_err"])
    s_check = check_spmm(SPMM_CHECK)
    b_check = check_embedding_bag(BAG_CHECK)
    fb_check = check_flash_backward(FLASH_BWD_CHECK)
    fb_timing = time_flash_backward(LM_TRAIN_SEQ,
                                    previous=args.previous_designs)
    ab_check = check_augru_backward(augru_backward_cases())
    ab_timing = time_augru_backward(512, previous=args.previous_designs)
    ab_train = time_augru_backward(RECSYS_TRAIN_ROWS, reps=3,
                                   previous=args.previous_designs)
    ab_edge = (time_augru_backward_edge() if args.previous_designs
               else None)
    sb_check = [check_spmm_backward(D) for D in (GIN_D, GATED_D)]
    emit({"phase": "kernels",
          "edge_score": {**check, "bits_entry": e_bits, "chunk": timing,
                         "buffered_sub_batch": b_timing},
          "hdrf_score": {**h_check, "bits_entry": h_bits,
                         "wide_k": h_wide,
                         "chunk": h_timing, "micro_batch": h_micro},
          "augru": {**a_check, "serve_p99": a_timing, "serve_bulk": a_bulk,
                    "retrieval": a_one, "route_edge": a_edge},
          "flash_attention": {**f_check, "model_layout_4096": f_model,
                              "prefill_layer_float32": f_main,
                              "prefill_layer": f_timing,
                              "backward": fb_check,
                              "backward_train_layer": fb_timing},
          "augru_backward": {**ab_check, "serve_p99": ab_timing,
                             "train_rows": ab_train, "route_edge": ab_edge},
          "spmm": s_check, "spmm_backward": sb_check,
          "embedding_bag": b_check})

    rs = recsys_serve()
    emit({"phase": "recsys_serve", **rs})
    emit({"phase": "recsys_retrieval", **recsys_retrieval()})
    emit({"phase": "recsys_card_vs_cpu", **recsys_card_vs_cpu()})
    lp = lm_prefill()
    emit({"phase": "lm_prefill", **lp})
    emit({"phase": "lm_serve", **lm_serve()})
    emit({"phase": "lm_card_vs_cpu",
          **lm_card_vs_cpu(previous=args.previous_designs)})
    emit({"phase": "moe_serve", **moe_serve()})
    lt = lm_train()
    emit({"phase": "lm_train", **lt})
    rt = recsys_train()
    emit({"phase": "recsys_train", **rt})

    with tempfile.TemporaryDirectory() as tmp:
        # the partitioning paths run below their earlier slices' scales
        # (2PS-HDRF and the hashes at RMAT-20, 2PS-L at 19, the HDRF
        # baselines at 16; since the partitioned training phase 2PS-HDRF
        # at 18 and the HDRF baselines at 15) so that the whole run keeps
        # inside its time limit
        mp = main_path(min(args.scale, 19), tmp)
        emit({"phase": "main_path", **mp})
        emit({"phase": "hosted", **hosted_path(min(args.scale, 18), tmp)})
        hp = two_ps_hdrf_path(min(args.scale, 18), tmp)
        emit({"phase": "two_ps_hdrf", **hp})
        emit({"phase": "hdrf_baselines",
              **hdrf_baselines(min(args.scale, 15), tmp,
                               previous=args.previous_designs)})
        emit({"phase": "hash", **hash_paths(args.scale, tmp)})
        emit({"phase": "hep", **hep_path(min(args.scale, 19), tmp)})
        bp_run = buffered_path(min(args.scale, 18), tmp)
        emit({"phase": "buffered", **bp_run})
        ap_run = artifact_phase(tmp, args.scale)
        # the profiled process runs beside the crash drill's
        profiling = start_profile(tmp, min(args.scale, 14))
        try:
            rp_run = resume_path(tmp)
        except BaseException:
            stop_cli_processes(profiling["procs"])
            raise
        emit({"phase": "resume", **rp_run})
        pp_run = profile_path(profiling)
        emit({"phase": "profile", **pp_run})
        sh_run = shard_path(tmp)
        emit({"phase": "shard", **sh_run})
        ga = gnn_aggregate(min(args.scale, 20), tmp)
        gt = ga.pop("gnn_train")
        emit({"phase": "gnn_aggregate", **ga})
        emit({"phase": "gnn_train", **gt})
        pt = partitioned_phase(tmp, args.scale)
        gs = gnn_serve(tmp)
        emit({"phase": "gnn_serve", **gs})
        tc = train_cli(tmp)
        emit({"phase": "train_cli", **tc})
    gm = gnn_models()
    emit({"phase": "gnn_models", **gm})
    bp = bag_pool()
    emit({"phase": "bag_pool", **bp})
    emit({"phase": "ops_card_vs_cpu", **ops_card_vs_cpu(min(args.scale, 16))})
    emit({"phase": "card_vs_cpu",
          **card_vs_cpu(min(args.scale, 16), busy_edges=1 << 18),
          "hdrf_family": [card_vs_cpu(min(args.scale, 14), name,
                                      busy_edges=1 << 15)
                          for name in ("2ps-hdrf", "hdrf", "greedy")],
          "hep_buffered": [card_vs_cpu(min(args.scale, 14), name,
                                       busy_edges=1 << 15, **kw)
                           for name, kw in (
                               ("hep", {}),
                               ("hep", {"memory_budget_bytes":
                                        HEP_SMALL_BUDGET}),
                               ("hep", {"memory_budget_bytes": 8192}),
                               ("buffered", {}))],
          "artifact_and_checkpoint": artifact_card_vs_cpu(
              min(args.scale, 14))})

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
    if bp_run["edge_score_launches"] == 0:
        raise AssertionError("the buffered path launched no edge_score")
    if (gs["spmm_launches"] == 0 or gm["spmm_launches"] == 0
            or pt["spmm_launches"] == 0):
        raise AssertionError("the GNN paths launched no spmm")
    train_paths = {"flash_attention_backward":
                   lt["launches"]["flash_attention_backward"],
                   "augru_backward": rt["launches"]["augru_backward"],
                   "spmm_backward": gt["launches"]["spmm_backward"]}
    for name, n in train_paths.items():
        if n == 0:
            raise AssertionError(f"the train path launched no {name}")
    emit({"kernels": [{
        "name": "edge_score", "route": "cuda",
        "source": "src/repro_torch/kernels/edge_score/csrc/edge_score.cu",
        "replaces": "src/repro/kernels/edge_score/kernel.py:103",
        "launches": paths["edge_score"],
        "launches_by_entry": mp["edge_score_launches_by_entry"],
        "launches_buffered": bp_run["edge_score_launches"],
        "launches_artifact": ap_run["edge_score_launches"],
        "launches_resumed": {n: rp_run[n]["resumed_launches"]
                             for n in ("2psl", "buffered")},
        "launches_profile": pp_run["edge_score_launches"],
        "launches_sharded": {
            "emulated_2psl_w4": sh_run["emulated"]["w4"][
                "edge_score_launches"],
            "fs_ranks": [r["edge_score_launches"]
                         for r in sh_run["processes"]["fs"]],
            "torch_ranks": [r["edge_score_launches"]
                            for r in sh_run["processes"]["torch"]],
            "drill_rank1_resumed": sh_run["processes"]["drill"][
                "rank1_resumed"]["edge_score_launches"],
            **{f"w3_{n}": sh_run["card_vs_cpu"][n]["launches"]["edge_score"]
               for n in ("2psl", "2psl_hosted", "buffered")}},
        "max_abs_err": max(check["max_abs_err"], e_bits["max_abs_err"]),
        "ms": timing["ms"], "previous_ms": timing["previous_ms"],
        "flags_ms": timing["flags_ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "sector_bound_ms": timing["sector_bound_ms"],
        "buffered_sub_batch_ms": b_timing["ms"],
        "buffered_sub_batch_plain_ms": b_timing["plain_ms"],
        "buffered_sub_batch_bound_ms": b_timing["bound_ms"],
        "library_ms": None}, {
        "name": "hdrf_score", "route": "cuda",
        "source": "src/repro_torch/kernels/hdrf_score/csrc/hdrf_score.cu",
        "replaces": "src/repro/kernels/hdrf_score/kernel.py:72",
        "launches": paths["hdrf_score"],
        "launches_by_entry": hp["hdrf_launches_by_entry"],
        "launches_resumed": {"hdrf": rp_run["hdrf"]["resumed_launches"]},
        "launches_sharded": {
            "w3_hdrf_capped": sh_run["card_vs_cpu"]["hdrf_capped"][
                "launches"]["hdrf_score"]},
        "max_abs_err": max(h_check["max_abs_err"], h_bits["max_abs_err"],
                           *(c["max_abs_err"] for c in h_wide.values())),
        "ms": h_timing["bits_ms"],
        "previous_ms": h_timing["bits_previous_ms"],
        "flags_ms": h_timing["flags_ms"],
        "flags_previous_ms": h_timing["flags_previous_ms"],
        "plain_ms": h_timing["bits_plain_ms"],
        "bound_ms": h_timing["bound_ms"], "bound_by": h_timing["bound_by"],
        "sector_bound_ms": h_timing["sector_bound_ms"],
        "library_ms": None}, {
        "name": "augru", "route": "cuda",
        "source": "src/repro_torch/kernels/augru/csrc/augru.cu",
        "replaces": "src/repro/kernels/augru/kernel.py:53",
        "launches": paths["augru"], "max_abs_err": a_check["max_abs_err"],
        "ms": a_timing["ms"], "previous_ms": a_timing["previous_ms"],
        "plain_ms": a_timing["plain_ms"],
        "bound_ms": a_timing["bound_ms"], "bound_by": a_timing["bound_by"],
        "library_ms": a_timing["library_ms"],
        "launches_train": rt["launches"]["augru"],
        "backward_source": "src/repro_torch/kernels/augru/csrc/"
                           "augru_backward.cu",
        "backward_launches": train_paths["augru_backward"],
        "backward_max_abs_err": ab_check["max_abs_err"],
        "backward_route": ab_train["route"],
        "backward_ms": ab_train["ms"],
        "backward_kernel_ms": ab_train["kernel_ms"],
        "backward_du_ms": ab_train["du_ms"],
        "backward_previous_ms": ab_train.get("previous_ms"),
        "backward_previous_kernel_ms": ab_train.get("previous_kernel_ms"),
        "backward_plain_ms": ab_train["plain_ms"],
        "backward_bound_ms": ab_train["bound_ms"],
        "backward_bound_by": ab_train["bound_by"],
        "backward_kernel_bound_ms": ab_train["kernel_bound_ms"],
        "backward_library_ms": ab_train["library_ms"],
        "backward_shape": ab_train["shape"],
        "backward_512_route": ab_timing["route"],
        "backward_512_ms": ab_timing["ms"],
        "backward_512_kernel_ms": ab_timing["kernel_ms"],
        "backward_512_bound_ms": ab_timing["bound_ms"],
        "backward_512_library_ms": ab_timing["library_ms"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "launches": paths["flash_attention"], "max_abs_err": f_err,
        "ms": f_timing["ms"], "previous_ms": f_timing["previous_ms"],
        "plain_ms": f_timing["plain_ms"],
        "bound_ms": f_timing["bound_ms"], "bound_by": f_timing["bound_by"],
        "library_ms": f_timing["library_ms"],
        "launches_train": lt["launches"]["flash_attention"],
        "backward_source": "src/repro_torch/kernels/flash_attention/csrc/"
                           "flash_attention_backward.cu",
        "backward_kernels": {
            "tensor_core": ["tc::lse_delta_kernel", "tc::dq_kernel",
                            "tc::dkv_kernel", "tc::dkv_reduce_kernel"],
            "simt": ["lse_delta_kernel", "dq_kernel", "dkv_kernel"]},
        "backward_route": fb_timing["route"],
        "backward_routes_checked": fb_check["routes"],
        "backward_launches": train_paths["flash_attention_backward"],
        "backward_max_abs_err": fb_check["max_abs_err"],
        "backward_max_err_over_bf16_bound":
            fb_check["max_err_over_bf16_bound"],
        "backward_ms": fb_timing["ms"],
        "backward_previous_ms": fb_timing["previous_ms"],
        "backward_tflop_per_s": fb_timing["tflop_per_s"],
        "backward_plain_ms": fb_timing["plain_ms"],
        "backward_bound_ms": fb_timing["bound_ms"],
        "backward_bound_by": fb_timing["bound_by"],
        "backward_library_ms": fb_timing["library_ms"],
        "backward_shape": fb_timing["shape"]}, {
        "name": "spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/spmm/csrc/spmm.cu",
        "replaces": "src/repro/kernels/spmm/kernel.py:52",
        "launches": paths["spmm"],
        "max_abs_err": max(s_check["max_abs_err"], gin["max_abs_err"],
                           ga["gated_segment_sum"]["max_abs_err"]),
        "kernel_route": gin["route"],
        "launches_by_route": ga["launches_by_route"],
        "launches_gnn_serve": gs["spmm_launches"],
        "launches_gnn_models": gm["spmm_launches"]
        + ga["gin_tu_forward"]["spmm_launches"],
        "ms": gin["ms"], "previous_ms": gin["previous_ms"],
        "plain_ms": gin["plain_ms"],
        "bound_ms": gin["bound_ms"], "bound_by": gin["bound_by"],
        "gathered_bound_ms": gin["gathered_bound_ms"],
        "library_ms": gin["library_ms"],
        "launches_train": gt["spmm_launches"],
        "launches_train_by_route": gt["launches_by_route"],
        "launches_partitioned_train": pt["spmm_launches"],
        "backward_launches_partitioned_train":
            pt["spmm_backward_launches"],
        "backward_source": "src/repro_torch/kernels/spmm/csrc/spmm.cu "
                           "(spmm over the reversed edges)",
        "backward_launches": train_paths["spmm_backward"],
        "backward_max_abs_err": max(c["max_abs_err"] for c in sb_check),
        "backward_ms": gt["backward_spmm"]["ms"],
        "backward_plain_ms": gt["backward_spmm"]["plain_ms"],
        "backward_bound_ms": gt["backward_spmm"]["bound_ms"],
        "backward_bound_by": gt["backward_spmm"]["bound_by"],
        "backward_library_ms": gt["backward_spmm"]["library_ms"]}, {
        "name": "embedding_bag", "route": "cuda",
        "source": "src/repro_torch/kernels/embedding_bag/csrc/"
                  "embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:37",
        "launches": paths["embedding_bag"],
        "max_abs_err": max([b_check["max_abs_err"]]
                           + [r["max_abs_err"] for r in bp.values()
                              if isinstance(r, dict)]),
        "ms": bulk["ms"], "previous_ms": bulk["previous_ms"],
        "plain_ms": bulk["plain_ms"],
        "bound_ms": bulk["bound_ms"], "bound_by": bulk["bound_by"],
        "gathered_bound_ms": bulk["gathered_bound_ms"],
        "sector_bound_ms": bulk["sector_bound_ms"],
        "block64_bound_ms": bulk["block64_bound_ms"],
        "library_ms": bulk["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
