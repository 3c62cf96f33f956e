"""Distributed partitioning launcher on the card — shard the edge stream
across N workers (``repro_torch.shard``, docs/distributed.md).

  # emulated (worker threads in one process, all on one card):
  python -m repro_torch.launch.dist_partition --input graph.bin --k 32 \\
      --workers 4 --backend emulated --artifact-dir parts/

  # real multi-process over a shared filesystem: the parent spawns one
  # subprocess per rank (or launch ranks yourself with --rank):
  python -m repro_torch.launch.dist_partition --input graph.bin --k 32 \\
      --workers 4 --backend fs --exchange-dir /shared/xchg \\
      --artifact-dir parts/

  # torch.distributed-initialized (rank/world from a gloo process group;
  # launch each rank yourself):
  python -m repro_torch.launch.dist_partition --input graph.bin --k 32 \\
      --backend torch --coordinator tcp://127.0.0.1:29500 --workers 2 \\
      --rank 0 --exchange-dir /shared/xchg --artifact-dir parts/

It takes every flag of the reference package's ``dist_partition`` CLI,
with ``--backend torch`` in the place of ``--backend jax`` (``--coordinator``
is the process group's ``init_method``; ``env://`` when absent) and
``--device`` added (``cuda`` by default; a missing card raises instead of
falling back).  ``--scoring-backend`` is validated by the spec and recorded
in the manifest's spec; it changes no route.

Every backend drives the same ``run_worker`` round protocol: chunks are
dealt round-robin in blocks of ``--round-chunks``, each worker streams
its blocks through the engine pipeline writing a rank-local assignment
slice, the O(|V|) state is all-gathered and merged at round boundaries,
and rank 0 stitches the slices into one format-v4 ``PartitionArtifact``
whose manifest records per-shard slice sha256s.  The assignment is the
reference CLI's for the same flags.

Crash safety: ``--checkpoint-every R`` snapshots each worker's merged
state + local slice every R **rounds** (per-rank subdirectories of
``--checkpoint-dir``); relaunching a dead rank with ``--resume`` re-joins
its peers mid-pass — their published round states persist on the
exchange directory.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from repro_torch import obs
from repro_torch.core import (PORTED, SPEC_REGISTRY, MemmapEdgeStream,
                              PartitionArtifact, SpecError, TwoPSLSpec,
                              resolve_device, spec_for)
from repro_torch.core.artifact import ASSIGNMENT_FILE
from repro_torch.shard import (FileExchange, ShardLayout,
                               TorchDistributedExchange, finalize_shard_run,
                               run_spec_sharded, run_worker)
from repro_torch.shard.engine import _uniform_eff_chunk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="binary edge list (uint32 pairs)")
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--algorithm", default="2psl", choices=PORTED)
    ap.add_argument("--workers", type=int, default=2,
                    help="shard count (under --backend torch, the world "
                         "size handed to the process group)")
    ap.add_argument("--backend", default="emulated",
                    choices=("emulated", "fs", "torch"),
                    help="emulated: worker threads in this process; "
                         "fs: one process per rank over a shared "
                         "--exchange-dir (spawned here, or launched "
                         "externally with --rank); torch: like fs but "
                         "rank/world come from a torch.distributed (gloo) "
                         "process group")
    ap.add_argument("--round-chunks", type=int, default=1,
                    help="chunks each worker streams per merge round "
                         "(bigger = fewer exchanges, staler state)")
    ap.add_argument("--rank", type=int, default=None,
                    help="(fs/torch) run as this single rank instead of "
                         "spawning all workers; rank 0 stitches and "
                         "writes the artifact")
    ap.add_argument("--exchange-dir", default=None,
                    help="(fs/torch) shared directory for state exchange "
                         "(default: <artifact-dir>/exchange)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a rendezvous waits for peers")
    ap.add_argument("--coordinator", default=None,
                    help="(torch) the process group's init_method, "
                         "tcp://host:port (default env://)")
    # spec geometry (same validation path as repro_torch.launch.partition)
    ap.add_argument("--alpha", type=float, default=1.05)
    ap.add_argument("--chunk-size", type=int, default=1 << 16)
    ap.add_argument("--cluster-passes", type=int, default=1)
    ap.add_argument("--memory-budget-bytes", type=int, default=None)
    ap.add_argument("--buffer-edges", type=int, default=None)
    ap.add_argument("--pipeline-depth", type=int, default=None)
    ap.add_argument("--scoring-backend", default=None,
                    choices=("jnp", "pallas"),
                    help="recorded in the spec (the reference package's "
                         "scoring implementation); the port's route is "
                         "--device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    # outputs
    ap.add_argument("--out", default=None,
                    help="write the stitched int32 assignment memmap")
    ap.add_argument("--artifact-dir", default=None,
                    help="persist a full PartitionArtifact; the manifest "
                         "carries a 'shards' block (worker count, round "
                         "geometry, per-rank slice sha256s)")
    ap.add_argument("--no-plan", action="store_true",
                    help="with --artifact-dir: skip the halo-plan sweep")
    # robustness
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    metavar="R",
                    help="checkpoint each worker every R merge ROUNDS "
                         "(per-rank dirs under --checkpoint-dir)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="resume each worker from its latest round "
                         "checkpoint (fresh when none)")
    ap.add_argument("--io-retries", type=int, default=None, metavar="N")
    # observability
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="Chrome trace_event JSON incl. shard:merge / "
                         "shard:exchange spans")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.backend == "emulated" and args.rank is not None:
        ap.error("--rank is for --backend fs or torch (emulated runs all "
                 "workers in-process)")
    if args.backend in ("fs", "torch") and not (args.exchange_dir
                                                or args.artifact_dir):
        ap.error(f"--backend {args.backend} needs --exchange-dir (or "
                 f"--artifact-dir to default it)")
    checkpoint_dir = args.checkpoint_dir
    if checkpoint_dir is None and args.artifact_dir and (
            args.checkpoint_every or args.resume):
        checkpoint_dir = os.path.join(args.artifact_dir, "checkpoints")
    if (args.checkpoint_every or args.resume) and checkpoint_dir is None:
        ap.error("--checkpoint-every/--resume need --checkpoint-dir "
                 "(or --artifact-dir to default it)")

    overrides = {"alpha": args.alpha, "chunk_size": args.chunk_size}
    if SPEC_REGISTRY[args.algorithm][0] is TwoPSLSpec:
        overrides["cluster_passes"] = args.cluster_passes
    if args.pipeline_depth is not None:
        overrides["pipeline_depth"] = args.pipeline_depth
    if args.scoring_backend is not None:
        overrides["scoring_backend"] = args.scoring_backend
    if args.memory_budget_bytes is not None:
        overrides["memory_budget_bytes"] = args.memory_budget_bytes
    if args.buffer_edges is not None:
        overrides["buffer_edges"] = args.buffer_edges
    try:
        spec = spec_for(args.algorithm, **overrides)
    except (SpecError, TypeError) as e:
        ap.error(str(e))

    if args.backend == "fs" and args.rank is None:
        return _spawn_fs_workers(args, argv)
    device = resolve_device(args.device)

    stream = MemmapEdgeStream(args.input)
    retry_policy = None
    if args.io_retries is not None:
        from repro_torch.robust import RetryPolicy
        retry_policy = RetryPolicy(max_retries=args.io_retries)

    out_path = args.out
    if args.artifact_dir and out_path is None:
        os.makedirs(args.artifact_dir, exist_ok=True)
        out_path = os.path.join(args.artifact_dir, ASSIGNMENT_FILE)

    tracer = obs.Tracer() if args.trace else obs.NULL_TRACER
    registry = obs.MetricsRegistry() if args.trace else obs.NULL_REGISTRY
    exchange = None
    try:
        with obs.use_tracer(tracer), obs.use_registry(registry):
            if args.backend == "emulated":
                res = run_spec_sharded(
                    spec, stream, args.k, num_shards=args.workers,
                    round_chunks=args.round_chunks, device=device,
                    out_path=out_path, tracer=tracer, metrics=registry,
                    retry_policy=retry_policy,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every_rounds=args.checkpoint_every,
                    resume=args.resume, timeout_s=args.timeout)
                world = args.workers
            else:
                exchange_dir = args.exchange_dir or os.path.join(
                    args.artifact_dir, "exchange")
                if args.backend == "fs":
                    exchange = FileExchange(exchange_dir, args.rank,
                                            args.workers,
                                            timeout_s=args.timeout)
                else:
                    exchange = TorchDistributedExchange(
                        exchange_dir, init_method=args.coordinator,
                        world_size=args.workers, rank=args.rank,
                        timeout_s=args.timeout)
                worker = run_worker(
                    spec, stream, args.k, exchange, device=device,
                    round_chunks=args.round_chunks, tracer=tracer,
                    metrics=registry, retry_policy=retry_policy,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every_rounds=args.checkpoint_every,
                    resume=args.resume)
                world = exchange.world
                if exchange.rank != 0:
                    # every rank holds the final all-gather; only rank 0
                    # stitches + persists
                    return 0
                layout = ShardLayout(
                    num_edges=stream.num_edges,
                    eff_chunk=_uniform_eff_chunk(
                        spec, list(worker.partitioner.passes())),
                    world=world, round_chunks=args.round_chunks)
                res = finalize_shard_run(worker, layout, spec, stream,
                                         args.k, out_path=out_path,
                                         tracer=tracer, metrics=registry,
                                         backend=args.backend)

            report = {
                "algorithm": res.name, "k": args.k, "workers": world,
                "backend": args.backend,
                "edges": stream.num_edges, "vertices": stream.num_vertices,
                "replication_factor": res.quality.replication_factor,
                "alpha_measured": res.quality.balance,
                "timings_s": {kk: round(v, 3)
                              for kk, v in res.timings.items()},
                "device": str(device),
                **{kk: v for kk, v in res.extras.items()
                   if isinstance(v, (int, float, str))},
            }
            if args.artifact_dir:
                plan_stream = (None if args.no_plan else
                               MemmapEdgeStream(
                                   args.input,
                                   num_vertices=stream.num_vertices))
                PartitionArtifact.save(
                    args.artifact_dir, res,
                    num_vertices=stream.num_vertices,
                    num_edges=stream.num_edges, stream=plan_stream,
                    graph_path=args.input,
                    shards={"num_shards": world,
                            "round_chunks": args.round_chunks,
                            "rounds": res.extras["rounds"],
                            "backend": args.backend,
                            "slices": res.extras["shard_slices"]})
                report["artifact_dir"] = args.artifact_dir
    finally:
        if exchange is not None and hasattr(exchange, "close"):
            exchange.close()

    if args.trace:
        obs.write_chrome_trace(args.trace, tracer, metadata={
            "spec": spec.to_dict(), "k": args.k, "workers": world,
            "metrics": registry.snapshot()})
        report["trace"] = args.trace
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for kk, v in report.items():
            print(f"{kk:24s} {v}")
    return 0


def _spawn_fs_workers(args, argv):
    """Parent mode for --backend fs: one subprocess per rank running this
    module with --rank appended.  Rank 0 inherits stdout (it prints the
    report); other ranks are quiet.  Any nonzero child propagates."""
    argv = list(sys.argv[1:] if argv is None else argv)
    procs = []
    for r in range(args.workers):
        stdout = None if r == 0 else subprocess.DEVNULL
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dist_partition",
             *argv, "--rank", str(r)], stdout=stdout))
    rc = 0
    for r, p in enumerate(procs):
        code = p.wait()
        if code:
            rc = code
            print(f"rank {r} exited with {code}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
