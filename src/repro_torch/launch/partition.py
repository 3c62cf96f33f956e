"""Partitioning CLI on the card — the paper's tool: partition a binary edge
list out-of-core.

  python -m repro_torch.launch.partition --input graph.bin --k 32 \\
      --algorithm 2psl --alpha 1.05 --artifact-dir parts/

Reads the paper's binary format (pairs of little-endian uint32 vertex ids),
builds the ``PartitionerSpec`` for ``--algorithm``, and streams the graph
through the port's engine on ``--device`` (``cuda`` by default; a missing
card raises instead of falling back), printing the paper's metrics.  It
takes every flag of the reference package's partition CLI, with
``--torch-profile`` in the place of ``--jax-profile``, and writes the same
files.

Outputs, from lightest to heaviest:

* ``--out PATH``          just the int32 per-edge assignment memmap,
                          byte-equal to the reference CLI's for the same
                          flags.
* ``--plan-json PATH``    additionally a DGL-style partition manifest
                          (k, halo capacities, replication factor,
                          per-partition edge counts).
* ``--artifact-dir DIR``  a full persistent ``PartitionArtifact``:
                          assignment memmap + JSON manifest (embedding the
                          spec) + the padded halo-plan arrays (``.npz``),
                          loadable by either package's
                          ``PartitionArtifact.load``.  ``--no-plan`` skips
                          the plan; ``--local-graphs`` also lowers the
                          artifact into per-partition CSC/CSR files.
* ``--hosts H``           lays the k partitions out on H host groups: the
                          run reports the cross-host replication factor,
                          and with ``--artifact-dir`` also persists the
                          host-grouped exchange layout (``host_plan.npz``).
* ``--dcn-penalty P``     (with ``--hosts``) makes the scoring pass
                          hierarchy-aware (0 = flat scoring).
* ``--memory-budget-bytes B``  (hep) the byte budget of the pinned
                          hot-vertex rows.
* ``--buffer-edges N``    (buffered) edges per re-streaming window.

``--scoring-backend`` is validated by the spec and recorded in the
manifest's spec, so that the spec round-trips into the reference package;
it changes no route: the port's route is its ``--device``, recorded as
``kernel_backend``.

Robustness (``repro_torch.robust``, see docs/robustness.md):
``--checkpoint-every N`` snapshots the engine's pass state atomically every
N chunks (``--checkpoint-dir`` defaults to ``<artifact-dir>/checkpoints``);
``--resume`` restarts from the latest checkpoint, written by either
package, into an identical final assignment; ``--io-retries R`` validates
and retries chunk reads with bounded backoff.  The environment variable
``REPRO_CRASH_AFTER_CHECKPOINTS=n`` kills the process after its nth
checkpoint (the crash drill).

Observability (``repro_torch.obs``): ``--trace out.json`` records every
pipeline stage, halo-planning step and pass as Chrome ``trace_event``
spans, ``--trace-summary`` prints the per-stage stall table, and
``--torch-profile DIR`` additionally captures a ``torch.profiler`` trace
of the card's kernels into ``DIR``.  Traced runs are identical to
untraced runs.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch import obs
from repro_torch.core import (PORTED, SPEC_REGISTRY, MemmapEdgeStream,
                              PartitionArtifact, SpecError,
                              ThrottledEdgeStream, TwoPSLSpec,
                              resolve_device, run_spec, spec_for)
from repro_torch.core.artifact import ASSIGNMENT_FILE


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", required=True,
                    help="binary edge list (uint32 pairs)")
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--algorithm", default="2psl", choices=PORTED)
    ap.add_argument("--alpha", type=float, default=1.05)
    ap.add_argument("--cluster-passes", type=int, default=1)
    ap.add_argument("--chunk-size", type=int, default=1 << 16)
    ap.add_argument("--memory-budget-bytes", type=int, default=None,
                    help="(hep) byte budget for the pinned hot-vertex "
                         "replication rows: the partitioner's resident "
                         "scoring state never exceeds it (reported as "
                         "hot_state_bytes)")
    ap.add_argument("--buffer-edges", type=int, default=None,
                    help="(buffered) edges per re-streaming window; the "
                         "engine regroups the stream into ceil(buffer/"
                         "chunk) chunks per window, and checkpoints land "
                         "on window boundaries")
    ap.add_argument("--out", default=None,
                    help="write int32 assignment memmap here")
    ap.add_argument("--artifact-dir", default=None,
                    help="persist a full PartitionArtifact (assignment + "
                         "manifest + halo-plan arrays) in this directory; "
                         "halo planning chunks the edge stream against the "
                         "assignment memmap (O(chunk + plan) peak)")
    ap.add_argument("--no-plan", action="store_true",
                    help="with --artifact-dir: skip the halo-plan arrays "
                         "(assignment + manifest only, no planning sweep)")
    ap.add_argument("--local-graphs", action="store_true",
                    help="with --artifact-dir: additionally lower the "
                         "artifact into per-partition CSC/CSR serving "
                         "structure (local_csc_p*.npz, manifest format "
                         "v3) in one extra chunked sweep")
    ap.add_argument("--hosts", type=int, default=None,
                    help="lay the k partitions out on this many host "
                         "groups (must divide --k): reports the cross-host "
                         "replication factor, enables --dcn-penalty, and "
                         "with --artifact-dir also persists the "
                         "host-grouped two-level exchange layout")
    ap.add_argument("--dcn-penalty", type=float, default=0.0,
                    help="with --hosts: hierarchy-aware scoring penalty "
                         "per endpoint missing from a candidate's host "
                         "group (0 = flat scoring)")
    ap.add_argument("--plan-json", default=None,
                    help="write a DGL-style partition manifest (halo-plan "
                         "capacities + replication factor) to this path; "
                         "capacities are planned out-of-core over the "
                         "edge stream")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="engine in-flight chunk budget (default: the "
                         "spec's; 1 = fully synchronous)")
    ap.add_argument("--scoring-backend", default=None,
                    choices=("jnp", "pallas"),
                    help="recorded in the spec (the reference package's "
                         "scoring implementation); the port's route is "
                         "--device")
    ap.add_argument("--pair-cap-quantile", type=float, default=1.0,
                    help="halo-plan boundary-table cap quantile (<1 moves "
                         "over-cap pairs to the all-reduce overflow lane)")
    ap.add_argument("--throttle-mbps", type=float, default=None,
                    help="simulate a storage device with this read rate")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    metavar="N",
                    help="write a crash-safe engine checkpoint every N "
                         "chunks (drains the pipeline, snapshots the "
                         "O(|V|) pass state atomically)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="where checkpoints live (default: "
                         "<artifact-dir>/checkpoints when --artifact-dir "
                         "is given)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in "
                         "--checkpoint-dir (fresh run if none); the "
                         "resumed run's final assignment is identical to "
                         "an uninterrupted one")
    ap.add_argument("--io-retries", type=int, default=None, metavar="R",
                    help="validate every chunk read and retry failures up "
                         "to R times with bounded backoff "
                         "(io_retries in the report and manifest)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record spans (pipeline stages per chunk, halo "
                         "planning, passes) and metrics to a Chrome "
                         "trace_event JSON at PATH; identical output")
    ap.add_argument("--trace-summary", action="store_true",
                    help="print the per-stage stall table (busy/idle "
                         "fractions, critical stage) after the run; "
                         "implies tracing, goes to stderr under --json")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="additionally capture a torch.profiler trace of "
                         "the run (CPU, and the card's kernels) into DIR "
                         f"as {obs.TORCH_TRACE_FILE}; raises if the "
                         "profiler cannot run")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.hosts is not None and args.artifact_dir and args.no_plan:
        ap.error("--hosts with --artifact-dir persists the host plan, "
                 "which needs the halo plan --no-plan skips")
    if args.local_graphs and not args.artifact_dir:
        ap.error("--local-graphs lowers an artifact; pass --artifact-dir")
    if args.dcn_penalty and args.hosts is None:
        ap.error("--dcn-penalty needs --hosts (the penalty is defined per "
                 "host group)")
    checkpoint_dir = args.checkpoint_dir
    if checkpoint_dir is None and args.artifact_dir and (
            args.checkpoint_every or args.resume):
        checkpoint_dir = os.path.join(args.artifact_dir, "checkpoints")
    if (args.checkpoint_every or args.resume) and checkpoint_dir is None:
        ap.error("--checkpoint-every/--resume need --checkpoint-dir "
                 "(or --artifact-dir to default it)")
    device = resolve_device(args.device)

    overrides = {"alpha": args.alpha, "chunk_size": args.chunk_size}
    if SPEC_REGISTRY[args.algorithm][0] is TwoPSLSpec:
        overrides["cluster_passes"] = args.cluster_passes
    if args.hosts is not None:
        overrides["host_groups"] = args.hosts
        overrides["dcn_penalty"] = args.dcn_penalty
    if args.pipeline_depth is not None:
        overrides["pipeline_depth"] = args.pipeline_depth
    if args.scoring_backend is not None:
        overrides["scoring_backend"] = args.scoring_backend
    if args.memory_budget_bytes is not None:
        overrides["memory_budget_bytes"] = args.memory_budget_bytes
    if args.buffer_edges is not None:
        overrides["buffer_edges"] = args.buffer_edges
    # the spec itself is the validator: algorithms reject knobs they do
    # not have (TypeError) or cannot honor (SpecError)
    try:
        spec = spec_for(args.algorithm, **overrides)
    except (SpecError, TypeError) as e:
        ap.error(str(e))

    stream = MemmapEdgeStream(args.input)
    if args.throttle_mbps:
        stream = ThrottledEdgeStream(stream, args.throttle_mbps * 1e6)

    out_path = args.out
    if args.artifact_dir and out_path is None:
        # stream the assignment straight into the artifact layout
        os.makedirs(args.artifact_dir, exist_ok=True)
        out_path = os.path.join(args.artifact_dir, ASSIGNMENT_FILE)

    # tracing covers the whole run — partitioning passes AND the halo /
    # host planning the artifact save triggers — so the artifact manifest
    # carries the stall report and the trace shows planning spans too
    traced = bool(args.trace or args.trace_summary or args.torch_profile)
    tracer = obs.Tracer() if traced else obs.NULL_TRACER
    registry = obs.MetricsRegistry() if traced else obs.NULL_REGISTRY
    with obs.torch_profiler_session(args.torch_profile,
                                    cuda=device.type == "cuda"), \
            obs.use_tracer(tracer), obs.use_registry(registry):
        retry_policy = None
        if args.io_retries is not None:
            from repro_torch.robust import RetryPolicy
            retry_policy = RetryPolicy(max_retries=args.io_retries)
        res = run_spec(spec, stream, args.k, device=device,
                       out_path=out_path, retry_policy=retry_policy,
                       checkpoint_every_chunks=args.checkpoint_every,
                       checkpoint_dir=checkpoint_dir,
                       resume_from=checkpoint_dir if args.resume else None)

        report = {
            "algorithm": res.name, "k": args.k,
            "edges": stream.num_edges, "vertices": stream.num_vertices,
            "replication_factor": res.quality.replication_factor,
            "alpha_measured": res.quality.balance,
            "timings_s": {k: round(v, 3) for k, v in res.timings.items()},
            "simulated_io_s": round(res.simulated_io_seconds, 3),
            "device": str(device),
            **{k: v for k, v in res.extras.items()
               if isinstance(v, (int, float, str))},
        }
        plan = None
        if args.artifact_dir:
            # out-of-core planning: re-stream the graph chunk by chunk
            # against the just-written assignment memmap (planning pays no
            # simulated IO, so hand it the raw memmap stream)
            plan_stream = (None if args.no_plan else
                           MemmapEdgeStream(
                               args.input,
                               num_vertices=stream.num_vertices))
            art = PartitionArtifact.save(
                args.artifact_dir, res, num_vertices=stream.num_vertices,
                num_edges=stream.num_edges, stream=plan_stream,
                pair_cap_quantile=args.pair_cap_quantile,
                host_groups=args.hosts, graph_path=args.input)
            report["artifact_dir"] = args.artifact_dir
            if args.local_graphs:
                from repro_torch.sample import build_local_graphs
                graphs = build_local_graphs(
                    art, stream=MemmapEdgeStream(
                        args.input, num_vertices=stream.num_vertices),
                    chunk_size=args.chunk_size)
                report["local_graphs"] = len(graphs)
            if art.has_halo_plan():
                plan = art.halo_plan()
                report["b_cap"] = plan.b_cap
            if art.has_host_plan():
                report["host_plan"] = art.host_halo_plan().dcn_summary()
        if args.plan_json:
            # reuse the plan computed for the artifact (same quantile)
            # rather than running the O(|E|) planning core a second time
            manifest = _partition_manifest(args, res, stream, plan,
                                           out_path)
            with open(args.plan_json, "w") as f:
                json.dump(manifest, f, indent=2)
            report["plan_json"] = args.plan_json
            report["v_cap"] = manifest["halo_plan"]["v_cap"]
            report["b_cap"] = manifest["halo_plan"]["b_cap"]

    stall = res.extras.get("stall_report")
    if stall is not None:
        report["critical_stage"] = stall["critical_stage"]
    if args.trace:
        obs.write_chrome_trace(args.trace, tracer, metadata={
            "spec": spec.to_dict(), "k": args.k, "input": args.input,
            "metrics": registry.snapshot()})
        report["trace"] = args.trace
    if args.torch_profile:
        report["torch_profile"] = args.torch_profile

    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for k, v in report.items():
            print(f"{k:24s} {v}")
    if args.trace_summary and stall is not None:
        # under --json keep stdout machine-parseable: table -> stderr
        table = obs.trace_summary_table(stall, registry.snapshot())
        print(table, file=sys.stderr if args.json else sys.stdout)
    return res


def _partition_manifest(args, res, stream, plan=None,
                        out_path=None) -> dict:
    """DGL partition-book shape: one JSON describing every part, plus the
    halo-plan capacity envelope the distributed runtime allocates from."""
    from repro_torch.dist.partitioned_gnn import (capacities_from_plan,
                                                  plan_capacities_stream)

    if plan is not None:
        caps = capacities_from_plan(plan)
    else:
        caps = plan_capacities_stream(
            MemmapEdgeStream(args.input, num_vertices=stream.num_vertices),
            res.assignment, stream.num_vertices, args.k,
            args.pair_cap_quantile)
    return {
        "graph_name": args.input,
        "part_method": res.name,
        "num_parts": args.k,
        "num_nodes": stream.num_vertices,
        "num_edges": stream.num_edges,
        "assignment_path": out_path if out_path is not None else args.out,
        "replication_factor": caps["replication_factor"],
        "halo_plan": {kk: caps[kk] for kk in
                      ("v_cap", "e_cap", "b_cap", "o_cap", "pair_mean",
                       "covered_vertices")},
        "parts": [{"part_id": p, "num_edges": n}
                  for p, n in enumerate(caps["edge_counts"])],
    }


if __name__ == "__main__":
    main()
