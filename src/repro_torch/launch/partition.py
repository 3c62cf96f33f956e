"""Partitioning CLI on the card — the paper's tool: partition a binary edge
list out-of-core.

  python -m repro_torch.launch.partition --input graph.bin --k 32 \\
      --algorithm 2psl --out assign.bin --json

Reads the paper's binary format (pairs of little-endian uint32 vertex ids),
builds the ``PartitionerSpec`` for ``--algorithm``, and streams the graph
through the port's engine on ``--device`` (``cuda`` by default; a missing
card raises instead of falling back), printing the paper's metrics.

* ``--out PATH``          the int32 per-edge assignment memmap, byte-equal
                          to the reference CLI's ``--out`` for the same
                          flags.
* ``--hosts H``           lays the k partitions out on H host groups and
                          reports the cross-host replication factor.
* ``--dcn-penalty P``     (with ``--hosts``) makes the scoring pass
                          hierarchy-aware (0 = flat scoring).
* ``--memory-budget-bytes B``  (hep) the byte budget of the pinned
                          hot-vertex rows.
* ``--buffer-edges N``    (buffered) edges per re-streaming window.

``--algorithm`` takes every registered partitioner: 2PS-L and 2PS-HDRF
(which also take ``--cluster-passes``), HDRF, Greedy, DBH, Grid, Random,
HEP and buffered re-streaming.  The reference's artifact, plan,
checkpoint, retry and trace flags come with the slices that port them.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core import (PORTED, SPEC_REGISTRY, MemmapEdgeStream,
                              SpecError, TwoPSLSpec, resolve_device, run_spec,
                              spec_for)


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
                         "chunk) chunks per window")
    ap.add_argument("--out", default=None,
                    help="write int32 assignment memmap here")
    ap.add_argument("--hosts", type=int, default=None,
                    help="lay the k partitions out on this many host "
                         "groups (must divide --k): reports the cross-host "
                         "replication factor and enables --dcn-penalty")
    ap.add_argument("--dcn-penalty", type=float, default=0.0,
                    help="with --hosts: hierarchy-aware scoring penalty "
                         "per endpoint missing from a candidate's host "
                         "group (0 = flat scoring)")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="engine in-flight chunk budget (default: the "
                         "spec's; 1 = fully synchronous)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.dcn_penalty and args.hosts is None:
        ap.error("--dcn-penalty needs --hosts (the penalty is defined per "
                 "host group)")
    device = resolve_device(args.device)

    overrides = {"alpha": args.alpha, "chunk_size": args.chunk_size}
    if SPEC_REGISTRY[args.algorithm][0] is TwoPSLSpec:
        overrides["cluster_passes"] = args.cluster_passes
    if args.hosts is not None:
        overrides["host_groups"] = args.hosts
        overrides["dcn_penalty"] = args.dcn_penalty
    if args.pipeline_depth is not None:
        overrides["pipeline_depth"] = args.pipeline_depth
    if args.memory_budget_bytes is not None:
        overrides["memory_budget_bytes"] = args.memory_budget_bytes
    if args.buffer_edges is not None:
        overrides["buffer_edges"] = args.buffer_edges
    try:
        spec = spec_for(args.algorithm, **overrides)
    except (SpecError, TypeError) as e:
        ap.error(str(e))

    stream = MemmapEdgeStream(args.input)
    res = run_spec(spec, stream, args.k, device=device, out_path=args.out)
    report = {
        "algorithm": res.name, "k": args.k,
        "edges": stream.num_edges, "vertices": stream.num_vertices,
        "replication_factor": res.quality.replication_factor,
        "alpha_measured": res.quality.balance,
        "timings_s": {k: round(v, 3) for k, v in res.timings.items()},
        "device": str(device),
        **{k: v for k, v in res.extras.items()
           if isinstance(v, (int, float, str))},
    }
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for k, v in report.items():
            print(f"{k:24s} {v}")
    return res


if __name__ == "__main__":
    main()
