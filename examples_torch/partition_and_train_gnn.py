"""End-to-end driver with the PyTorch port: 2PS-L partitioning feeding
distributed GNN training.

This is the paper's motivating pipeline (§I: DGL/ROC/P^3): the partitioner
decides which edges live on which worker, and the replication factor sets
the per-layer synchronization volume.  We partition a synthetic community
graph with 2PS-L and with random hashing, report the communication each
one would induce, then train a GIN on the graph.

    PYTHONPATH=src python examples_torch/partition_and_train_gnn.py \\
        [--device cpu]

Runs on the CUDA device by default and raises without one; ``--device cpu``
runs the kernels' plain versions on the CPU.

Multi-host layouts: when the k workers span several hosts, cross-host
(DCN) traffic dominates, so ``plan_halo_exchange`` followed by
``host_plan_from_halo(plan, host_groups=H)`` (CLI: ``python -m
repro_torch.launch.partition --artifact-dir DIR --hosts H``) re-slices the
exchange into an intra-host exchange plus per-host-pair AGGREGATED lanes:
each boundary vertex crosses the DCN once per host pair instead of once
per partition pair.  The report below shows the DCN rows the aggregation
saves on this graph.

Host-AWARE partitioning goes one step further: ``spec_for("2psl",
host_groups=H, dcn_penalty=P)`` (CLI: ``--hosts H --dcn-penalty P``) feeds
the host layout into the scoring pass itself, so candidates that would
open a new DCN lane for a vertex pay P per missing endpoint.  The demo
checks the reduction end to end: cross-host replication factor AND
aggregated DCN rows strictly below flat 2PS-L at equal k, with balance
still inside the spec's capacity bound.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import (InMemoryEdgeStream, capacity, resolve_device,
                              run_spec, spec_for)
from repro_torch.core.integration import (build_device_shards,
                                          comm_volume_per_layer)
from repro_torch.data.gnn_batches import full_graph_batch
from repro_torch.dist.multihost import host_plan_from_halo
from repro_torch.dist.partitioned_gnn import (plan_capacities,
                                              plan_halo_exchange)
from repro_torch.launch import steps as S
from repro_torch.models.gnn import GINConfig, params_to
from repro_torch.optim import adamw_init

K = 8                           # simulated workers
D_FEAT, N_CLASSES = 64, 8
HOSTS = 2
TRAIN_STEPS = 200


def make_graph() -> dict:
    """The 4,096-node, 40,000-edge community graph as a numpy batch."""
    return full_graph_batch(4096, 40000, D_FEAT, n_classes=N_CLASSES,
                            seed=0)


def partition_report(edges: np.ndarray, stream, device) -> dict:
    """2PS-L and random hashing at ``K``: per spec name the run's result,
    replication factor, per-layer sync bytes and halo capacities."""
    out = {}
    for spec in (spec_for("2psl", chunk_size=1 << 14), spec_for("random")):
        res = run_spec(spec, stream, K, device=device)
        asg = np.asarray(res.assignment)
        sh = build_device_shards(edges, asg, stream.num_vertices, K)
        out[spec.algorithm] = {
            "result": res, "rf": sh.replication_factor,
            "sync_bytes": comm_volume_per_layer(sh, d_hidden=64),
            # the halo-exchange capacity envelope a partitioned step would
            # allocate for this placement: b_cap bounds the per-pair
            # payload each GNN layer actually moves
            "caps": plan_capacities(edges, asg, stream.num_vertices, K)}
    return out


def dcn_summary(edges: np.ndarray, assignment, num_vertices: int) -> dict:
    """The host plan's DCN summary of ``assignment``: the k workers on
    ``HOSTS`` hosts of k / ``HOSTS`` devices."""
    return host_plan_from_halo(
        plan_halo_exchange(edges, np.asarray(assignment), num_vertices, K),
        host_groups=HOSTS).dcn_summary()


def host_aware_run(edges: np.ndarray, stream, device):
    """Host-aware 2PS-L at ``K`` on ``HOSTS`` hosts: (spec, result, its DCN
    summary)."""
    spec = spec_for("2psl", chunk_size=1 << 14, host_groups=HOSTS,
                    dcn_penalty=1.0)
    res = run_spec(spec, stream, K, device=device)
    return spec, res, dcn_summary(edges, res.assignment, stream.num_vertices)


def gin_config() -> GINConfig:
    return GINConfig(name="gin", d_in=D_FEAT, n_classes=N_CLASSES)


def train_gin(base: dict, device, *, state=None, steps: int = TRAIN_STEPS):
    """``steps`` full-graph GIN train steps (lr 2e-3) on ``base``; unless a
    state is given, the parameters are drawn from a CPU generator seeded 0
    and moved to ``device`` (the card and the CPU start from the same
    ones).  The state is updated in place.  Returns (losses, seconds,
    state, step, batch); the clock stops after the last loss's copy to the
    host."""
    cfg = gin_config()
    if state is None:
        params = params_to(S.gnn_init(cfg, torch.Generator().manual_seed(0)),
                           device)
        state = {"params": params, "opt": adamw_init(params)}
    step = S.make_gnn_train_step(cfg, "full", lr=2e-3)
    batch = {kk: torch.as_tensor(v, device=device)
             for kk, v in base.items() if v is not None}
    t0, losses = time.perf_counter(), []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, time.perf_counter() - t0, state, step, batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = make_graph()
    edges = np.asarray(base["edges"])
    stream = InMemoryEdgeStream(edges)
    print(f"graph: |V|={stream.num_vertices:,} |E|={stream.num_edges:,}")

    # ---- partition with 2PS-L and with hashing ----
    report = partition_report(edges, stream, device)
    for name, r in report.items():
        caps = r["caps"]
        print(f"{name:7s} rf={r['rf']:6.3f} "
              f"sync={r['sync_bytes']/2**20:8.2f} MiB/layer  halo-plan: "
              f"v_cap={caps['v_cap']} e_cap={caps['e_cap']} "
              f"b_cap={caps['b_cap']} (mean pair {caps['pair_mean']:.1f})")
    flat, rand = report["2psl"], report["random"]
    b_ratio = rand["caps"]["b_cap"] / max(flat["caps"]["b_cap"], 1)
    print(f"2PS-L cuts per-layer sync "
          f"{rand['sync_bytes']/flat['sync_bytes']:.2f}x "
          f"and the boundary lane {b_ratio:.2f}x vs hashing")

    # ---- multi-host layout: the k workers on 2 hosts of k/2 devices ----
    dcn = dcn_summary(edges, flat["result"].assignment, stream.num_vertices)
    print(f"2 hosts: aggregated DCN lanes ship "
          f"{dcn['dcn_rows_aggregated']} rows/layer vs "
          f"{dcn['dcn_rows_naive']} pairwise "
          f"({dcn['dcn_aggregation_ratio']:.2f}x less DCN traffic)")

    # ---- host-AWARE 2PS-L: shrink those lanes at partition time ----
    hosted_spec, hosted, hosted_dcn = host_aware_run(edges, stream, device)
    print(f"host-aware 2PS-L (dcn_penalty={hosted_spec.dcn_penalty}): "
          f"cross-host rf {dcn['cross_host_rf']:.4f} -> "
          f"{hosted_dcn['cross_host_rf']:.4f}, DCN rows/layer "
          f"{dcn['dcn_rows_aggregated']} -> "
          f"{hosted_dcn['dcn_rows_aggregated']}, "
          f"alpha={hosted.quality.balance:.3f}")
    assert hosted_dcn["cross_host_rf"] < dcn["cross_host_rf"], \
        "host-aware scoring failed to reduce cross-host replication"
    assert (hosted_dcn["dcn_rows_aggregated"]
            < dcn["dcn_rows_aggregated"]), \
        "host-aware scoring failed to shrink the DCN lanes"
    assert hosted.quality.max_partition <= capacity(
        stream.num_edges, K, hosted_spec.alpha), "capacity bound violated"
    print()

    # ---- train the GIN on the (2PS-L partitioned) graph ----
    losses, seconds, *_ = train_gin(base, device)
    print(f"trained {TRAIN_STEPS} steps in {seconds:.1f}s: "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0] * 0.7, "training failed to converge"


if __name__ == "__main__":
    main()
