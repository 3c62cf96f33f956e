"""Quickstart: partition a graph with 2PS-L and compare against baselines,
with the PyTorch port on the card.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Runs on the CUDA device by default and raises without one; ``--device cpu``
runs the kernels' plain versions on the CPU.
"""
import argparse
import time

from repro_torch.core import (InMemoryEdgeStream, resolve_device, run_spec,
                              spec_for)
from repro_torch.data import planted_partition_graph, rmat_graph

K = 32


def graphs() -> dict:
    """The two graphs, by the name the script prints."""
    return {
        "social (R-MAT, power-law)": rmat_graph(13, edge_factor=16, seed=0),
        "web (planted communities)": planted_partition_graph(
            96, 96, 2500, 20000, seed=1),
    }


def specs() -> list:
    """(printed label, spec) of each partitioner, in the printed order."""
    return [
        ("2PS-L   ", spec_for("2psl", chunk_size=1 << 14)),
        ("HDRF    ", spec_for("hdrf", chunk_size=4096)),
        ("DBH     ", spec_for("dbh")),
        ("random  ", spec_for("random")),
    ]


def timed_run(spec, stream, k: int, device):
    """(result, seconds) of one ``run_spec``, after one warm-up run (the
    kernels' first load, the allocator's growth).  The clock stops after
    the assignment's copy to the host, so after the device's work."""
    run_spec(spec, stream, k, device=device)
    t0 = time.perf_counter()
    res = run_spec(spec, stream, k, device=device)
    return res, time.perf_counter() - t0


def partition_rows(device):
    """Yields one dict per (graph, partitioner) as its run ends, in the
    printed order: graph name, label, stream, k, result and seconds."""
    for name, edges in graphs().items():
        stream = InMemoryEdgeStream(edges)
        for label, spec in specs():
            res, dt = timed_run(spec, stream, K, device)
            yield {"graph": name, "label": label, "stream": stream, "k": K,
                   "result": res, "seconds": dt}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("=== 2PS-L quickstart ===")
    graph = None
    for row in partition_rows(device):
        if row["graph"] != graph:
            graph, stream = row["graph"], row["stream"]
            print(f"\n--- {graph}: |V|={stream.num_vertices:,} "
                  f"|E|={stream.num_edges:,}  k={row['k']} ---")
        q = row["result"].quality
        print(f"{row['label']} rf={q.replication_factor:6.3f} "
              f"alpha={q.balance:5.3f}  {row['seconds']*1e3:7.1f} ms")
    print("\n2PS-L: near-HDRF quality at near-DBH runtime — the paper's "
          "headline result.")


if __name__ == "__main__":
    main()
