"""Out-of-core demonstration with the PyTorch port: partition a graph
straight from disk, multiple passes over a memmap'd binary edge list, and
show the paper's headline scaling: 2PS-L runtime is flat in k while HDRF
grows linearly.  Finishes by persisting one run as a ``PartitionArtifact``
and reloading its cached halo plan — the partition -> plan handoff without
a second pass over the graph.

    PYTHONPATH=src python examples_torch/out_of_core_partition.py \\
        [--device cpu]

Runs on the CUDA device by default and raises without one; ``--device cpu``
runs the kernels' plain versions on the CPU.  The edge list stays on the
host; each pass streams its chunks to the device.
"""
import argparse
import os
import tempfile
import time

from repro_torch.core import (MemmapEdgeStream, PartitionArtifact,
                              resolve_device, run_spec, spec_for)
from repro_torch.data import rmat_graph

KS = (4, 32, 128)
ARTIFACT_K = 32


def specs() -> list:
    """(name, spec) of each column of the table, in the printed order."""
    return [
        ("2psl", spec_for("2psl", chunk_size=1 << 15)),
        ("hdrf", spec_for("hdrf", chunk_size=4096)),
        ("dbh", spec_for("dbh")),
    ]


def write_stream(directory: str) -> MemmapEdgeStream:
    """RMAT-14 written to ``directory/graph.bin`` and opened as a memmapped
    stream."""
    edges = rmat_graph(14, edge_factor=16, seed=0)
    return MemmapEdgeStream.write(os.path.join(directory, "graph.bin"),
                                  edges)


def k_sweep(stream, device):
    """Yields ``(k, {name: (seconds, result)})`` for each k of ``KS`` as
    its runs end.  Each timed run follows a warm-up run (the kernels'
    first load, the allocator's growth); the clock stops after the
    assignment's copy to the host, so after the device's work."""
    for k in KS:
        runs = {}
        for name, spec in specs():
            run_spec(spec, stream, k, device=device)
            t0 = time.perf_counter()
            res = run_spec(spec, stream, k, device=device)
            runs[name] = (time.perf_counter() - t0, res)
        yield k, runs


def save_and_reload(stream, directory: str, device):
    """One 2PS-L run at ``ARTIFACT_K`` saved as a ``PartitionArtifact`` in
    ``directory/artifact`` with its halo plan built from the stream (out of
    core), then loaded back: (artifact, its cached halo plan, seconds the
    plan took to load)."""
    res = run_spec(spec_for("2psl", chunk_size=1 << 15), stream,
                   ARTIFACT_K, device=device)
    art_dir = os.path.join(directory, "artifact")
    PartitionArtifact.save(
        art_dir, res, num_vertices=stream.num_vertices,
        num_edges=stream.num_edges, stream=stream,   # out-of-core plan
        graph_path=stream.path)
    art = PartitionArtifact.load(art_dir)
    t0 = time.perf_counter()
    plan = art.halo_plan()                 # cached — no graph IO
    return art, plan, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as d:
        stream = write_stream(d)
        print(f"wrote {os.path.getsize(stream.path)/2**20:.1f} MiB edge "
              f"list (|V|={stream.num_vertices:,} "
              f"|E|={stream.num_edges:,})\n")
        print(f"{'k':>5s} {'2PS-L s':>9s} {'HDRF s':>9s} {'DBH s':>9s} "
              f"{'rf(2PS-L)':>10s} {'rf(HDRF)':>9s} {'rf(DBH)':>8s}")
        for k, rows in k_sweep(stream, device):
            rf = {n: res.quality.replication_factor
                  for n, (_, res) in rows.items()}
            print(f"{k:5d} {rows['2psl'][0]:9.2f} {rows['hdrf'][0]:9.2f} "
                  f"{rows['dbh'][0]:9.2f} {rf['2psl']:10.3f} "
                  f"{rf['hdrf']:9.3f} {rf['dbh']:8.3f}")
        print("\n2PS-L column is ~flat in k (the paper's O(|E|) claim); "
              "HDRF grows with k (O(|E|*k)).")

        # ---- persist one run as a reusable artifact -------------------
        art, plan, dt = save_and_reload(stream, d, device)
        print(f"\nartifact reload: spec={art.spec.algorithm} "
              f"rf={art.manifest['replication_factor']:.3f}; cached halo "
              f"plan (b_cap={plan.b_cap}) loaded in {dt*1e3:.0f} ms "
              f"without re-streaming the edge list")


if __name__ == "__main__":
    main()
