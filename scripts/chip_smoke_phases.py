#!/usr/bin/env python
"""Time named phases of a tree's ``chip_smoke.py`` alone on one card.

    python3 scripts/chip_smoke_phases.py [--root DIR] PHASE [PHASE ...]

imports ``chip_smoke`` from DIR (this repository's root by default),
builds every kernel the full run builds from DIR's sources, then runs each
PHASE as the full run calls it, with nothing else on the card, and prints
one JSON line a phase, ``{"root": ..., "phase": ..., "seconds": ...}``,
then the card's name and power limit.  The phases:

- ``shard``: ``shard_path`` (it makes its own RMAT graph, which the full
  run's earlier phases have made by then);
- ``card_vs_cpu``: the full run's last phase, with its HDRF family, HEP,
  buffered and artifact runs, at the full run's scales;
- ``moe_serve``: ``moe_serve``.

The same phases of two trees timed in one card call (a commit and its
parent unpacked with ``git archive``, in the order parent, change, change,
parent) compare a cut of scale without the rest of the full run around
it.  It exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

PHASES = ("shard", "card_vs_cpu", "moe_serve")


def run_phase(C, name: str) -> None:
    """One phase of ``chip_smoke`` module ``C``, as its ``main`` calls it
    at the default ``--scale`` of 20."""
    if name == "shard":
        with tempfile.TemporaryDirectory() as tmp:
            C.shard_path(tmp)
    elif name == "card_vs_cpu":
        C.card_vs_cpu(16, busy_edges=1 << 18)
        for algo in ("2ps-hdrf", "hdrf", "greedy"):
            C.card_vs_cpu(14, algo, busy_edges=1 << 15)
        for algo, kw in (("hep", {}),
                         ("hep", {"memory_budget_bytes": C.HEP_SMALL_BUDGET}),
                         ("hep", {"memory_budget_bytes": 8192}),
                         ("buffered", {})):
            C.card_vs_cpu(14, algo, busy_edges=1 << 15, **kw)
        C.artifact_card_vs_cpu(14)
    else:
        C.moe_serve()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the tree whose chip_smoke.py "
        "runs (default: this repository)")
    ap.add_argument("phases", nargs="+", choices=PHASES)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke_phases: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as C
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.augru import kernel as ag
    from repro_torch.kernels.edge_score import kernel as es
    from repro_torch.kernels.embedding_bag import kernel as eb
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.hdrf_score import kernel as hs
    from repro_torch.kernels.spmm import kernel as sp
    cuda_build.build({es.NAME: es.SOURCE, hs.NAME: hs.SOURCE,
                      ag.NAME: ag.SOURCE, ag.BACKWARD_NAME: ag.BACKWARD_SOURCE,
                      fa.NAME: fa.SOURCE, fa.BACKWARD_NAME: fa.BACKWARD_SOURCE,
                      sp.NAME: sp.SOURCE, eb.NAME: eb.SOURCE})
    for name in args.phases:
        t0 = time.perf_counter()
        run_phase(C, name)
        print(json.dumps({"root": root, "phase": name,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
