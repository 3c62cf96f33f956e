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
- ``hdrf_baselines``: ``hdrf_baselines`` at the tree's scale
  (``HDRF_BASELINES_SCALE``; a tree without it runs them at RMAT-15,
  their scale before the constant), its graph made first;
- ``card_vs_cpu``: the full run's card-against-CPU phase, with its HDRF
  family (``CARD_VS_CPU_HDRF``; a tree without it runs 2PS-HDRF, HDRF and
  Greedy), HEP, buffered and artifact runs, at the full run's scales;
- ``hosted``, ``two_ps_hdrf``, ``buffered``: those paths at the tree's
  scales (``HOSTED_SCALE``, ``TWO_PS_HDRF_SCALE``, ``BUFFERED_SCALE``; a
  tree without them runs each at RMAT-18, their scale before the
  constants), each graph made first and not timed;
- ``moe_serve``: ``moe_serve``;
- ``sharded_train``: ``sharded_train`` (its worker process);
- ``dryrun``: ``dryrun_phase`` (its worker process started and waited
  for, without ``sharded_train``'s line); a tree without the phase
  prints ``"seconds": null``;
- ``examples``: ``examples_phase`` (the four twins of ``examples_torch/``
  on the card, their CPU worker started and waited for first, its seconds
  counted); a tree without the phase prints ``"seconds": null``.

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

PHASES = ("shard", "hdrf_baselines", "card_vs_cpu", "moe_serve",
          "sharded_train", "dryrun", "examples", "hosted", "two_ps_hdrf",
          "buffered")
#: the path phases timed at a tree's scale: (constant, scale before it,
#: the function)
PATHS = {"hdrf_baselines": ("HDRF_BASELINES_SCALE", 15, "hdrf_baselines"),
         "hosted": ("HOSTED_SCALE", 18, "hosted_path"),
         "two_ps_hdrf": ("TWO_PS_HDRF_SCALE", 18, "two_ps_hdrf_path"),
         "buffered": ("BUFFERED_SCALE", 18, "buffered_path")}
#: each phase's function in ``chip_smoke``, where a tree may lack it
NEWER = {"dryrun": "dryrun_phase", "examples": "examples_phase"}


def run_phase(C, name: str):
    """One phase of ``chip_smoke`` module ``C``, as its ``main`` calls it
    at the default ``--scale`` of 20; the phase's seconds where they leave
    out its set-up (None: time the call)."""
    if name == "shard":
        with tempfile.TemporaryDirectory() as tmp:
            C.shard_path(tmp)
    elif name == "card_vs_cpu":
        C.card_vs_cpu(16, busy_edges=1 << 18)
        for algo in getattr(C, "CARD_VS_CPU_HDRF",
                            ("2ps-hdrf", "hdrf", "greedy")):
            C.card_vs_cpu(14, algo, busy_edges=1 << 15)
        for algo, kw in (("hep", {}),
                         ("hep", {"memory_budget_bytes": C.HEP_SMALL_BUDGET}),
                         ("hep", {"memory_budget_bytes": 8192}),
                         ("buffered", {})):
            C.card_vs_cpu(14, algo, busy_edges=1 << 15, **kw)
        C.artifact_card_vs_cpu(14)
    elif name in PATHS:
        constant, before, fn = PATHS[name]
        scale = getattr(C, constant, before)
        with tempfile.TemporaryDirectory() as tmp:
            C.write_graph(scale, tmp)
            t0 = time.perf_counter()
            getattr(C, fn)(scale, tmp)
            return time.perf_counter() - t0
    elif name == "sharded_train":
        with tempfile.TemporaryDirectory() as tmp:
            C.sharded_train(tmp)
    elif name == "dryrun":
        with tempfile.TemporaryDirectory() as tmp:
            C.dryrun_phase(tmp)
    elif name == "examples":
        with tempfile.TemporaryDirectory() as tmp:
            C.examples_phase(tmp)
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
        if name in NEWER and not hasattr(C, NEWER[name]):
            print(json.dumps({"root": root, "phase": name, "seconds": None}),
                  flush=True)
            continue
        t0 = time.perf_counter()
        seconds = run_phase(C, name)
        print(json.dumps({"root": root, "phase": name,
                          "seconds": seconds or time.perf_counter() - t0}),
              flush=True)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
