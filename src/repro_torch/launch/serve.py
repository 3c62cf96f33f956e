"""Serving launcher of the port: DIEN CTR scoring on the card.

  python -m repro_torch.launch.serve --arch dien --requests 512 --full --json

Scores ``--requests`` requests in one batch, drawn from the synthetic
``InteractionStream`` with ``--seed`` (which also seeds the weights), and
prints the reference's report (``arch``, ``mode``, ``requests``,
``mean_ctr``).  ``--full`` serves the published configuration (2,097,152
items, embed 18, seq 100, GRU 108, MLP 200-80) instead of the smoke one.
Runs on ``--device`` (``cuda`` by default; a missing card raises instead of
falling back).  The reference's LM decode and ``--gnn-artifact`` serving
come with the slices that port them and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_arch
from repro_torch.core import resolve_device
from repro_torch.data import InteractionStream
from repro_torch.launch import steps as S
from repro_torch.models import recsys as R

_SERVE_KEYS = ("hist", "hist_mask", "target")


def recsys_request(arch_id: str = "dien", *, batch: int = 64, seed: int = 0,
                   full: bool = False, device="cuda"):
    """(config, weights, one batch of ``batch`` requests as tensors on
    ``device``): what ``serve_recsys`` scores."""
    device = resolve_device(device)
    spec = get_arch(arch_id)
    cfg = spec.make_config() if full else spec.make_smoke_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = R.dien_init(cfg, gen)
    stream = InteractionStream(cfg.n_items, batch, cfg.seq_len, seed=seed)
    b = stream.next_batch()
    return cfg, params, {k: torch.from_numpy(b[k]).to(device)
                         for k in _SERVE_KEYS}


def serve_recsys(arch_id: str = "dien", *, batch: int = 64, seed: int = 0,
                 full: bool = False, device="cuda"):
    cfg, params, request = recsys_request(arch_id, batch=batch, seed=seed,
                                          full=full, device=device)
    serve = S.make_recsys_serve_step(cfg)
    scores = serve(params, request)
    mean_ctr = float(scores.mean())
    print(f"{arch_id}: scored {batch} requests, mean CTR {mean_ctr:.4f}")
    return scores, {"arch": arch_id, "mode": "recsys", "requests": batch,
                    "mean_ctr": round(mean_ctr, 6)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dien")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--full", action="store_true",
                    help="serve the published configuration instead of "
                         "the smoke one")
    ap.add_argument("--gnn-artifact", default=None,
                    help="(not ported yet) serve ego-network queries "
                         "against a PartitionArtifact dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    ap.add_argument("--json", action="store_true",
                    help="print a machine-readable report (one JSON object)")
    args = ap.parse_args(argv)
    if args.gnn_artifact is not None:
        raise NotImplementedError(
            "GNN serving (--gnn-artifact) is not ported to repro_torch yet: "
            "see ROADMAP.md Queue 1 item 10")
    family = get_arch(args.arch).family
    if family != "recsys":
        raise NotImplementedError(
            f"{family} serving is not ported to repro_torch yet")
    _, report = serve_recsys(args.arch, batch=args.requests, seed=args.seed,
                             full=args.full, device=args.device)
    if args.json:
        print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
