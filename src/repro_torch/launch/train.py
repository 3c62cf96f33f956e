"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[...]``, the counterpart of ``python -m repro.launch.train``.

Runs the fault-tolerant training loop (checkpoint/restart, straggler
watchdog) for the LM (the dense and the MoE architectures, whose loss adds
the load-balancing aux), GNN and DIEN families on one device: the card by
default (``--device cuda``; raises without one), the CPU when asked.  It
takes every flag of the reference's launcher and prints the same
``arch=... steps=... first_loss=... last_loss=... restarts=...
stragglers=...`` line and, resuming, ``resuming from checkpoint step N``.
The weights are drawn from a CPU ``torch.Generator`` of the seed (the card
and the CPU start from the same state; ``torch.Generator`` cannot
reproduce ``jax.random``); the data are the reference's numpy streams.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core import resolve_device
from repro_torch.launch import steps as S
from repro_torch.runtime import (FailureInjector, StepWatchdog,
                                 TrainLoopRunner, load_into)


def _tensors(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if v is not None}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def build_trainer(arch_id: str, *, smoke: bool = True, seed: int = 0,
                  batch_size: int | None = None, device="cuda"):
    """(state, step, batch_fn) of ``arch_id`` on ``device``: the state
    drawn on the CPU from ``seed`` and moved, the family's train step, and
    ``batch_fn(i)`` (the reference's streams, seeded by step for the LM
    and DIEN; one graph batch for the GNNs, prepared once)."""
    device = resolve_device(device)
    spec = get_arch(arch_id)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    state = _to(S.init_state(spec.family, cfg,
                             torch.Generator().manual_seed(seed)), device)

    if spec.family == "lm":
        from repro_torch.data.lm_data import TokenStream
        step = S.make_lm_train_step(cfg)

        def batch_fn(i):
            s = TokenStream(cfg.vocab, batch_size or 8, 64, seed=seed + i)
            return _tensors(s.next_batch(), device)

    elif spec.family == "gnn":
        from repro_torch.data.gnn_batches import full_graph_batch
        is_nequip = cfg.__class__.__name__ == "NequIPConfig"
        base = full_graph_batch(512, 4096, getattr(cfg, "d_in", 16) or 16,
                                n_classes=getattr(cfg, "n_classes", 4),
                                seed=seed, with_coords=True)
        if is_nequip:
            base["nodes"] = (np.abs(base["nodes"][:, 0] * 7).astype(np.int32)
                             % cfg.n_species)
            base["energy_target"] = np.zeros(1, np.float32)
        batch0 = _tensors(base, device)
        step = S.make_gnn_train_step(cfg, "full")

        def batch_fn(i):
            return batch0

    else:  # recsys
        from repro_torch.data.recsys_data import InteractionStream
        step = S.make_recsys_train_step(cfg)

        def batch_fn(i):
            s = InteractionStream(cfg.n_items, batch_size or 32,
                                  cfg.seq_len, seed=seed + i)
            return _tensors(s.next_batch(), device)

    return state, step, batch_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-interval", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-step train_step spans (each waits "
                         "for the step's kernels) to a Chrome trace_event "
                         "JSON at PATH — see docs/observability.md")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    args = ap.parse_args(argv)

    tracer = obs.Tracer() if args.trace else obs.NULL_TRACER
    device = resolve_device(args.device)

    state, step, batch_fn = build_trainer(
        args.arch, smoke=not args.full, batch_size=args.batch_size,
        device=device)
    if tracer.enabled:
        inner_step = step

        def step(st, batch):
            with tracer.span("train_step", cat="launch"):
                out = inner_step(st, batch)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            return out
    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
    injector = (FailureInjector([args.inject_failure_at])
                if args.inject_failure_at is not None else None)
    runner = TrainLoopRunner(step, batch_fn, ckpt,
                             failure_injector=injector,
                             watchdog=StepWatchdog())

    restored, start = ckpt.restore_latest(state)
    if restored is not None:
        print(f"resuming from checkpoint step {start}")
        state = load_into(state, restored)
    else:
        start = 0

    with obs.use_tracer(tracer):
        state, metrics = runner.run(state, args.steps, start_step=start)
    if args.trace:
        obs.write_chrome_trace(args.trace, tracer,
                               metadata={"arch": args.arch,
                                         "steps": args.steps})
        print(f"trace written to {args.trace}")
    losses = [float(m["loss"]) for m in metrics]
    print(f"arch={args.arch} steps={len(metrics)} "
          f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f} "
          f"restarts={runner.restarts} "
          f"stragglers={len(runner.watchdog.events)}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump([{k: float(v) for k, v in m.items()} for m in metrics],
                      f)
    return state, metrics


if __name__ == "__main__":
    main()
