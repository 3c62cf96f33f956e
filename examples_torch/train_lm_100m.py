"""End-to-end LM training driver with the PyTorch port: a 154M-parameter
transformer (12 layers x 768, a 32k vocab), a few hundred steps on the
synthetic token stream, with fault-tolerant checkpointing.

    PYTHONPATH=src python examples_torch/train_lm_100m.py [--steps 300] \\
        [--device cpu]

Runs on the CUDA device by default and raises without one; ``--device cpu``
runs the kernels' plain versions on the CPU.
"""
import argparse
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import resolve_device
from repro_torch.data.lm_data import TokenStream
from repro_torch.launch import steps as S
from repro_torch.models.transformer import (TransformerConfig, init_params,
                                            params_to)
from repro_torch.optim import adamw_init
from repro_torch.runtime import StepWatchdog, TrainLoopRunner


def lm_100m() -> TransformerConfig:
    # 12L x 768 with a 32k vocab and untied embeddings: 154.1M params
    return TransformerConfig(
        name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=3072, vocab=32768, norm="rmsnorm", act="silu", gated_mlp=True)


def init_state(cfg: TransformerConfig, device, seed: int = 0) -> dict:
    """The train state: parameters drawn from a CPU generator seeded
    ``seed`` and moved to ``device`` (the card and the CPU start from the
    same ones), AdamW's moments at zero."""
    params = params_to(init_params(cfg, torch.Generator().manual_seed(seed)),
                       device)
    return {"params": params, "opt": adamw_init(params)}


def batch_fn(cfg: TransformerConfig, batch: int, seq: int, device):
    """``fn(i)``: step i's batch of the token stream seeded 1000 + i, on
    ``device`` (a replayed step gets the same batch)."""
    def fn(i):
        s = TokenStream(cfg.vocab, batch, seq, seed=1000 + i)
        return {k: torch.as_tensor(v, device=device)
                for k, v in s.next_batch().items()}
    return fn


def train(cfg: TransformerConfig, state: dict, steps: int, batches, device,
          ckpt_dir: str, *, interval: int = 100):
    """``steps`` steps of the LM train step (lr 6e-4) through
    ``TrainLoopRunner`` with a ``CheckpointManager`` saving every
    ``interval`` steps into ``ckpt_dir`` and a ``StepWatchdog``.  Returns
    (state, per-step metrics, seconds, runner); the clock stops after the
    last save's files are written and the device's work is done."""
    step = S.make_lm_train_step(cfg, lr=6e-4)
    ckpt = CheckpointManager(ckpt_dir, interval=interval)
    runner = TrainLoopRunner(step, batches, ckpt, watchdog=StepWatchdog())
    t0 = time.perf_counter()
    state, metrics = runner.run(state, steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return state, metrics, time.perf_counter() - t0, runner


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_100m()
    print(f"model: {cfg.name}  params={cfg.num_params()/1e6:.1f}M")
    state = init_state(cfg, device)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        state, metrics, dt, _ = train(
            cfg, state, args.steps,
            batch_fn(cfg, args.batch, args.seq, device), device, ckpt_dir)

    losses = [float(m["loss"]) for m in metrics]
    toks = args.steps * args.batch * args.seq
    print(f"{args.steps} steps, {toks/dt:,.0f} tok/s: "
          f"loss {losses[0]:.3f} -> {min(losses):.3f}")
    if args.steps >= 200:     # below that, warmup barely ramps the lr
        assert min(losses) < losses[0] - 0.5, "loss should fall >0.5 nats"
    else:
        assert min(losses) < losses[0], "loss should fall"


if __name__ == "__main__":
    main()
