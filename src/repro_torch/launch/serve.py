"""Serving launcher of the port: batched LM decode and DIEN CTR scoring on
the card.

  python -m repro_torch.launch.serve --arch starcoder2-3b --requests 4 \
      --max-new 16 --full --json
  python -m repro_torch.launch.serve --arch dien --requests 512 --full --json

An LM (``--arch`` starcoder2-3b, the default, minitron-8b or qwen1.5-110b)
decodes ``--max-new`` tokens greedily for ``--requests`` random prompts of
16 tokens, and prints the reference's report (``arch``, ``mode``,
``requests``, ``generated_tokens``, ``decode_s``, ``tokens_per_s``).  DIEN
scores ``--requests`` requests in one batch, drawn from the synthetic
``InteractionStream``, and prints ``arch``, ``mode``, ``requests`` and
``mean_ctr``.  ``--seed`` seeds the weights and the requests.  ``--full``
serves the published configuration instead of the smoke one.  Runs on
``--device`` (``cuda`` by default; a missing card raises instead of
falling back).  ``--gnn-artifact`` serving and the MoE LMs come with the
slices that port them and raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core import resolve_device
from repro_torch.data import InteractionStream
from repro_torch.launch import steps as S
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T

_SERVE_KEYS = ("hist", "hist_mask", "target")


def serve_lm(arch_id: str, *, n_requests: int = 4, prompt_len: int = 16,
             max_new: int = 16, seed: int = 0, greedy: bool = True,
             full: bool = False, device="cuda"):
    """Batched decode: prefill by sequential decode, then ``max_new``
    tokens per request (greedy: argmax, the first index on ties; else
    sampled from the softmax with a generator seeded from ``seed``).  The
    weights are drawn from ``seed``; the prompts from numpy's generator of
    ``seed``, as the reference draws them."""
    device = resolve_device(device)
    spec = get_arch(arch_id)
    cfg = spec.make_config() if full else spec.make_smoke_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = T.init_params(cfg, gen)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab,
                                            (n_requests, prompt_len)))
    prompts = prompts.to(device)

    max_len = prompt_len + max_new
    decode = S.make_lm_decode_step(cfg)

    def step(cache, tok, pos):
        return decode(params, {"cache": cache, "tokens": tok, "pos": pos})

    # warm up: one step, so the timed loop below does not pay first-call
    # costs (the card's libraries), then restart from a fresh cache
    tok0 = prompts[:, :1]
    logits, _ = step(T.init_cache(cfg, n_requests, max_len, device=device),
                     tok0, 0)
    _synchronize(device)
    cache = T.init_cache(cfg, n_requests, max_len, device=device)

    # prefill via sequential decode, as the reference serves; a production
    # server uses the prefill forward (launch/steps.make_lm_prefill_step)
    tok = tok0
    t0 = time.perf_counter()
    out_tokens = []
    for i in range(max_len - 1):
        logits, cache = step(cache, tok, i)
        if i + 1 < prompt_len:
            tok = prompts[:, i + 1:i + 2]
        else:
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                probs = torch.softmax(logits.float(), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            tok = nxt[:, None]
            out_tokens.append(tok[:, 0].cpu().numpy())
    _synchronize(device)
    dt = time.perf_counter() - t0
    gen_tokens = np.stack(out_tokens, axis=1)
    tps = n_requests * gen_tokens.shape[1] / dt
    print(f"{arch_id}: generated {gen_tokens.shape} tokens in {dt:.2f}s "
          f"({tps:.1f} tok/s batched, first-call costs excluded)")
    return gen_tokens, {"arch": arch_id, "mode": "lm",
                        "requests": n_requests,
                        "generated_tokens": int(gen_tokens.size),
                        "decode_s": round(dt, 4),
                        "tokens_per_s": round(tps, 2)}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16,
                    help="tokens to generate per request (LM)")
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
    if family == "recsys":
        _, report = serve_recsys(args.arch, batch=args.requests,
                                 seed=args.seed, full=args.full,
                                 device=args.device)
    elif family == "lm":
        _, report = serve_lm(args.arch, n_requests=args.requests,
                             max_new=args.max_new, seed=args.seed,
                             full=args.full, device=args.device)
    else:
        raise NotImplementedError(
            f"{family} serving is not ported to repro_torch yet")
    if args.json:
        print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
