"""Serving launcher of the port: batched LM decode, DIEN CTR scoring and
partitioned GNN inference on the card.

  python -m repro_torch.launch.serve --arch starcoder2-3b --requests 4 \
      --max-new 16 --full --json
  python -m repro_torch.launch.serve --arch dien --requests 512 --full --json
  python -m repro_torch.launch.serve --gnn-artifact parts/ --requests 32 \
      --json

An LM (``--arch`` starcoder2-3b, the default, minitron-8b or qwen1.5-110b)
decodes ``--max-new`` tokens greedily for ``--requests`` random prompts of
16 tokens, and prints the reference's report (``arch``, ``mode``,
``requests``, ``generated_tokens``, ``decode_s``, ``tokens_per_s``).  DIEN
scores ``--requests`` requests in one batch, drawn from the synthetic
``InteractionStream``, and prints ``arch``, ``mode``, ``requests`` and
``mean_ctr``.  ``--seed`` seeds the weights and the requests.  ``--full``
serves the published configuration instead of the smoke one.  Runs on
``--device`` (``cuda`` by default; a missing card raises instead of
falling back).  ``--gnn-artifact DIR`` answers ego-network queries against
a ``PartitionArtifact`` (``serve_gnn``: the partition-aware sampler, the
hot-vertex feature cache behind a resilient remote fetch, and a GIN
forward whose neighbour sums run through the ``spmm`` kernel), and prints
the reference's report (p50/p99 latency, cache hit rate, degraded rows).
A GNN ``--arch`` serves only from an artifact and raises ``ValueError``
without one; the MoE LMs come with the slice that ports them and raise
``NotImplementedError``.
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
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
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


def gin_serve_forward(params, nodes, gp: G.GraphPrep) -> torch.Tensor:
    """The reference's no-BN GIN forward of ``serve_gnn`` (the
    inference-parity path): node logits (N, n_classes), every neighbour sum
    one ``spmm`` launch on the edges bound in ``gp``."""
    h = L.dense(params["encoder"], nodes)
    for lp in params["layers"]:
        agg = G.neighbour_sum(h, gp)
        pre = (1.0 + lp["eps"]) * h + agg
        h = L.dense(lp["mlp"]["l2"],
                    torch.relu(L.dense(lp["mlp"]["l1"], pre)))
        h = torch.relu(h)
    return L.dense(params["head"], h)


@torch.no_grad()
def serve_gnn(artifact_dir: str, *, n_requests: int = 32, roots_per: int = 4,
              fanouts=(-1, -1), cache_budget: int = 1 << 16, seed: int = 0,
              d_in: int = 8, n_classes: int = 4, no_cache: bool = False,
              fetch_timeout_s: float = 1.0, fetch_retries: int = 2,
              inject_fetch_faults: int = 0, device="cuda"):
    """Answer ego-network inference requests against a partition artifact.

    Per request: route to the roots' home partition, sample a k-hop
    ego-network (full fan-out by default — exact inference), read local
    features from the home shard and remote features through the
    hot-vertex cache, and run a GIN forward on ``device`` whose layers each
    launch one ``spmm`` (``(n_requests + 1) * len(fanouts)`` in all, the
    first request a warm-up).  The cache only short-circuits the remote
    fetch, so logits are bit-identical with ``no_cache=True``.

    Features and roots come from numpy's generator of ``seed``, as the
    reference draws them; the weights from a CPU ``torch.Generator`` of
    ``seed``, moved to ``device``, so the card and the CPU serve the same
    model.  The reference pads each batch to its static caps (V + 8 nodes,
    E + 8 edges) for XLA; the port checks the caps where the reference does
    (``padded_batch``) and runs its forward on the sample's own nodes and
    edges.  The remote fetch runs behind a ``ResilientFetcher``: a timeout
    per call and up to ``fetch_retries`` retries; on exhaustion the batch
    is served degraded (zero rows, counted in ``fetch_failures``).
    ``inject_fetch_faults=N`` fails the first N fetch calls — N <=
    fetch_retries recovers bit-identically, larger N degrades.
    """
    from repro_torch import obs
    from repro_torch.core import PartitionArtifact
    from repro_torch.robust import ResilientFetcher, RetryPolicy
    from repro_torch.sample import (HotVertexFeatureCache, PartitionedGraph,
                                    PartitionedNeighborSampler,
                                    build_local_graphs)

    device = resolve_device(device)
    art = PartitionArtifact.load(artifact_dir)
    if not art.has_local_graphs():
        build_local_graphs(art)            # one out-of-core sweep
    pg = PartitionedGraph.load(art)
    V = art.num_vertices
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(V, d_in)).astype(np.float32)
    degrees = pg.degrees()

    # synthetic feature store: each partition holds its masters' rows;
    # remote rows come through the cache (the fetch stands in for a
    # cross-partition RPC)
    remote_fetches = {"rows": 0, "calls": 0}

    def remote_fetch(gids):
        remote_fetches["calls"] += 1
        if remote_fetches["calls"] <= inject_fetch_faults:
            raise IOError(f"injected fetch fault "
                          f"(call {remote_fetches['calls']})")
        remote_fetches["rows"] += len(gids)
        return feats[gids]

    fetcher = ResilientFetcher(
        remote_fetch, d_in, timeout_s=fetch_timeout_s,
        policy=RetryPolicy(max_retries=fetch_retries,
                           backoff_base_s=0.001))
    cache = None if no_cache else HotVertexFeatureCache(
        fetcher, d_in, byte_budget=cache_budget, degrees=degrees)

    cfg = G.GINConfig(name="gin-serve", n_layers=len(fanouts), d_hidden=32,
                      d_in=d_in, n_classes=n_classes)
    params = G.params_to(G.gin_init(cfg, torch.Generator().manual_seed(seed)),
                         device)
    sampler = PartitionedNeighborSampler(pg, fanouts, seed=seed)
    # the reference's static shape caps, checked by padded_batch
    max_nodes, max_edges = V + 8, art.num_edges + 8

    def feature_rows(gids):
        home = pg.home_of(gids)
        rows = np.empty((len(gids), d_in), np.float32)
        local = home == serve_home
        rows[local] = feats[gids[local]]               # home shard read
        if (~local).any():
            rows[~local] = (cache.get(gids[~local]) if cache is not None
                            else fetcher(gids[~local]))
        return rows

    tracer = obs.get_tracer()
    lat, all_logits = [], []
    for r in range(n_requests + 1):                    # +1 warmup request
        roots = rng.integers(0, V, size=roots_per)
        serve_home = int(pg.home_of(roots[:1])[0])
        t0 = time.perf_counter()
        with tracer.span("serve.request", cat="serve", request=r):
            s = sampler.sample(roots, home=serve_home)
            with tracer.span("serve.features", cat="serve", request=r):
                b = sampler.padded_batch(
                    roots, feature_rows, max_nodes=max_nodes,
                    max_edges=max_edges, home=serve_home, sample=s)
            with tracer.span("serve.forward", cat="serve", request=r):
                n, e = len(s["node_ids"]), len(s["edges"])
                edges = torch.from_numpy(b["edges"][:e]).to(device)
                mask = torch.from_numpy(b["edge_mask"][:e]).to(device)
                gp = G.edge_prep(edges, mask, n)
                logits = gin_serve_forward(
                    params, torch.from_numpy(b["nodes"][:n]).to(device), gp)
                logits = logits[torch.from_numpy(b["root_local"]).long()
                                .to(device)].cpu().numpy()
        dt = time.perf_counter() - t0
        if r == 0:
            continue                                   # warmup
        lat.append(dt)
        all_logits.append(logits)

    lat_ms = np.sort(np.asarray(lat)) * 1e3
    stats = cache.stats() if cache is not None else {
        "hits": 0, "misses": remote_fetches["rows"], "hit_rate": 0.0}
    reg = obs.get_registry()
    reg.gauge("serve.p50_ms").set(float(np.percentile(lat_ms, 50)))
    reg.gauge("serve.p99_ms").set(float(np.percentile(lat_ms, 99)))
    report = {
        "mode": "gnn", "artifact": artifact_dir, "requests": n_requests,
        "roots_per_request": roots_per, "fanouts": list(fanouts),
        "k": art.k, "num_vertices": V, "num_edges": art.num_edges,
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 3),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 3),
        "cache": {kk: (round(v, 4) if isinstance(v, float) else v)
                  for kk, v in stats.items()},
        "remote_rows_fetched": remote_fetches["rows"],
        "fetch_failures": fetcher.failures,
        "fetch_retries": fetcher.retries,
    }
    print(f"gnn: {n_requests} requests on {artifact_dir} (k={art.k}) "
          f"p50 {report['p50_ms']}ms p99 {report['p99_ms']}ms "
          f"cache hit-rate {report['cache']['hit_rate']} "
          f"degraded rows {fetcher.failures}")
    return np.concatenate(all_logits), report


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
                    help="serve ego-network queries against this "
                         "PartitionArtifact dir (overrides --arch)")
    ap.add_argument("--roots-per", type=int, default=4)
    ap.add_argument("--fanout", type=int, nargs="*", default=[-1, -1],
                    help="per-hop fanouts; -1 = full fan-out (exact)")
    ap.add_argument("--cache-budget", type=int, default=1 << 16,
                    help="hot-vertex feature cache budget in bytes")
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--fetch-timeout", type=float, default=1.0,
                    help="per-call deadline (s) for the remote feature "
                         "fetch; a slow store degrades instead of hanging "
                         "the serve loop")
    ap.add_argument("--fetch-retries", type=int, default=2,
                    help="retries with bounded backoff before serving a "
                         "degraded (zero-feature) batch")
    ap.add_argument("--inject-fetch-faults", type=int, default=0,
                    metavar="N",
                    help="deterministically fail the first N remote "
                         "fetches (N <= --fetch-retries recovers "
                         "bit-identically; larger N demonstrates "
                         "degraded serving)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a card "
                         "raises")
    ap.add_argument("--json", action="store_true",
                    help="print a machine-readable report (one JSON object)")
    args = ap.parse_args(argv)
    if args.gnn_artifact is not None:
        _, report = serve_gnn(
            args.gnn_artifact, n_requests=args.requests,
            roots_per=args.roots_per, fanouts=tuple(args.fanout),
            cache_budget=args.cache_budget, seed=args.seed,
            no_cache=args.no_cache, fetch_timeout_s=args.fetch_timeout,
            fetch_retries=args.fetch_retries,
            inject_fetch_faults=args.inject_fetch_faults,
            device=args.device)
    elif (family := get_arch(args.arch).family) == "gnn":
        raise ValueError(f"GNN serving needs --gnn-artifact DIR (a "
                         f"PartitionArtifact to sample from); --arch "
                         f"{args.arch} alone has no graph to serve")
    elif family == "recsys":
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
