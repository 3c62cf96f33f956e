#!/usr/bin/env python
"""Three designs of the partitioned GNN's one-process halo exchange, timed
side by side on one card over the same plans.

All k partitions live on one device, flattened to (k * v_cap, d) rows, so
the exchange is one linear map: every row becomes the sum of its vertex's
replica rows.  The designs differ in how that map runs:

- ``lanes``: the plan's own lanes as static ``spmm`` maps, as the
  reference's collectives run them: ``x + pair(x)``, then ``y +
  host(y)`` on a host-grouped plan, then the overflow lane's sum into
  (o_cap, d) and its set into every replica row (``torch.where``); 1-4
  launches a combine, depending on the plan.
- ``replica_map``: one ``spmm`` over every (replica, replica) pair of a
  vertex, sum r^2 entries.
- ``slots``: the package's design (``dist.partitioned_gnn._local_exchange``):
  every row summed into its vertex's slot, then each slot spread back to
  its rows; 2 launches, 2 (k * v_cap) entries, whatever the plan.

On RMAT-``--scale`` partitioned by 2PS-L into k = 32, with the host-
grouped plan (4 hosts) and the flat plan capped at quantile 0.9, each
design's entries and launches, one combine's forward and backward at d =
64 (CUDA events, the median of ``--reps``, the designs in turns), and
gin-tu's partitioned train step with the design in place (the median of
3 after one warm-up); every design's combine is held to ``slots``' within
1e-5 of the largest sum.  One JSON line per (plan, design), then the
card's name and power limit.

    python3 scripts/partitioned_exchange_compare.py [--scale 18] [--reps 20]

Needs one CUDA card and nvcc (it builds ``edge_score`` and ``spmm``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from dataclasses import dataclass

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402
from repro_torch.dist import partitioned_gnn as PG  # noqa: E402

_numpy, _lane = PG._numpy, PG._lane
_slots = PG._local_exchange        # the package's design (``time_steps``
                                   # patches the name)


@dataclass(frozen=True, eq=False)
class LanesExchange:
    """``lanes``: the pairwise lane (``x + pair(x)``, gathering the pre-add
    rows), the host lane over its result, then the overflow lane's sum
    over its replicas' pre-add rows, set into every replica's row."""
    pair: object
    host: object
    ov_sum: object
    ov_set: object
    is_overflow: torch.Tensor | None

    @property
    def launches(self) -> int:
        return sum(lane is not None for lane in
                   (self.pair, self.host, self.ov_sum, self.ov_set))

    @property
    def entries(self) -> int:
        return sum(lane.prep.num_edges for lane in
                   (self.pair, self.host, self.ov_sum, self.ov_set)
                   if lane is not None)

    def __call__(self, x):
        x = x.contiguous()
        y = x if self.pair is None else x + self.pair(x)
        if self.host is not None:
            y = y + self.host(y)
        if self.ov_set is not None:
            y = torch.where(self.is_overflow, self.ov_set(self.ov_sum(x)), y)
        return y


def lanes_exchange(plan, v_cap: int, device) -> LanesExchange:
    """``LanesExchange`` of ``plan`` (``device_arrays()``): every lane's
    index map over the flattened rows."""
    send, recv = _numpy(plan["send_idx"]), _numpy(plan["recv_idx"])
    ov = _numpy(plan["ov_idx"])
    k, n, b_cap = send.shape
    R = k * v_cap
    base = np.arange(k, dtype=np.int64) * v_cap
    pair = host = ov_sum = ov_set = is_ov = None
    if n > 1 and b_cap > 0:
        p = np.repeat(np.arange(k), n).reshape(k, n)
        q = (p // n) * n + np.arange(n)[None, :]
        r = recv[q, p % n]
        ok = (send >= 0) & (r >= 0) & (r < v_cap)
        src = base[p][..., None] + np.minimum(send, v_cap - 1)
        dst = base[q][..., None] + r
        pair = _lane(src[ok], dst[ok], R, R, device)
    hsend = plan.get("hsend_idx")
    if hsend is not None:
        hsend, hrecv = _numpy(hsend), _numpy(plan["hrecv_idx"])
    if hsend is not None and hsend.shape[1] > 1 and hsend.shape[2] > 0:
        H = hsend.shape[1]
        D = k // H
        q = np.broadcast_to(np.arange(k)[:, None], (k, H))
        srcs, dsts = [], []
        for dd in range(D):
            p = np.broadcast_to(np.arange(H)[None, :] * D + dd, (k, H))
            hs = hsend[p, q // D]
            ok = (hrecv >= 0) & (hrecv < v_cap) & (hs >= 0)
            srcs.append((base[p][..., None] + np.minimum(hs, v_cap - 1))[ok])
            dsts.append((base[q][..., None] + hrecv)[ok])
        host = _lane(np.concatenate(srcs), np.concatenate(dsts), R, R,
                     device)
    dst_ok = (ov >= 0) & (ov < v_cap)
    if dst_ok.any():
        p, j = np.nonzero(ov >= 0)
        ov_sum = _lane(base[p] + np.minimum(ov[p, j], v_cap - 1), j, R,
                       ov.shape[1], device)
        p, j = np.nonzero(dst_ok)
        rows = base[p] + ov[p, j]
        ov_set = _lane(j, rows, ov.shape[1], R, device)
        mask = np.zeros(R, bool)
        mask[rows] = True
        is_ov = torch.from_numpy(mask[:, None]).to(device)
    return LanesExchange(pair=pair, host=host, ov_sum=ov_sum, ov_set=ov_set,
                         is_overflow=is_ov)


@dataclass(frozen=True, eq=False)
class ReplicaMapExchange:
    """``replica_map``: one ``spmm``, each row the sum over every row of
    its replica slot (itself included), in row order."""
    lane: object
    launches = 1

    @property
    def entries(self) -> int:
        return self.lane.prep.num_edges

    def __call__(self, x):
        return self.lane(x.contiguous())


def replica_map_exchange(plan, v_cap: int, device) -> ReplicaMapExchange:
    slot = PG._replica_slots(plan, v_cap)
    order = np.argsort(slot, kind="stable")
    sizes = np.bincount(slot)
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    r = sizes[slot[order]]                      # each sorted row's r
    dst = np.repeat(order, r)
    start = np.repeat(first[slot[order]], r)
    within = np.arange(len(dst)) - np.repeat(np.cumsum(r) - r, r)
    src = order[start + within]
    return ReplicaMapExchange(_lane(src, dst, len(slot), len(slot), device))


def slots_exchange(plan, v_cap: int, device):
    return _slots(plan, v_cap, device)


DESIGNS = {"lanes": lanes_exchange, "replica_map": replica_map_exchange,
           "slots": slots_exchange}


def entries(ex) -> int:
    if hasattr(ex, "entries"):
        return ex.entries
    return ex.total.prep.num_edges + ex.spread.prep.num_edges


def time_combines(exchanges: dict, rows: int, reps: int) -> dict:
    """Each exchange's combine forward and backward at d = 64 on the same
    inputs, the designs in turns; (median ms, outputs)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((rows, 64), device="cuda", generator=g)
    dy = torch.randn((rows, 64), device="cuda", generator=g)
    ms = {n: [] for n in exchanges}
    outs = {}
    for i in range(reps + 1):
        for name in (exchanges if i % 2 else reversed(list(exchanges))):
            xg = x.clone().requires_grad_(True)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            y = exchanges[name](xg)
            y.backward(dy)
            b.record()
            b.synchronize()
            if i:
                ms[name].append(a.elapsed_time(b))
            outs[name] = (y.detach(), xg.grad)
    return {n: float(np.median(v)) for n, v in ms.items()}, outs


def time_steps(plan, mesh, cfg, V: int, edges, design) -> float:
    """gin-tu's partitioned step with ``design`` as the one-process
    exchange: the median device ms of 3 steps after one warm-up."""
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw_init
    saved = PG._local_exchange
    PG._local_exchange = design
    try:
        step = PG.make_partitioned_gin_step(cfg, mesh, plan)
        fscale = C.feature_scale("gin", cfg, V, edges, 5, "cuda")
        batch, _ = C.partitioned_batch(plan, V, cfg.d_in, cfg.n_classes, 5,
                                       "cuda", fscale)
        step.prepare(batch["plan"])
        params = G.params_to(G.gin_init(cfg, torch.Generator()
                                        .manual_seed(0)), "cuda")
        state = {"params": params, "opt": adamw_init(params)}
        ms = []
        timed = C.event_timed(step, ms)
        for _ in range(4):
            state, _ = timed(state, batch)
        return float(np.median(ms[1:]))
    finally:
        PG._local_exchange = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.core import MemmapEdgeStream, run_spec, spec_for
    from repro_torch.dist import plan_halo_exchange_stream
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.edge_score import kernel as es_kernel
    from repro_torch.kernels.spmm import kernel as sp_kernel
    from repro_torch.launch.mesh import make_host_mesh
    cuda_build.build({es_kernel.NAME: es_kernel.SOURCE,
                      sp_kernel.NAME: sp_kernel.SOURCE})
    k = 32
    cfg = get_arch("gin-tu").config_for_shape("ogb_products")
    with tempfile.TemporaryDirectory() as tmp:
        path, E = C.write_graph(args.scale, tmp)
        edges = np.fromfile(path, np.uint32).reshape(-1, 2)
        V = int(edges.max()) + 1
        asg = np.asarray(run_spec(spec_for("2psl"), MemmapEdgeStream(path),
                                  k).assignment)
        plans = {
            "host_grouped": (plan_halo_exchange_stream(
                MemmapEdgeStream(path), asg, V, k, host_groups=4),
                make_host_mesh((4, k // 4), ("host", "device"))),
            "flat_capped": (plan_halo_exchange_stream(
                MemmapEdgeStream(path), asg, V, k, pair_cap_quantile=0.9),
                make_host_mesh((k,), ("device",)))}
        for pname, (plan, mesh) in plans.items():
            arrays = plan.device_arrays()
            ex = {n: f(arrays, plan.v_cap, torch.device("cuda"))
                  for n, f in DESIGNS.items()}
            rows = k * plan.v_cap
            ms, outs = time_combines(ex, rows, args.reps)
            want_y, want_g = outs["slots"]
            tol = 1e-5 * float(want_y.abs().max())
            for name in DESIGNS:
                y, g = outs[name]
                err = max(float((y - want_y).abs().max()),
                          float((g - want_g).abs().max()))
                line = {"plan": pname, "design": name,
                        "graph": f"rmat_graph({args.scale}, edge_factor=16,"
                                 f" seed=0): {V} vertices, {E} edges, 2PS-L "
                                 f"k={k}",
                        "rows": rows, "o_cap": plan.o_cap,
                        "entries": entries(ex[name]),
                        "launches_per_combine": ex[name].launches,
                        "combine_fwd_bwd_ms": ms[name],
                        "max_abs_err_vs_slots": err, "tolerance": tol,
                        "gin_tu_step_ms": time_steps(
                            plan, mesh, cfg, V, edges, DESIGNS[name])}
                print(json.dumps(line), flush=True)
                if err > tol:
                    raise AssertionError(f"{pname} {name}: {err} > {tol}")
            del ex, outs
            torch.cuda.empty_cache()
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
