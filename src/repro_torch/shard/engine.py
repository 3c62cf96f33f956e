"""Sharded multi-worker partitioning: N engine streams + merge rounds, in
PyTorch (the reference package's ``shard/engine.py``).

The sequential engine streams every chunk through one pipeline.  Here N
workers each stream a disjoint share of the chunks, and the O(|V|)
partitioner state is reconciled at **round** boundaries:

* chunks are dealt round-robin in blocks of ``round_chunks``: in round
  ``r`` worker ``w`` owns chunks ``[(r*W + w) * R, (r*W + w + 1) * R)``;
* every worker starts a round from the same merged base state, streams
  its block through the *identical* pass pipeline the sequential engine
  runs (``repro_torch.core.engine._run_pass_pipeline``) writing a
  rank-local assignment slice, then publishes its end state
  (``ShardState``) through the exchange backend;
* each worker merges all W end states **locally** —
  ``StreamingPartitioner.merge_rules`` declares only commutative +
  associative rules, so every rank computes the same merged state with
  no designated reducer — and the next round starts from it.

The device state lives in torch tensors on the worker's ``device``; at
every round boundary it crosses to numpy in the reference's layout
(``convert.state_to_numpy``: word matrices as uint32) for the exchange and
the merge, and back (``convert.state_to_torch``).  The round base and the
published states are real copies: the chunk functions update ``bits`` and
``sizes`` in place, and on the CPU ``state_to_numpy`` returns views of the
live tensors.  A worker's assignments are identical to the reference's at
the same W and ``round_chunks``, and its published states are the
reference's, so workers of the two packages can share one exchange.

``shards=1`` degenerates to the sequential schedule and is identical to
``run_spec`` for every registered spec; stateless hash partitioners are
identical at any W.

Crash safety reuses the checkpoint store: a worker checkpoints the merged
state + its local slice at round boundaries (cursor = ``(pass_index,
next_round)``), and a restarted worker resumes mid-pass — its peers'
published round files persist on the exchange, so it re-joins the
rendezvous it died before.
"""
from __future__ import annotations

import contextlib
import copy
import hashlib
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from ..core.convert import state_to_numpy, state_to_torch
from ..core.engine import (PartitionRunResult, _Timer, _alloc_assignment,
                           _assignment_writer, _resident_bits,
                           _run_pass_pipeline, _set_replication_gauge,
                           build_partitioner, resolve_device)
from ..core.metrics import (cross_host_replication_factor,
                            quality_from_bitmatrix)
from ..obs import StallClock, get_registry, get_tracer
from .backends import ThreadExchange
from .state import ShardState

__all__ = ["ShardLayout", "ShardWorkerResult", "finalize_shard_run",
           "run_spec_sharded", "run_worker"]

_ASG_KEY = "shard_asg"      # reserved host-state key carrying the slice


@dataclass(frozen=True)
class ShardLayout:
    """Pure chunk-dealing arithmetic shared by workers and the stitcher:
    which chunks (and therefore which global assignment rows) every rank
    owns in every round.  Derived from the stream geometry alone, so all
    ranks — and a post-hoc stitcher — compute the identical layout."""

    num_edges: int
    eff_chunk: int          # rows per engine chunk (window-regrouped)
    world: int
    round_chunks: int = 1   # chunks per worker per round

    @property
    def num_chunks(self) -> int:
        return -(-self.num_edges // self.eff_chunk)

    @property
    def num_rounds(self) -> int:
        blocks = -(-self.num_chunks // self.round_chunks)
        return -(-blocks // self.world)

    def round_span(self, rnd: int, rank: int) -> tuple:
        """-> (first_chunk, num_chunks) rank ``rank`` streams in round
        ``rnd`` (num_chunks 0 when the deal ran out)."""
        block = rnd * self.world + rank
        c0 = block * self.round_chunks
        c1 = min(self.num_chunks, c0 + self.round_chunks)
        return c0, max(0, c1 - c0)

    def chunk_rows(self, chunk: int) -> int:
        return min(self.eff_chunk,
                   self.num_edges - chunk * self.eff_chunk)

    def extents(self, rank: int):
        """-> [(global_lo, rows, local_offset)] per round, in round
        order — the map between the global assignment and the rank's
        local slice (one contiguous extent per owned block)."""
        out, loc = [], 0
        for rnd in range(self.num_rounds):
            c0, nc = self.round_span(rnd, rank)
            if nc == 0:
                out.append((c0 * self.eff_chunk, 0, loc))
                continue
            rows = sum(self.chunk_rows(c) for c in range(c0, c0 + nc))
            out.append((c0 * self.eff_chunk, rows, loc))
            loc += rows
        return out

    def local_rows(self, rank: int) -> int:
        return sum(n for _, n, _ in self.extents(rank))


@dataclass
class ShardWorkerResult:
    """One worker's outcome: its partitioner holding the final merged
    state (identical on every rank), the final all-gather (every rank's
    assignment slice), and this rank's bookkeeping."""

    rank: int
    partitioner: object
    state: dict
    finals: list                     # [ShardState] * world, rank order
    pass_counts: dict
    timer: _Timer
    merge_seconds: float = 0.0
    resumes: int = 0
    checkpoints_written: int = 0
    io_retries: int = 0
    stalls: list = field(default_factory=list)


def _uniform_eff_chunk(spec, passes) -> int:
    effs = {spec.chunk_size * max(1, int(sp.window)) for sp in passes}
    if len(effs) != 1:
        raise ValueError(
            f"sharded execution needs one chunk geometry across passes "
            f"(the local slice layout must be pass-invariant); got "
            f"window-regrouped chunk sizes {sorted(effs)}")
    return effs.pop()


def _rank_dir(checkpoint_dir: str, rank: int) -> str:
    return os.path.join(checkpoint_dir, f"rank{rank:03d}")


def _numpy_copy(state: dict) -> dict:
    """The device state as numpy copies in the reference's layout: a
    snapshot the chunk functions' in-place updates cannot reach."""
    return {n: np.array(a, copy=True)
            for n, a in state_to_numpy(state).items()}


def run_worker(spec, stream, k, exchange, *, device="cuda",
               round_chunks: int = 1, tracer=None, metrics=None,
               retry_policy=None, checkpoint_dir: str | None = None,
               checkpoint_every_rounds: int | None = None,
               resume: bool = False,
               prologue_lock=None) -> ShardWorkerResult:
    """Run one shard worker to completion (all passes, all rounds) on
    ``device`` (the card by default; ``"cpu"`` runs the plain versions).

    ``exchange`` supplies identity (``.rank`` / ``.world``) and the
    all-gather; every backend drives this same function — the emulated
    path and a real multi-process launch execute identical code.

    ``prologue_lock``, when given, is held around ``init_state`` (the
    degree pass and clustering, a few thousand small launches before the
    first rendezvous), and the wait for it is timed as
    ``prologue_wait``.  ``run_spec_sharded``'s worker threads share one:
    threads that launch eagerly on one card under one GIL slow each other
    down far more than running one after another would.
    """
    from ..robust import checkpoint as _ck

    device = resolve_device(device)
    tracer = get_tracer() if tracer is None else tracer
    metrics = get_registry() if metrics is None else metrics
    if retry_policy is not None:
        from ..robust.faults import ResilientStream
        stream = ResilientStream(stream, retry_policy)
    rank, world = exchange.rank, exchange.world
    timer = _Timer()
    part = build_partitioner(spec, device)

    ckpt = None
    rank_dir = (_rank_dir(checkpoint_dir, rank)
                if checkpoint_dir is not None else None)
    if resume and rank_dir is not None:
        ckpt = _ck.load_engine_checkpoint(rank_dir)
        if ckpt is not None:
            _ck.check_compatible(ckpt.meta, spec, stream, k, None)

    if ckpt is not None:
        with tracer.span("resume", cat="shard", rank=rank,
                         pass_index=int(ckpt.meta["pass_index"]),
                         next_round=int(ckpt.meta["next_chunk"])):
            part.init_for_resume(stream, k, timer)
            host = dict(ckpt.host_state)
            local_asg = np.array(host.pop(_ASG_KEY), dtype=np.int32)
            part.restore_host_state(host)
            state = state_to_torch(ckpt.device_state, device)
        timer.lap("resume")
        metrics.counter("engine.resumes").inc()
        _set_replication_gauge(part, metrics, _resident_bits(part, state))
        resumes = int(ckpt.meta["resumes"]) + 1
        start_pass = int(ckpt.meta["pass_index"])
        start_round = int(ckpt.meta["next_chunk"])
        pass_counts = {kk: int(v)
                       for kk, v in ckpt.meta["pass_counts"].items()}
    else:
        with contextlib.ExitStack() as held:
            if prologue_lock is not None:
                held.enter_context(prologue_lock)
                timer.lap("prologue_wait")
            with tracer.span("init", cat="shard", rank=rank, world=world,
                             algorithm=spec.algorithm, k=k):
                state = part.init_state(stream, k, timer, None)
        resumes, start_pass, start_round = 0, 0, 0
        pass_counts = {}
        local_asg = None

    passes = list(part.passes())
    layout = ShardLayout(num_edges=stream.num_edges,
                         eff_chunk=_uniform_eff_chunk(spec, passes),
                         world=world, round_chunks=round_chunks)
    extents = layout.extents(rank)
    if local_asg is None:
        local_asg = np.full(layout.local_rows(rank), -1, np.int32)
    metrics.gauge("engine.shards").set(world)
    merge_hist = metrics.histogram("shard.merge_seconds")
    merge_seconds = 0.0
    checkpoints_written = 0
    depth = spec.pipeline_depth
    stalls = []

    def _save_round_checkpoint(pi, next_round, state_np, merged_host):
        nonlocal checkpoints_written
        host = {**merged_host, _ASG_KEY: local_asg}
        meta = {"spec_hash": _ck.spec_hash(spec),
                "algorithm": spec.algorithm, "k": int(k),
                "num_edges": int(stream.num_edges),
                "num_vertices": int(stream.num_vertices),
                "chunk_size": int(spec.chunk_size),
                # the cursor's chunk slot counts ROUNDS here: rounds are
                # the shard engine's atomic unit, and the lexical
                # ckpt_<pass>_<chunk> ordering works unchanged
                "pass_index": int(pi), "next_chunk": int(next_round),
                "edge_lo": 0, "assigned": 0,
                "pass_counts": dict(pass_counts), "resumes": resumes,
                "shard": int(rank), "num_shards": int(world),
                "round_chunks": int(round_chunks),
                "assignment_in_checkpoint": True}
        _ck.save_engine_checkpoint(rank_dir, _ck.EngineCheckpoint(
            meta=meta, device_state=state_np, host_state=host,
            assignment=None))
        checkpoints_written += 1
        tracer.complete("checkpoint", "robust", 0.0, pass_index=int(pi),
                        next_round=int(next_round), rank=rank)
        metrics.counter("engine.checkpoints").inc()
        timer.lap("checkpoint")
        _ck.crash_after_checkpoints(checkpoints_written)

    for pi, sp in enumerate(passes):
        if pi < start_pass:
            continue
        first_round = start_round if pi == start_pass else 0
        # a round-boundary checkpoint at (pi, 0) holds pre-setup state —
        # the pass has not started; mid-pass cursors are post-setup
        if sp.setup is not None and first_round == 0:
            with tracer.span("setup", cat="engine", phase=sp.phase):
                state = sp.setup(state)
        stall = StallClock()
        for rnd in range(first_round, layout.num_rounds):
            # the round base: every worker's merge input must be the
            # state all shards started this round from, copied before the
            # pipeline updates the tensors in place (on the CPU
            # state_to_numpy gives views of them) — and the host dict
            # deep-copied, host_fold mutates it in place
            base_dev = _numpy_copy(state)
            base_host = copy.deepcopy(part.host_state())
            # per-round capacity quota so W workers admitting against
            # the frozen base cannot collectively overshoot alpha; each
            # worker's share is proportional to its slice of the
            # round's edges (ragged rounds give the sole owner all of
            # the headroom)
            def _rows(r):
                rc0, rnc = layout.round_span(rnd, r)
                return sum(layout.chunk_rows(c)
                           for c in range(rc0, rc0 + rnc))
            my_rows = _rows(rank)
            part.begin_shard_round(base_dev.get("sizes"), my_rows,
                                   sum(_rows(r) for r in range(world)))
            c0, nc = layout.round_span(rnd, rank)
            if nc > 0:
                g_lo, _, loc = extents[rnd]
                # returns drained: every asynchronous writeback landed
                # and the device synchronized, so the end state is final
                pr = _run_pass_pipeline(
                    sp, state, stream, chunk_size=layout.eff_chunk,
                    depth=depth, device=device, tracer=tracer,
                    metrics=metrics, stall=stall,
                    write_rows=_assignment_writer(local_asg,
                                                  offset=loc - g_lo),
                    first_chunk=c0, first_lo=g_lo, num_chunks=nc,
                    pass_index=pi)
                state = pr.state
                timer.lap(sp.phase, exclude=pr.wb_host)
                timer.add("writeback", pr.wb_host)
                pass_counts[sp.phase] = (pass_counts.get(sp.phase, 0)
                                         + pr.assigned)
            end = ShardState.snapshot(
                {"rank": rank, "round": rnd, "pass_index": pi},
                device=state_to_numpy(state), host=part.host_state())
            with tracer.span("shard:exchange", cat="shard", rank=rank,
                             round=rnd, pass_index=pi):
                peers = exchange.exchange(f"p{pi:02d}_r{rnd:05d}", end)
            t0 = time.perf_counter()
            with tracer.span("shard:merge", cat="shard", rank=rank,
                             round=rnd, pass_index=pi, shards=world):
                merged_dev, merged_host = part.merge_states(
                    base_dev, base_host,
                    [(s.device, s.host) for s in peers])
            dt = time.perf_counter() - t0
            merge_seconds += dt
            merge_hist.observe(dt)
            state = state_to_torch(merged_dev, device)
            part.restore_host_state(merged_host)
            _set_replication_gauge(part, metrics,
                                   _resident_bits(part, state))
            timer.lap("merge")
            last = (pi == len(passes) - 1
                    and rnd == layout.num_rounds - 1)
            if (checkpoint_every_rounds and rank_dir is not None
                    and not last
                    and (rnd + 1) % checkpoint_every_rounds == 0):
                nxt = ((pi, rnd + 1) if rnd + 1 < layout.num_rounds
                       else (pi + 1, 0))
                _save_round_checkpoint(nxt[0], nxt[1], merged_dev,
                                       merged_host)
        stalls.append(stall.report(sp.phase))
    part.end_shard_run()

    final = ShardState.snapshot(
        {"rank": rank, "rows": int(local_asg.size),
         "sha256": hashlib.sha256(local_asg.tobytes()).hexdigest(),
         "pass_counts": {kk: int(v) for kk, v in pass_counts.items()},
         "resumes": int(resumes),
         "checkpoints_written": int(checkpoints_written),
         "merge_seconds": merge_seconds,
         "io_retries": int(getattr(stream, "retries", 0) or 0),
         "timings": {kk: float(v) for kk, v in timer.t.items()}},
        arrays={"asg": local_asg})
    finals = exchange.exchange("final", final)
    return ShardWorkerResult(
        rank=rank, partitioner=part, state=state, finals=finals,
        pass_counts=pass_counts, timer=timer,
        merge_seconds=merge_seconds, resumes=resumes,
        checkpoints_written=checkpoints_written,
        io_retries=int(getattr(stream, "retries", 0) or 0),
        stalls=stalls)


def finalize_shard_run(worker: ShardWorkerResult, layout: ShardLayout,
                       spec, stream, k, *, out_path=None, tracer=None,
                       metrics=None, backend: str = "emulated"
                       ) -> PartitionRunResult:
    """Stitch the final all-gather into one global assignment and produce
    the same ``PartitionRunResult`` the sequential engine returns.  Any
    rank can run this (the final exchange gave everyone every slice);
    single-process callers run it once on rank 0's result."""
    tracer = get_tracer() if tracer is None else tracer
    metrics = get_registry() if metrics is None else metrics
    part, state = worker.partitioner, worker.state
    assignment = _alloc_assignment(stream.num_edges, out_path)
    slices = []
    with tracer.span("shard:stitch", cat="shard", shards=layout.world):
        for s in worker.finals:
            rank = int(s.meta["rank"])
            local = np.asarray(s.arrays["asg"], dtype=np.int32)
            for g_lo, n, loc in layout.extents(rank):
                if n:
                    assignment[g_lo:g_lo + n] = local[loc:loc + n]
            slices.append({"rank": rank, "rows": int(s.meta["rows"]),
                           "sha256": s.meta["sha256"]})
    pass_counts: dict = {}
    for s in worker.finals:
        for phase, v in s.meta["pass_counts"].items():
            pass_counts[phase] = pass_counts.get(phase, 0) + int(v)
    with tracer.span("finalize", cat="engine"):
        bits_np, sizes_np, extras = part.finalize(state, pass_counts)
        bits_np, sizes_np = np.asarray(bits_np), np.asarray(sizes_np)
        quality = quality_from_bitmatrix(bits_np, sizes_np,
                                         stream.num_edges)
    worker.timer.lap("finalize")
    _set_replication_gauge(part, metrics, bits_np)
    extras["shards"] = layout.world
    extras["round_chunks"] = layout.round_chunks
    extras["rounds"] = layout.num_rounds
    extras["shard_backend"] = backend
    extras["merge_seconds"] = round(sum(
        float(s.meta["merge_seconds"]) for s in worker.finals), 6)
    extras["shard_slices"] = slices
    total_resumes = sum(int(s.meta["resumes"]) for s in worker.finals)
    if total_resumes:
        extras["resumes"] = total_resumes
    io_retries = sum(int(s.meta.get("io_retries", 0))
                     for s in worker.finals)
    if io_retries:
        extras["io_retries"] = io_retries
    if getattr(part, "num_hosts", 0):
        extras["num_hosts"] = part.num_hosts
        extras["dcn_penalty"] = float(getattr(spec, "dcn_penalty", 0.0))
        extras["cross_host_rf"] = cross_host_replication_factor(
            bits_np, k, part.num_hosts)
    if isinstance(assignment, np.memmap):
        assignment.flush()
    return PartitionRunResult(
        name=part.display_name, k=k, alpha=spec.alpha,
        assignment=assignment, quality=quality, timings=worker.timer.t,
        extras=extras,
        simulated_io_seconds=stream.simulated_io_seconds, spec=spec)


def run_spec_sharded(spec, stream, k, *, num_shards: int,
                     round_chunks: int = 1, device="cuda", out_path=None,
                     tracer=None, metrics=None, retry_policy=None,
                     checkpoint_dir=None, checkpoint_every_rounds=None,
                     resume: bool = False,
                     timeout_s: float = 120.0) -> PartitionRunResult:
    """Emulated sharded run: ``num_shards`` worker threads over a
    ``ThreadExchange``, all on ``device`` (the card by default), their
    prologues one at a time (``run_worker``'s ``prologue_lock``), then
    stitch.  Same ``run_worker`` code path as a real multi-process launch
    (``repro_torch.launch.dist_partition``).  ``shards=1`` is identical to
    ``run_spec`` for every registered spec."""
    device = resolve_device(device)
    tracer = get_tracer() if tracer is None else tracer
    metrics = get_registry() if metrics is None else metrics
    hub = ThreadExchange(num_shards, timeout_s=timeout_s)
    prologue_lock = threading.Lock()
    results: list = [None] * num_shards
    errors: list = [None] * num_shards

    def _target(rank):
        try:
            results[rank] = run_worker(
                spec, stream, k, hub.for_rank(rank), device=device,
                round_chunks=round_chunks, tracer=tracer,
                metrics=metrics, retry_policy=retry_policy,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every_rounds=checkpoint_every_rounds,
                resume=resume, prologue_lock=prologue_lock)
        except BaseException as e:           # propagate to peers + caller
            errors[rank] = e
            hub.abort(e)

    threads = [threading.Thread(target=_target, args=(r,),
                                name=f"shard-worker-{r}", daemon=True)
               for r in range(num_shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    worker = results[0]
    layout = ShardLayout(
        num_edges=stream.num_edges,
        eff_chunk=_uniform_eff_chunk(spec,
                                     list(worker.partitioner.passes())),
        world=num_shards, round_chunks=round_chunks)
    return finalize_shard_run(worker, layout, spec, stream, k,
                              out_path=out_path, tracer=tracer,
                              metrics=metrics, backend="emulated")
