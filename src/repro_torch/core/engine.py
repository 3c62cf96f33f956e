"""The out-of-core streaming engine, in PyTorch (2PS-L slice).

``run_spec`` streams an edge list through a partitioner's passes, exactly
as the reference engine does, with the device state held in torch tensors
on the run's ``device`` (the card by default).

Pipeline model
--------------

Each pass over the edge stream is a three-stage pipeline with up to
``spec.pipeline_depth`` chunks in flight:

    read (prefetch thread)  ->  device dispatch (async)  ->  writeback (host)

* A background thread pulls chunks from the stream into a bounded queue,
  so disk/decode IO for chunk k+1 overlaps everything downstream of chunk k.
* The main thread pads the chunk, stages it in pinned memory and enqueues
  ``chunk_fn`` on the current CUDA stream without synchronizing.  The
  algorithm state is updated in place from one chunk to the next (the
  reference donates its buffers instead), and each chunk's assignment is
  copied without blocking into a pinned host buffer, behind a
  ``torch.cuda.Event``.
* The writeback stage waits for that event, writes the assignment rows and
  runs any host-side replication fold.  It only runs once the deque holds
  ``pipeline_depth`` chunks — chunk k's writeback overlaps chunk k+1's read
  and dispatch.

Depth 1 is the fully synchronous engine.  **Any depth produces identical
assignments**: the chunk functions run in stream order on identical
inputs; pipelining only defers when results are copied off the device.

On the CPU (``device="cpu"``) the same code runs synchronously, with the
kernels' plain versions.  Checkpoint/resume, retrying streams and shard
merging are not ported yet; ``run_spec`` raises if they are asked for.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..obs import (PipelineStallReport, StallClock, get_registry,
                   get_tracer, use_registry, use_tracer)
from . import bitops, partitioning as P
from .clustering import streaming_clustering
from .convert import words_to_numpy, words_to_torch
from .mapping import map_clusters_lpt
from .metrics import (PartitionQuality, capacity,
                      cross_host_replication_factor, host_assignment,
                      quality_from_bitmatrix)
from .specs import PartitionerSpec, SpecError, TwoPSLSpec
from .stream import EdgeStream, prefetch


def resolve_device(device) -> torch.device:
    """The run's device.  ``cuda`` without a usable card raises: the port
    never moves a run to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to "
                           "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class PartitionRunResult:
    """Everything ``run_spec`` produces for one partitioning run: the
    per-edge assignment (plain array, or the ``out_path`` memmap), the
    ``PartitionQuality``, per-phase wall-clock ``timings``, and algorithm
    ``extras`` (2PS-L: pre-partition ratio, cluster stats,
    ``kernel_backend``; any spec with ``host_groups``: ``num_hosts`` /
    ``dcn_penalty`` / ``cross_host_rf``)."""

    name: str
    k: int
    alpha: float
    assignment: np.ndarray                 # (E,) int32 edge -> partition
    quality: PartitionQuality
    timings: dict = field(default_factory=dict)   # phase -> seconds
    extras: dict = field(default_factory=dict)
    simulated_io_seconds: float = 0.0
    spec: PartitionerSpec | None = None

    @property
    def total_seconds(self) -> float:
        """Run wall time.  ``timings`` keys are disjoint phases, so their
        sum never double-counts (host writeback is its own key)."""
        return sum(self.timings.values()) + self.simulated_io_seconds


class _Timer:
    """Phase wall-clock accounting.  Every second between construction and
    the final ``lap`` lands under exactly one key: ``lap`` charges the
    elapsed time since the previous lap to ``name`` (minus ``exclude``
    seconds already charged elsewhere via ``add``)."""

    def __init__(self):
        self.t = {}
        self._last = time.perf_counter()

    def lap(self, name, exclude: float = 0.0):
        now = time.perf_counter()
        self.t[name] = self.t.get(name, 0.0) + (now - self._last) - exclude
        self._last = now

    def add(self, name, seconds: float):
        self.t[name] = self.t.get(name, 0.0) + seconds


def _alloc_assignment(num_edges: int, out_path: str | None):
    if out_path is None:
        return np.full(num_edges, -1, np.int32)
    mm = np.memmap(out_path, dtype=np.int32, mode="w+", shape=(num_edges,))
    mm[:] = -1
    return mm


def _assignment_writer(dest):
    """Row sink for the pass pipeline: writes chunk results into ``dest``
    at their stream rows and returns the number of rows assigned."""
    def write_rows(lo, n, asg_np, merge):
        if merge:
            sel = asg_np >= 0
            dest[lo:lo + n][sel] = asg_np[sel]
            return int(sel.sum())
        dest[lo:lo + n] = asg_np
        return int((asg_np >= 0).sum())
    return write_rows


# ---------------------------------------------------------------------------
# on-device degree pass (pipelined)
# ---------------------------------------------------------------------------

def compute_degrees_streaming(stream: EdgeStream, chunk_size: int, *,
                              device, readahead: int = 1) -> np.ndarray:
    """The paper's upfront degree pass: the host only prefetches and pads
    chunks while an O(|V|) counter on ``device`` absorbs scatter-adds
    (padding rows add 0).  Equal to the host ``stream.compute_degrees``."""
    tracer = get_tracer()
    device = torch.device(device)
    deg = torch.zeros((stream.num_vertices,), dtype=torch.int32,
                      device=device)
    it = stream.iter_chunks_prefetch(chunk_size, readahead)
    try:
        with tracer.span("pass:degrees", cat="engine"):
            for chunk in it:
                pc = P.pad_chunk(chunk, chunk_size, device)
                w = pc.valid.to(torch.int32)
                deg.index_add_(0, pc.edges[:, 0], w)
                deg.index_add_(0, pc.edges[:, 1], w)
    finally:
        if hasattr(it, "close"):
            it.close()              # joins the prefetch thread on error
    return deg.cpu().numpy()


@dataclass
class StreamPass:
    """One sequential sweep over the edge stream."""
    phase: str                                        # timer / counter label
    chunk_fn: Callable[[dict, P.PaddedChunk], tuple]  # (state, pc) ->
    #                                                   (state, (C,) asg)
    merge: bool = False   # True: only rows with asg >= 0 overwrite
    #: run once before the sweep (e.g. upload host-folded bits to device)
    setup: Callable[[dict], dict] | None = None
    #: writeback-stage hook: (chunk (n,2) np, asg (n,) np) -> None.  Runs
    #: off the critical path, overlapped with later chunks' dispatch.
    host_fold: Callable[[np.ndarray, np.ndarray], None] | None = None


class StreamingPartitioner:
    """Plug-in protocol: ``init_state`` -> state dict of tensors,
    ``passes`` -> the sweeps, ``finalize`` -> (bits, sizes, extras)."""

    display_name: str = ""

    def _init_hierarchy(self, k: int):
        """Resolve the spec's ``host_groups``/``dcn_penalty`` against the
        run's k: sets ``self.num_hosts`` (0 when flat) and ``self.hosted``
        (True only when the penalty actually changes scoring — H >= 2 and
        ``dcn_penalty`` > 0)."""
        hg = getattr(self.spec, "host_groups", None)
        self.num_hosts = int(hg) if hg else 0
        if self.num_hosts and k % self.num_hosts:
            raise SpecError(
                f"host_groups={self.num_hosts} must divide k={k} (the mesh "
                f"places partition p on host p // (k/H))")
        self.hosted = (self.num_hosts >= 2
                       and getattr(self.spec, "dcn_penalty", 0.0) > 0)

    def init_state(self, stream: EdgeStream, k: int, timer: _Timer,
                   degrees: np.ndarray | None) -> dict:
        raise NotImplementedError

    def passes(self) -> Sequence[StreamPass]:
        raise NotImplementedError

    def finalize(self, state: dict, pass_counts: dict) -> tuple:
        """-> (bits (uint32 numpy), sizes (numpy), extras)."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# 2PS-L
# ---------------------------------------------------------------------------

class _TwoPSLPartitioner(StreamingPartitioner):
    """2PS-L, flat and host-aware: degree pass, Phase-1 clustering, LPT
    mapping, pre-partitioning (bits folded on the host), then
    two-candidate scoring (bits folded on the device)."""

    def __init__(self, spec: TwoPSLSpec, device: torch.device):
        self.spec = spec
        self.device = device
        self.display_name = spec.display_name

    def init_state(self, stream, k, timer, degrees):
        sp, dev = self.spec, self.device
        self.k, self.cap = k, capacity(stream.num_edges, k, sp.alpha)
        self._num_edges = stream.num_edges
        self._init_hierarchy(k)
        if self.num_hosts:
            self._host_of_np = host_assignment(k, self.num_hosts)
        if degrees is None:
            degrees = compute_degrees_streaming(
                stream, sp.chunk_size, device=dev,
                readahead=sp.pipeline_depth - 1)
        timer.lap("degrees")
        with get_tracer().span("pass:clustering", cat="engine",
                               passes=sp.cluster_passes):
            clus = streaming_clustering(stream, degrees, k=k, device=dev,
                                        max_vol_factor=sp.max_vol_factor,
                                        passes=sp.cluster_passes,
                                        chunk_size=sp.chunk_size,
                                        readahead=sp.pipeline_depth - 1)
        timer.lap("clustering")
        with get_tracer().span("mapping", cat="engine"):
            # host-aware LPT only when the penalty is live: host_groups
            # alone (or dcn_penalty=0) must stay identical to flat
            c2p, part_vol = map_clusters_lpt(
                clus.vol, k,
                host_of=self._host_of_np if self.hosted else None)
        timer.lap("mapping")
        self._clus, self._part_vol = clus, part_vol
        # pre-partitioning only WRITES replication state -> fold it on the
        # host in the writeback stage; the scoring pass uploads it once.
        self._bits_np = bitops.alloc_np(stream.num_vertices, k)
        if self.hosted:
            self._hbits_np = bitops.alloc_np(stream.num_vertices,
                                             self.num_hosts)

        def put(arr):
            return torch.from_numpy(np.asarray(arr, np.int32)).to(dev)
        st = {"sizes": torch.zeros((k,), dtype=torch.int32, device=dev),
              "d": put(degrees), "vol": put(clus.vol), "v2c": put(clus.v2c),
              "c2p": put(c2p)}
        if self.hosted:
            st["host_of"] = put(self._host_of_np)
        return st

    def passes(self):
        return [StreamPass("prepartition", self._prepartition,
                           host_fold=self._fold_bits_host),
                StreamPass("scoring", self._score, merge=True,
                           setup=self._upload_bits)]

    def _prepartition(self, st, pc):
        _, asg, _ = P._prepartition_core(
            st["sizes"], st["d"], st["v2c"], st["c2p"],
            pc.edges, pc.valid, k=self.k, cap=self.cap)
        return st, asg

    def _fold_bits_host(self, chunk, asg):
        m = asg >= 0
        p = asg[m]
        bitops.set_np(self._bits_np, chunk[m, 0], p)
        bitops.set_np(self._bits_np, chunk[m, 1], p)
        if self.hosted:
            h = self._host_of_np[p]
            bitops.set_np(self._hbits_np, chunk[m, 0], h)
            bitops.set_np(self._hbits_np, chunk[m, 1], h)

    def _upload_bits(self, st):
        st = {**st, "bits": words_to_torch(self._bits_np, self.device)}
        if self.hosted:
            st["hbits"] = words_to_torch(self._hbits_np, self.device)
        return st

    def _score(self, st, pc):
        if self.hosted:
            *_, asg = P._score_chunk_hosted(
                st["bits"], st["hbits"], st["sizes"], st["d"], st["vol"],
                st["v2c"], st["c2p"], st["host_of"], pc.edges, pc.valid,
                k=self.k, cap=self.cap, dcn_penalty=self.spec.dcn_penalty)
        else:
            *_, asg = P._score_chunk(
                st["bits"], st["sizes"], st["d"], st["vol"], st["v2c"],
                st["c2p"], pc.edges, pc.valid, k=self.k, cap=self.cap)
        return st, asg

    def finalize(self, state, pass_counts):
        extras = {
            "prepartition_ratio":
                pass_counts.get("prepartition", 0) / max(self._num_edges, 1),
            "num_clusters": self._clus.num_clusters,
            "max_vol": self._clus.max_vol,
            "cluster_passes": self.spec.cluster_passes,
            "part_volumes": np.asarray(self._part_vol),
            "kernel_backend": ("cuda" if self.device.type == "cuda"
                               else "torch-cpu"),
        }
        return (words_to_numpy(state["bits"]), state["sizes"].cpu().numpy(),
                extras)


#: registry name -> the ROADMAP.md Queue 1 item that ports it
_NOT_PORTED = {
    "2ps-hdrf": "item 5 (2PS-HDRF and HDRF with the hdrf_score kernel)",
    "hdrf": "item 5 (2PS-HDRF and HDRF with the hdrf_score kernel)",
    "greedy": "item 5 (2PS-HDRF and HDRF with the hdrf_score kernel)",
    "dbh": "item 6 (the hash partitioners)",
    "grid": "item 6 (the hash partitioners)",
    "random": "item 6 (the hash partitioners)",
    "hep": "item 9 (the remaining partitioner families)",
    "buffered": "item 9 (the remaining partitioner families)",
}


def build_partitioner(spec: PartitionerSpec,
                      device="cuda") -> StreamingPartitioner:
    """Spec -> plug-in state machine for ``run_spec``.  Only 2PS-L is
    ported; every other spec raises ``NotImplementedError``."""
    if isinstance(spec, TwoPSLSpec) and spec.scoring == "2psl":
        return _TwoPSLPartitioner(spec, torch.device(device))
    item = _NOT_PORTED.get(spec.algorithm, "its queue item")
    raise NotImplementedError(
        f"{spec.algorithm!r} is not ported to repro_torch yet: see "
        f"ROADMAP.md Queue 1, {item}")


# ---------------------------------------------------------------------------
# the one driver
# ---------------------------------------------------------------------------

def _traced_chunks(it, tracer, stall):
    """Wrap the raw chunk iterator so each read/decode is credited to the
    prefetch stage *on whatever thread runs it*."""
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            chunk = next(it)
        except StopIteration:
            return
        dt = time.perf_counter() - t0
        tracer.complete("read", "prefetch", dt, chunk=i)
        stall.add("prefetch", dt)
        yield chunk
        i += 1


_STREAM_END = object()


@dataclass
class _PassResult:
    state: dict
    assigned: int      # rows this sweep assigned (pass-count delta)
    wb_host: float     # host-side writeback seconds


def _to_host_async(asg: torch.Tensor):
    """Start the device->host copy of a chunk's assignment: a pinned buffer
    plus the event that marks the copy done (``None`` on the CPU)."""
    if asg.device.type != "cuda":
        return asg, None
    host = torch.empty(asg.shape, dtype=asg.dtype, pin_memory=True)
    host.copy_(asg, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return host, ev


def _run_pass_pipeline(sp, state, stream, *, chunk_size, depth, device,
                       tracer, metrics, stall, write_rows):
    """Drive one ``StreamPass``'s read -> dispatch -> writeback pipeline
    over the whole stream."""
    inflight: deque = deque()   # (lo, chunk_np, n, host asg, event, index)
    assigned = 0
    lo = 0
    wb_host = 0.0

    inflight_gauge = metrics.gauge("engine.chunks_in_flight")
    edges_ctr = metrics.counter("engine.edges_streamed")
    chunks_ctr = metrics.counter("engine.chunks_total")
    dispatch_hist = metrics.histogram("engine.dispatch_seconds")
    writeback_hist = metrics.histogram("engine.writeback_seconds")

    def _writeback():
        nonlocal assigned, wb_host
        w_lo, w_chunk, w_n, w_host, w_ev, w_i = inflight.popleft()
        t0 = time.perf_counter()
        if w_ev is not None:
            w_ev.synchronize()
        t1 = time.perf_counter()
        asg_np = w_host.numpy()[:w_n]
        assigned += write_rows(w_lo, w_n, asg_np, sp.merge)
        if sp.host_fold is not None:
            sp.host_fold(w_chunk, asg_np)
        t2 = time.perf_counter()
        tracer.complete("device_wait", "writeback", t1 - t0, chunk=w_i)
        tracer.complete("writeback", "writeback", t2 - t1, chunk=w_i)
        stall.add("writeback", t2 - t0)
        stall.attribute("device_wait", t1 - t0)
        stall.attribute("host_write", t2 - t1)
        writeback_hist.observe(t2 - t0)
        wb_host += t2 - t1

    it = prefetch(_traced_chunks(stream.iter_chunks(chunk_size), tracer,
                                 stall), readahead=depth - 1)
    ci = 0
    try:
        with tracer.span(f"pass:{sp.phase}", cat="engine",
                         depth=depth, merge=sp.merge):
            while True:
                tq = time.perf_counter()
                chunk = next(it, _STREAM_END)
                wait = time.perf_counter() - tq
                tracer.complete("queue_wait", "dispatch", wait, chunk=ci)
                stall.attribute("queue_wait", wait)
                if chunk is _STREAM_END:
                    break
                td = time.perf_counter()
                pc = P.pad_chunk(chunk, chunk_size, device)
                state, asg = sp.chunk_fn(state, pc)
                host, ev = _to_host_async(asg)
                dt = time.perf_counter() - td
                tracer.complete("dispatch", "dispatch", dt, chunk=ci)
                stall.add("dispatch", dt)
                dispatch_hist.observe(dt)
                inflight.append((lo, chunk, pc.n, host, ev, ci))
                inflight_gauge.set(len(inflight))
                edges_ctr.inc(pc.n)
                chunks_ctr.inc()
                lo += pc.n
                ci += 1
                while len(inflight) >= depth:
                    _writeback()
            while inflight:
                _writeback()
            tdr = time.perf_counter()
            _synchronize(device)
            drain = time.perf_counter() - tdr
            tracer.complete("device_wait", "writeback", drain, drain=True)
            stall.attribute("device_wait", drain)
    finally:
        if hasattr(it, "close"):
            it.close()              # joins the prefetch thread on error
    return _PassResult(state=state, assigned=assigned, wb_host=wb_host)


def run_spec(spec: PartitionerSpec, stream: EdgeStream, k: int, *,
             device="cuda", out_path: str | None = None,
             degrees: np.ndarray | None = None,
             tracer=None, metrics=None, retry_policy=None,
             checkpoint_every_chunks: int | None = None,
             checkpoint_dir: str | None = None,
             resume_from: str | None = None) -> PartitionRunResult:
    """Execute a PartitionerSpec over an edge stream on ``device`` (see the
    module docstring for the pipeline model).

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    pass ``device="cpu"`` to run the plain versions on the CPU.
    ``out_path`` writes the assignment as an int32 memmap instead of an
    in-memory array; ``degrees`` short-circuits the upfront degree pass.
    ``tracer`` / ``metrics`` (``repro_torch.obs``) record the same spans,
    stall report (``extras['stall_report']``) and instruments as the
    reference engine.

    Example::

        stream = InMemoryEdgeStream(edges)
        res = run_spec(spec_for("2psl", chunk_size=1 << 14), stream, k=32)
        res.quality.replication_factor   # the paper's RF
        res.extras["kernel_backend"]     # 'cuda'

    ``retry_policy`` and the checkpoint arguments belong to the robustness
    layer, which is not ported yet: passing any of them raises.
    """
    if (retry_policy is not None or checkpoint_every_chunks is not None
            or checkpoint_dir is not None or resume_from is not None):
        raise NotImplementedError(
            "retry_policy and checkpoint/resume are not ported to "
            "repro_torch yet: see ROADMAP.md Queue 1, item 8")
    device = resolve_device(device)
    part = build_partitioner(spec, device)
    tracer = get_tracer() if tracer is None else tracer
    metrics = get_registry() if metrics is None else metrics
    with use_tracer(tracer), use_registry(metrics):
        return _run_spec_traced(spec, part, stream, k, out_path, degrees,
                                tracer, metrics, device)


def _run_spec_traced(spec, part, stream, k, out_path, degrees, tracer,
                     metrics, device):
    timer = _Timer()
    with tracer.span("init", cat="engine", algorithm=spec.algorithm, k=k):
        state = part.init_state(stream, k, timer, degrees)
    assignment = _alloc_assignment(stream.num_edges, out_path)
    depth = spec.pipeline_depth
    edges_ctr = metrics.counter("engine.edges_streamed")

    pass_counts: dict[str, int] = {}
    pass_stalls = []
    passes_wall = 0.0
    write_rows = _assignment_writer(assignment)
    for sp in part.passes():
        if sp.setup is not None:
            with tracer.span("setup", cat="engine", phase=sp.phase):
                state = sp.setup(state)
        stall = StallClock()
        pr = _run_pass_pipeline(
            sp, state, stream, chunk_size=spec.chunk_size, depth=depth,
            device=device, tracer=tracer, metrics=metrics, stall=stall,
            write_rows=write_rows)
        state = pr.state
        timer.lap(sp.phase, exclude=pr.wb_host)
        timer.add("writeback", pr.wb_host)
        pass_counts[sp.phase] = pass_counts.get(sp.phase, 0) + pr.assigned
        ps = stall.report(sp.phase)
        pass_stalls.append(ps)
        passes_wall += ps.wall_seconds

    with tracer.span("finalize", cat="engine"):
        bits_np, sizes_np, extras = part.finalize(state, pass_counts)
        quality = quality_from_bitmatrix(bits_np, sizes_np,
                                         stream.num_edges)
    timer.lap("finalize")
    metrics.gauge("engine.replication_state_bytes").set(bits_np.nbytes)
    if passes_wall > 0:
        metrics.gauge("engine.edges_per_sec").set(
            edges_ctr.value / passes_wall if metrics.enabled else 0.0)
    if tracer.enabled:
        extras["stall_report"] = PipelineStallReport(
            passes=pass_stalls).to_dict()
    if getattr(part, "num_hosts", 0):
        # hierarchy-aware quality: how many host groups each vertex spans
        extras["num_hosts"] = part.num_hosts
        extras["dcn_penalty"] = float(getattr(spec, "dcn_penalty", 0.0))
        extras["cross_host_rf"] = cross_host_replication_factor(
            bits_np, k, part.num_hosts)
    if isinstance(assignment, np.memmap):
        assignment.flush()
    return PartitionRunResult(
        name=part.display_name, k=k, alpha=spec.alpha,
        assignment=assignment, quality=quality, timings=timer.t,
        extras=extras, simulated_io_seconds=stream.simulated_io_seconds,
        spec=spec)
