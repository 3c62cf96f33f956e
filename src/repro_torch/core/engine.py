"""The out-of-core streaming engine, in PyTorch.

``run_spec`` streams an edge list through a partitioner's passes, exactly
as the reference engine does, with the device state held in torch tensors
on the run's ``device`` (the card by default).  Every registered spec runs:
2PS-L and 2PS-HDRF, the HDRF and Greedy baselines, the DBH, Grid and Random
hashes, HEP (``core/hybrid.py``) and buffered re-streaming
(``core/buffered.py``).

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
kernels' plain versions.

Checkpoint/resume follows the reference engine's protocol and layout
(``repro_torch.robust.checkpoint``): every ``checkpoint_every_chunks``
dispatched chunks the pipeline drains — every in-flight writeback waits on
its copy's event and the device is synchronized — and the state dict goes
to disk through ``convert.state_to_numpy`` (word matrices as the
reference's uint32), beside the partitioner's ``host_state`` and the
cursor.  A resumed run restores it with ``convert.state_to_torch`` and
replays the remaining chunks into identical assignments, whichever of the
two packages wrote the checkpoint.  Shard merging is not ported yet.
"""
from __future__ import annotations

import math
import os
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
from .convert import (state_to_numpy, state_to_torch, words_to_numpy,
                      words_to_torch)
from .mapping import map_clusters_lpt
from .metrics import (PartitionQuality, capacity,
                      cross_host_replication_factor, host_assignment,
                      quality_from_bitmatrix)
from .specs import (BufferedSpec, DBHSpec, HDRFSpec, HEPSpec,
                    PartitionerSpec, SPEC_REGISTRY, SpecError, StatelessSpec,
                    TwoPSLSpec)
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


def _alloc_assignment(num_edges: int, out_path: str | None,
                      resume: bool = False):
    if out_path is None:
        return np.full(num_edges, -1, np.int32)
    if resume and os.path.exists(out_path):
        # a resumed run re-opens the partial assignment in place; every
        # row at or beyond the checkpointed cursor is rewritten by replay
        return np.memmap(out_path, dtype=np.int32, mode="r+",
                         shape=(num_edges,))
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


def _nbytes(arr) -> int:
    if isinstance(arr, torch.Tensor):
        return arr.numel() * arr.element_size()
    return int(np.asarray(arr).nbytes)


def _set_replication_gauge(part, metrics, bits) -> None:
    """Refresh ``engine.replication_state_bytes``: budgeted partitioners
    (HEP) report their pinned footprint; everyone else the size of
    ``bits``, the replication bit matrix currently resident (the finalized
    matrix at finalize; on resume restore the device's, or the host-folded
    copy when the pass folds it on the host)."""
    resident = part.replication_state_bytes()
    if resident is None:
        resident = _nbytes(bits) if bits is not None else 0
    metrics.gauge("engine.replication_state_bytes").set(int(resident))


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
    #: chunk regrouping factor: the engine feeds this pass windows of
    #: ``window * spec.chunk_size`` edges per ``chunk_fn`` call (buffered
    #: re-streaming's edge buffer).  The pipeline, writeback, and
    #: checkpoint cursor all count these regrouped windows, so checkpoints
    #: land exactly at window boundaries.
    window: int = 1


class StreamingPartitioner:
    """Plug-in protocol: ``init_state`` -> state dict of tensors,
    ``passes`` -> the sweeps, ``finalize`` -> (bits, sizes, extras)."""

    display_name: str = ""

    def __init__(self, spec: PartitionerSpec, device: torch.device):
        self.spec = spec
        self.device = device
        self.display_name = spec.display_name

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

    # -- checkpoint / resume protocol (repro_torch.robust) ---------------
    # The engine checkpoints the device-state dict generically; these three
    # hooks cover what lives OUTSIDE it: host-folded arrays (bit matrices,
    # hash-family sizes) and the metadata init_state derived from its
    # prologue sweeps (clustering tables, degrees).  A resumed run calls
    # ``init_for_resume`` (cheap scalar setup — no stream sweeps) followed
    # by ``restore_host_state``; the device state is then restored from
    # the checkpoint wholesale, so identity never depends on re-running
    # the prologue.

    def host_state(self) -> dict:
        """Host-side numpy arrays the engine must checkpoint beyond the
        device state dict (default: none)."""
        return {}

    def restore_host_state(self, arrays: dict) -> None:
        pass

    def init_for_resume(self, stream: EdgeStream, k: int,
                        timer: _Timer) -> None:
        """Set up scalar attributes without the streaming prologue.  The
        fallback re-runs ``init_state`` (deterministic, so still identical
        — just not free); partitioners with stream-sweeping prologues
        override to skip them."""
        self.init_state(stream, k, timer, None)

    def replication_state_bytes(self) -> int | None:
        """Bytes of replication state kept resident for scoring.  ``None``
        (the default) means the full packed bit matrix: the engine then
        reports the finalized matrix's size on the
        ``engine.replication_state_bytes`` gauge.  HEP overrides it with
        its pinned rows, which ``memory_budget_bytes`` bounds."""
        return None


def _kernel_backend(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "torch-cpu"


# ---------------------------------------------------------------------------
# 2PS-L / 2PS-HDRF
# ---------------------------------------------------------------------------

class _TwoPSLPartitioner(StreamingPartitioner):
    """2PS-L and 2PS-HDRF, flat and host-aware: degree pass, Phase-1
    clustering, LPT mapping, pre-partitioning (bits folded on the host),
    then scoring (bits folded on the device) — two candidates per edge for
    2PS-L, all k partitions (HDRF) for 2PS-HDRF."""

    def init_state(self, stream, k, timer, degrees):
        sp, dev = self.spec, self.device
        self.k, self.cap = k, capacity(stream.num_edges, k, sp.alpha)
        self._num_edges = stream.num_edges
        self._init_hierarchy(k)
        # the 2-candidate scorer gathers host presence from an O(|V|*H)-bit
        # per-HOST replica matrix; the k-way 2PS-HDRF scorer derives it
        # from the replica rows it gathers anyway
        self._track_hbits = self.hosted and sp.scoring == "2psl"
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
        if self._track_hbits:
            self._hbits_np = bitops.alloc_np(stream.num_vertices,
                                             self.num_hosts)

        def put(arr):
            return torch.from_numpy(np.asarray(arr, np.int32)).to(dev)
        st = {"sizes": torch.zeros((k,), dtype=torch.int32, device=dev),
              "d": put(degrees), "vol": put(clus.vol), "v2c": put(clus.v2c),
              "c2p": put(c2p)}
        if self._track_hbits:
            st["host_of"] = put(self._host_of_np)
        return st

    def passes(self):
        return [StreamPass("prepartition", self._prepartition,
                           host_fold=self._fold_bits_host),
                StreamPass("scoring", self._score, merge=True,
                           setup=self._upload_bits)]

    def host_state(self):
        # the clustering/mapping tables init_state derives from its two
        # prologue sweeps ride along so resume never re-streams the graph
        d = {"bits": self._bits_np,
             "clus_v2c": self._clus.v2c, "clus_vol": self._clus.vol,
             "clus_degrees": self._clus.degrees,
             "clus_max_vol": np.asarray(self._clus.max_vol),
             "part_vol": np.asarray(self._part_vol)}
        if self._track_hbits:
            d["hbits"] = self._hbits_np
        return d

    def restore_host_state(self, arrays):
        from .clustering import ClusteringResult
        self._bits_np = np.ascontiguousarray(arrays["bits"])
        if self._track_hbits:
            self._hbits_np = np.ascontiguousarray(arrays["hbits"])
        self._clus = ClusteringResult(
            v2c=arrays["clus_v2c"], vol=arrays["clus_vol"],
            degrees=arrays["clus_degrees"],
            max_vol=int(arrays["clus_max_vol"]))
        self._part_vol = arrays["part_vol"]

    def init_for_resume(self, stream, k, timer):
        sp = self.spec
        self.k, self.cap = k, capacity(stream.num_edges, k, sp.alpha)
        self._num_edges = stream.num_edges
        self._init_hierarchy(k)
        self._track_hbits = self.hosted and sp.scoring == "2psl"
        if self.num_hosts:
            self._host_of_np = host_assignment(k, self.num_hosts)

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
        if self._track_hbits:
            h = self._host_of_np[p]
            bitops.set_np(self._hbits_np, chunk[m, 0], h)
            bitops.set_np(self._hbits_np, chunk[m, 1], h)

    def _upload_bits(self, st):
        st = {**st, "bits": words_to_torch(self._bits_np, self.device)}
        if self._track_hbits:
            st["hbits"] = words_to_torch(self._hbits_np, self.device)
        return st

    def _score(self, st, pc):
        sp = self.spec
        if sp.scoring == "hdrf":
            *_, asg = P._hdrf_remaining_chunk(
                st["bits"], st["sizes"], st["d"], st["v2c"], st["c2p"],
                pc.edges, pc.valid, k=self.k, cap=self.cap,
                lam=sp.hdrf_lambda,
                num_hosts=self.num_hosts if self.hosted else 0,
                dcn_penalty=sp.dcn_penalty if self.hosted else 0.0)
        elif self.hosted:
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
            "kernel_backend": _kernel_backend(self.device),
        }
        return (words_to_numpy(state["bits"]), state["sizes"].cpu().numpy(),
                extras)


# ---------------------------------------------------------------------------
# HDRF / Greedy
# ---------------------------------------------------------------------------

class _HDRFPartitioner(StreamingPartitioner):
    """HDRF and PowerGraph Greedy: one pass of k-way scoring in 64-edge
    micro-batches, with the bits, sizes and HDRF's streamed partial
    degrees ``dpart`` on the device."""

    def init_state(self, stream, k, timer, degrees):
        self.k = k
        self.cap = capacity(stream.num_edges, k, self.spec.alpha)
        self._init_hierarchy(k)
        dev = self.device
        return {"bits": torch.zeros((stream.num_vertices, bitops.num_words(k)),
                                    dtype=torch.int32, device=dev),
                "sizes": torch.zeros((k,), dtype=torch.int32, device=dev),
                "dpart": torch.zeros((stream.num_vertices,),
                                     dtype=torch.int32, device=dev)}

    def passes(self):
        return [StreamPass("scoring", self._chunk)]

    def init_for_resume(self, stream, k, timer):
        # everything HDRF carries lives in the device state — skip the
        # O(|V|*k) bit-matrix allocation init_state would throw away
        self.k = k
        self.cap = capacity(stream.num_edges, k, self.spec.alpha)
        self._init_hierarchy(k)

    def _chunk(self, st, pc):
        sp = self.spec
        *_, asg = P._hdrf_chunk(
            st["bits"], st["sizes"], st["dpart"], pc.edges, pc.valid,
            k=self.k, cap=self.cap, lam=sp.lam, use_cap=sp.use_cap,
            sub=sp.MICRO_BATCH, degree_weighted=sp.degree_weighted,
            num_hosts=self.num_hosts if self.hosted else 0,
            dcn_penalty=sp.dcn_penalty if self.hosted else 0.0, n=pc.n)
        return st, asg

    def finalize(self, state, pass_counts):
        return (words_to_numpy(state["bits"]), state["sizes"].cpu().numpy(),
                {"kernel_backend": _kernel_backend(self.device)})


# ---------------------------------------------------------------------------
# stateless hashing family (DBH / Grid / Random)
# ---------------------------------------------------------------------------

class _HashPartitioner(StreamingPartitioner):
    """Shared driver for the per-edge hash partitioners: the chunk function
    is a pure map on the device, and the bits and sizes accumulate on the
    host in the writeback stage, overlapped with later chunks' hashing."""

    phase = "hashing"

    def init_state(self, stream, k, timer, degrees):
        self.k = k
        self._init_hierarchy(k)   # hashes never score, but host_groups
        #                           still gates the cross-host RF metric
        self._bits_np = bitops.alloc_np(stream.num_vertices, k)
        self._sizes_np = np.zeros((k,), np.int64)
        return {}

    def passes(self):
        return [StreamPass(self.phase, self._chunk,
                           host_fold=self._fold_host)]

    def _hash_chunk(self, st, pc):
        raise NotImplementedError

    def _chunk(self, st, pc):
        return st, self._hash_chunk(st, pc)

    def _fold_host(self, chunk, asg):
        m = asg >= 0
        p = asg[m]
        bitops.set_np(self._bits_np, chunk[m, 0], p)
        bitops.set_np(self._bits_np, chunk[m, 1], p)
        self._sizes_np += np.bincount(p, minlength=self.k)

    def finalize(self, state, pass_counts):
        return self._bits_np, self._sizes_np, {}

    def host_state(self):
        return {"bits": self._bits_np, "sizes": self._sizes_np}

    def restore_host_state(self, arrays):
        self._bits_np = np.ascontiguousarray(arrays["bits"])
        self._sizes_np = np.ascontiguousarray(arrays["sizes"])

    def init_for_resume(self, stream, k, timer):
        # DBH's degrees live in the device state ("d"), so even it skips
        # its prologue sweep here
        self.k = k
        self._init_hierarchy(k)


class _DBHPartitioner(_HashPartitioner):
    def init_state(self, stream, k, timer, degrees):
        if degrees is None:
            degrees = compute_degrees_streaming(
                stream, self.spec.chunk_size, device=self.device,
                readahead=self.spec.pipeline_depth - 1)
        st = super().init_state(stream, k, timer, degrees)
        st["d"] = torch.from_numpy(np.asarray(degrees, np.int32)).to(
            self.device)
        timer.lap("degrees")
        return st

    def _hash_chunk(self, st, pc):
        return P._dbh_chunk(st["d"], pc.edges, pc.valid, k=self.k)


class _GridPartitioner(_HashPartitioner):
    def _grid_shape(self, k):
        rows = math.isqrt(k)
        while k % rows:
            rows -= 1
        self.rows, self.cols = rows, k // rows

    def init_state(self, stream, k, timer, degrees):
        self._grid_shape(k)
        return super().init_state(stream, k, timer, degrees)

    def init_for_resume(self, stream, k, timer):
        self._grid_shape(k)
        super().init_for_resume(stream, k, timer)

    def _hash_chunk(self, st, pc):
        return P._grid_chunk(pc.edges, pc.valid, k=self.k, rows=self.rows,
                             cols=self.cols)


class _RandomPartitioner(_HashPartitioner):
    def _hash_chunk(self, st, pc):
        return P._random_hash_chunk(pc.edges, pc.valid, k=self.k)


#: the registered names ``build_partitioner`` runs: all of them
PORTED = tuple(SPEC_REGISTRY)


def build_partitioner(spec: PartitionerSpec,
                      device="cuda") -> StreamingPartitioner:
    """Spec -> plug-in state machine for ``run_spec``."""
    device = torch.device(device)
    if isinstance(spec, TwoPSLSpec):
        return _TwoPSLPartitioner(spec, device)
    if isinstance(spec, HDRFSpec):
        return _HDRFPartitioner(spec, device)
    if isinstance(spec, DBHSpec):
        return _DBHPartitioner(spec, device)
    if isinstance(spec, StatelessSpec):
        return (_GridPartitioner if spec.variant == "grid"
                else _RandomPartitioner)(spec, device)
    if isinstance(spec, HEPSpec):
        from .hybrid import _HEPPartitioner          # lazy: avoids a cycle
        return _HEPPartitioner(spec, device)
    if isinstance(spec, BufferedSpec):
        from .buffered import _BufferedPartitioner   # lazy: avoids a cycle
        return _BufferedPartitioner(spec, device)
    raise TypeError(f"no streaming partitioner for {type(spec).__name__}")


# ---------------------------------------------------------------------------
# the one driver
# ---------------------------------------------------------------------------

def _traced_chunks(it, tracer, stall, start=0):
    """Wrap the raw chunk iterator so each read/decode is credited to the
    prefetch stage *on whatever thread runs it*."""
    i = start
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
    """One pipelined sweep's outcome: the end state plus the cursors and
    host-time split the caller folds into timings and checkpoint meta."""
    state: dict
    assigned: int      # rows this sweep assigned (pass-count delta)
    lo: int            # next assignment row
    next_chunk: int    # next chunk index
    wb_host: float     # host-side writeback seconds
    ckpt_host: float   # checkpoint-save seconds (drain included)


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
                       tracer, metrics, stall, write_rows, first_chunk=0,
                       first_lo=0, assigned0=0, ckpt_every=None,
                       save_state=None, pass_index=0):
    """Drive one ``StreamPass``'s read -> dispatch -> writeback pipeline
    over ``stream``'s chunks from ``first_chunk`` to the stream end.

    ``write_rows(lo, n, asg_np, merge) -> assigned`` is the assignment
    sink; ``save_state(next_chunk, state, lo, assigned)`` persists a
    checkpoint after the pipeline drains (every ``ckpt_every`` chunks).
    """
    inflight: deque = deque()   # (lo, chunk_np, n, host asg, event, index)
    assigned = assigned0
    lo = first_lo
    wb_host = 0.0               # host-side writeback seconds this sweep
    ckpt_host = 0.0             # checkpoint-save seconds this sweep

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

    def _save_checkpoint(next_chunk):
        nonlocal ckpt_host
        t0 = time.perf_counter()
        # consistency barrier: every in-flight copy lands (and is written
        # and folded) and the device finishes the state updates, so the
        # state, the assignment rows below ``lo`` and the cursor agree
        while inflight:
            _writeback()
        _synchronize(device)
        save_state(int(next_chunk), state, lo, assigned)
        dt = time.perf_counter() - t0
        ckpt_host += dt
        tracer.complete("checkpoint", "robust", dt, pass_index=pass_index,
                        next_chunk=int(next_chunk))
        metrics.counter("engine.checkpoints").inc()

    raw = stream.iter_chunks_from(chunk_size, first_chunk)
    it = prefetch(_traced_chunks(raw, tracer, stall, start=first_chunk),
                  readahead=depth - 1)
    ci = first_chunk
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
                if ckpt_every and save_state is not None \
                        and ci % ckpt_every == 0:
                    _save_checkpoint(ci)
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
    return _PassResult(state=state, assigned=assigned, lo=lo,
                       next_chunk=ci, wb_host=wb_host, ckpt_host=ckpt_host)


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

    Robustness (``repro_torch.robust``, guide: docs/robustness.md):

    * ``retry_policy`` (``RetryPolicy``) wraps the stream in a validating
      ``ResilientStream`` — every chunk read (degree pass, clustering and
      all partitioning passes) is checked against the stream geometry and
      retried with bounded backoff; recoveries land in
      ``engine.io_retries`` and ``extras['io_retries']``.
    * ``checkpoint_every_chunks=N`` (requires ``checkpoint_dir``) drains
      the pipeline every N dispatched chunks and atomically snapshots the
      engine's O(|V|) pass state plus the chunk cursor.
    * ``resume_from=dir`` restarts from the latest checkpoint in ``dir``
      (a fresh run when the directory holds none) and replays the
      remaining chunks into identical final assignments;
      ``extras['resumes']`` counts the lineage's resumes.  Memmap runs
      must pass the same ``out_path`` — the partial assignment is
      re-opened in place, never copied into the checkpoint.
    """
    if checkpoint_every_chunks is not None:
        if checkpoint_every_chunks < 1:
            raise ValueError("checkpoint_every_chunks must be >= 1")
        if checkpoint_dir is None:
            raise ValueError("checkpoint_every_chunks requires "
                             "checkpoint_dir")
    device = resolve_device(device)
    if retry_policy is not None:
        from ..robust.faults import ResilientStream
        stream = ResilientStream(stream, retry_policy)
    part = build_partitioner(spec, device)
    tracer = get_tracer() if tracer is None else tracer
    metrics = get_registry() if metrics is None else metrics
    with use_tracer(tracer), use_registry(metrics):
        return _run_spec_traced(spec, part, stream, k, out_path, degrees,
                                tracer, metrics, device,
                                checkpoint_every_chunks, checkpoint_dir,
                                resume_from)


def _run_spec_traced(spec, part, stream, k, out_path, degrees, tracer,
                     metrics, device, ckpt_every=None, ckpt_dir=None,
                     resume_from=None):
    timer = _Timer()
    ckpt = None
    if resume_from is not None:
        from ..robust import checkpoint as _ck
        ckpt = _ck.load_engine_checkpoint(resume_from)
        if ckpt is not None:
            _ck.check_compatible(ckpt.meta, spec, stream, k, out_path)
    if ckpt is not None:
        with tracer.span("resume", cat="engine", algorithm=spec.algorithm,
                         pass_index=int(ckpt.meta["pass_index"]),
                         next_chunk=int(ckpt.meta["next_chunk"])):
            part.init_for_resume(stream, k, timer)
            part.restore_host_state(ckpt.host_state)
            state = state_to_torch(ckpt.device_state, device)
        assignment = _alloc_assignment(stream.num_edges, out_path,
                                       resume=True)
        if ckpt.assignment is not None:
            assignment[:] = ckpt.assignment
        timer.lap("resume")
        metrics.counter("engine.resumes").inc()
        # restoring mid-run state re-establishes the O(|V|) footprint the
        # gauge advertises — a resumed process must not report 0
        bits = state.get("bits") if isinstance(state, dict) else None
        if bits is None:
            bits = part.host_state().get("bits")
        _set_replication_gauge(part, metrics, bits)
    else:
        with tracer.span("init", cat="engine", algorithm=spec.algorithm,
                         k=k):
            state = part.init_state(stream, k, timer, degrees)
        assignment = _alloc_assignment(stream.num_edges, out_path)
    depth = spec.pipeline_depth
    edges_ctr = metrics.counter("engine.edges_streamed")

    resumes = int(ckpt.meta["resumes"]) + 1 if ckpt is not None else 0
    checkpoints_written = 0
    start_pass = int(ckpt.meta["pass_index"]) if ckpt is not None else 0
    pass_counts: dict[str, int] = (
        {kk: int(v) for kk, v in ckpt.meta["pass_counts"].items()}
        if ckpt is not None else {})
    pass_stalls = []
    passes_wall = 0.0
    write_rows = _assignment_writer(assignment)
    for pi, sp in enumerate(part.passes()):
        if pi < start_pass:
            continue                # completed before the checkpoint
        resuming_here = ckpt is not None and pi == start_pass
        # the checkpointed device state is post-setup for the pass in
        # flight (2PS-L's scoring pass: the bits it uploaded and has been
        # folding since), so setup must not run again on resume
        if sp.setup is not None and not resuming_here:
            with tracer.span("setup", cat="engine", phase=sp.phase):
                state = sp.setup(state)
        stall = StallClock()

        def _save_state(next_chunk, st, lo, assigned, *, _pi=pi):
            nonlocal checkpoints_written
            from ..robust import checkpoint as _ck
            if isinstance(assignment, np.memmap):
                assignment.flush()
                asg_copy = None
            else:
                asg_copy = np.array(assignment, copy=True)
            meta = {"spec_hash": _ck.spec_hash(spec),
                    "algorithm": spec.algorithm, "k": int(k),
                    "num_edges": int(stream.num_edges),
                    "num_vertices": int(stream.num_vertices),
                    "chunk_size": int(spec.chunk_size),
                    "pass_index": _pi, "next_chunk": int(next_chunk),
                    "edge_lo": int(lo), "assigned": int(assigned),
                    "pass_counts": dict(pass_counts),
                    "resumes": resumes,
                    "assignment_in_checkpoint": asg_copy is not None}
            _ck.save_engine_checkpoint(ckpt_dir, _ck.EngineCheckpoint(
                meta=meta, device_state=state_to_numpy(st),
                host_state=part.host_state(), assignment=asg_copy))
            checkpoints_written += 1
            _ck.crash_after_checkpoints(checkpoints_written)

        # buffered re-streaming regroups the stream into windows of
        # ``window`` engine chunks: the pass streams and pads in those
        # units, and every cursor (checkpointing included) counts them, so
        # a resumed run replays from the identical window boundary
        eff_chunk = spec.chunk_size * max(1, int(sp.window))
        pr = _run_pass_pipeline(
            sp, state, stream, chunk_size=eff_chunk, depth=depth,
            device=device, tracer=tracer, metrics=metrics, stall=stall,
            write_rows=write_rows,
            first_chunk=int(ckpt.meta["next_chunk"]) if resuming_here
            else 0,
            first_lo=int(ckpt.meta["edge_lo"]) if resuming_here else 0,
            assigned0=int(ckpt.meta["assigned"]) if resuming_here else 0,
            ckpt_every=ckpt_every,
            save_state=_save_state if ckpt_dir is not None else None,
            pass_index=pi)
        state = pr.state
        timer.lap(sp.phase, exclude=pr.wb_host + pr.ckpt_host)
        timer.add("writeback", pr.wb_host)
        if pr.ckpt_host:
            timer.add("checkpoint", pr.ckpt_host)
        pass_counts[sp.phase] = pass_counts.get(sp.phase, 0) + pr.assigned
        ps = stall.report(sp.phase)
        pass_stalls.append(ps)
        passes_wall += ps.wall_seconds

    with tracer.span("finalize", cat="engine"):
        bits_np, sizes_np, extras = part.finalize(state, pass_counts)
        quality = quality_from_bitmatrix(bits_np, sizes_np,
                                         stream.num_edges)
    timer.lap("finalize")
    _set_replication_gauge(part, metrics, bits_np)
    if passes_wall > 0:
        metrics.gauge("engine.edges_per_sec").set(
            edges_ctr.value / passes_wall if metrics.enabled else 0.0)
    if tracer.enabled:
        extras["stall_report"] = PipelineStallReport(
            passes=pass_stalls).to_dict()
    if resumes:
        extras["resumes"] = resumes
    if ckpt_every:
        extras["checkpoints_written"] = checkpoints_written
    io_retries = getattr(stream, "retries", None)
    if io_retries is not None:
        extras["io_retries"] = int(io_retries)
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
