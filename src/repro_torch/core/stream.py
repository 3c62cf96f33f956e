"""Out-of-core edge streams.

2PS-L never materializes the edge set in memory: every phase is one (or a
few) sequential passes over an edge stream.  The stream implementations here
mirror the paper's setup:

* ``InMemoryEdgeStream``   — edges already resident (the "page cache" row of
                             Table V; also used by tests/benchmarks).
* ``MemmapEdgeStream``     — the paper's binary edge-list file format (pairs
                             of little-endian 32-bit vertex IDs) read through
                             ``np.memmap`` chunk by chunk; O(chunk) memory.
* ``ThrottledEdgeStream``  — wraps another stream and *accounts* simulated
                             I/O time for a given sequential-read bandwidth
                             (SSD ≈ 938 MB/s, HDD ≈ 158 MB/s in the paper's
                             fio profile).  Used by the Table V benchmark;
                             virtual time keeps CI fast while preserving the
                             paper's I/O model.
"""
from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass, field
from typing import Iterable, Iterator

import numpy as np

BYTES_PER_EDGE = 8  # two little-endian uint32 vertex ids

_DONE = object()


class _ProducerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(it: Iterable, readahead: int) -> Iterator:
    """Pull items from ``it`` on a background thread through a bounded queue.

    ``readahead`` bounds how many items may sit decoded-but-unconsumed, so a
    fast producer cannot run away from a slow consumer (memory stays
    O(readahead * chunk)).  Exceptions raised by the producer are re-raised
    at the consumer's next pull; abandoning the generator (break / exception
    downstream) unblocks and joins the thread.
    """
    if readahead <= 0:
        yield from it
        return
    q: queue.Queue = queue.Queue(maxsize=readahead)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not _put(item):
                    return
            _put(_DONE)
        except BaseException as exc:  # noqa: BLE001 — re-raised by consumer
            _put(_ProducerError(exc))

    t = threading.Thread(target=produce, daemon=True,
                         name="edge-stream-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                break
            if isinstance(item, _ProducerError):
                raise item.exc
            yield item
    finally:
        stop.set()
        while True:                    # unblock a producer stuck on put()
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


class EdgeStream:
    """One re-windable stream of int32 (chunk, 2) edge arrays."""

    num_edges: int
    num_vertices: int

    def iter_chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def iter_chunks_from(self, chunk_size: int,
                         start_chunk: int = 0) -> Iterator[np.ndarray]:
        """``iter_chunks`` starting at chunk index ``start_chunk`` — how a
        resumed engine pass (repro.robust) re-enters the stream mid-pass,
        and how a retrying reader re-opens at a failed chunk.  The base
        implementation reads and discards the skipped prefix; seekable
        streams (in-memory, memmap) override with an O(1) jump."""
        it = self.iter_chunks(chunk_size)
        for _ in range(start_chunk):
            if next(it, None) is None:
                return
        yield from it

    def iter_chunks_prefetch(self, chunk_size: int,
                             readahead: int = 0) -> Iterator[np.ndarray]:
        """``iter_chunks`` with up to ``readahead`` chunks read ahead on a
        background thread — so host decode/IO of chunk k+1 overlaps whatever
        the consumer does with chunk k.  ``readahead=0`` is a plain
        synchronous ``iter_chunks`` (no thread)."""
        return prefetch(self.iter_chunks(chunk_size), readahead)

    @property
    def simulated_io_seconds(self) -> float:
        return 0.0


@dataclass
class InMemoryEdgeStream(EdgeStream):
    edges: np.ndarray  # (E, 2) int32
    num_vertices: int = 0

    def __post_init__(self):
        self.edges = np.ascontiguousarray(self.edges, dtype=np.int32)
        if self.num_vertices == 0:
            self.num_vertices = int(self.edges.max()) + 1 if len(self.edges) else 0
        self.num_edges = int(self.edges.shape[0])

    def iter_chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        for lo in range(0, self.num_edges, chunk_size):
            yield self.edges[lo:lo + chunk_size]

    def iter_chunks_from(self, chunk_size: int,
                         start_chunk: int = 0) -> Iterator[np.ndarray]:
        for lo in range(start_chunk * chunk_size, self.num_edges,
                        chunk_size):
            yield self.edges[lo:lo + chunk_size]


class MemmapEdgeStream(EdgeStream):
    """Paper-format binary edge list (32-bit vertex id pairs) on disk."""

    def __init__(self, path: str, num_vertices: int | None = None):
        self.path = path
        size = os.path.getsize(path)
        if size % BYTES_PER_EDGE:
            raise ValueError(f"{path}: size {size} is not a multiple of 8")
        self.num_edges = size // BYTES_PER_EDGE
        self._mm = np.memmap(path, dtype=np.uint32, mode="r",
                             shape=(self.num_edges, 2))
        if num_vertices is None:
            num_vertices = 0
            for lo in range(0, self.num_edges, 1 << 20):
                blk = np.asarray(self._mm[lo:lo + (1 << 20)])
                if blk.size:
                    num_vertices = max(num_vertices, int(blk.max()) + 1)
        self.num_vertices = num_vertices

    def iter_chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        for lo in range(0, self.num_edges, chunk_size):
            yield np.asarray(self._mm[lo:lo + chunk_size]).astype(np.int32)

    def iter_chunks_from(self, chunk_size: int,
                         start_chunk: int = 0) -> Iterator[np.ndarray]:
        for lo in range(start_chunk * chunk_size, self.num_edges,
                        chunk_size):
            yield np.asarray(self._mm[lo:lo + chunk_size]).astype(np.int32)

    @staticmethod
    def write(path: str, edges: np.ndarray) -> "MemmapEdgeStream":
        arr = np.ascontiguousarray(edges, dtype=np.uint32)
        arr.tofile(path)
        return MemmapEdgeStream(path, num_vertices=int(edges.max()) + 1)


@dataclass
class ThrottledEdgeStream(EdgeStream):
    inner: EdgeStream
    read_bytes_per_sec: float  # e.g. 938e6 (SSD), 158e6 (HDD)
    _io_seconds: float = field(default=0.0, init=False)

    def __post_init__(self):
        self.num_edges = self.inner.num_edges
        self.num_vertices = self.inner.num_vertices

    def iter_chunks(self, chunk_size: int) -> Iterator[np.ndarray]:
        for chunk in self.inner.iter_chunks(chunk_size):
            self._io_seconds += chunk.shape[0] * BYTES_PER_EDGE / self.read_bytes_per_sec
            yield chunk

    def iter_chunks_from(self, chunk_size: int,
                         start_chunk: int = 0) -> Iterator[np.ndarray]:
        # a resumed pass never re-reads the skipped prefix, so it pays no
        # simulated IO for it
        for chunk in self.inner.iter_chunks_from(chunk_size, start_chunk):
            self._io_seconds += (chunk.shape[0] * BYTES_PER_EDGE
                                 / self.read_bytes_per_sec)
            yield chunk

    @property
    def simulated_io_seconds(self) -> float:
        return self._io_seconds


def compute_degrees(stream: EdgeStream, chunk_size: int = 1 << 20) -> np.ndarray:
    """The paper's upfront degree pass: one linear sweep keeping a counter per
    vertex id (O(|V|) state, O(|E|) time).

    Per-chunk cost is O(chunk), never O(|V|): a chunk whose ids are dense
    relative to its size is bincounted at its own width (max id + 1) and
    added into the matching prefix of the accumulator, while a chunk whose
    max id dwarfs the chunk (shuffled/power-law streams — where a
    ``minlength=|V|``-style bincount would still allocate and sweep ~|V|
    counters per chunk) scatter-adds directly into the accumulator.
    (``engine.compute_degrees_streaming`` is the on-device pipelined
    variant.)
    """
    deg = np.zeros(stream.num_vertices, dtype=np.int64)
    for chunk in stream.iter_chunks(chunk_size):
        flat = chunk.reshape(-1)
        if not flat.size:
            continue
        width = int(flat.max()) + 1
        if width <= 4 * flat.size:
            counts = np.bincount(flat, minlength=width)
            deg[:width] += counts
        else:
            np.add.at(deg, flat, 1)
    return deg.astype(np.int32)
